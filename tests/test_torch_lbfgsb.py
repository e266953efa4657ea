"""The port's lane-batched projected L-BFGS (amf_tpu_torch/ops/lbfgsb.py)
against the JAX package's, in float64 on the CPU.

On the four problems of tests/test_ratingconc.py (an unconstrained
quadratic, an active box, a boxed Rosenbrock, a box-active quadratic
against scipy's L-BFGS-B) x and f agree with JAX's to 1e-8, and the
iteration count exactly where the run ends on pgtol (a run that ends on a
failed search, at the limit of float64, may end some iterations apart). A
batch of lanes gives what each lane gives alone, and iterations a lane
runs after it has stopped leave it bit for bit as it was.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a worker)
from amf_tpu.ops.lbfgsb import lbfgsb as jlbfgsb
from amf_tpu_torch.ops import lbfgsb as tl

TOL = 1e-8


def _quadratic(seed, d):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(d, d))
    return a @ a.T + d * np.eye(d), rng


def _scipy_box():
    Q, rng = _quadratic(2, 15)
    return Q, rng.normal(size=15) * 3


def _problems():
    """name -> (numpy f, torch (f, grad) over lanes, x0, lower, upper,
    kwargs), the four problems of tests/test_ratingconc.py."""
    Q, rng = _quadratic(0, 20)
    b = rng.normal(size=20)
    t = np.random.default_rng(1).normal(size=30) * 2
    Q2, b2 = _scipy_box()

    def quad(Q, b):
        Qt, bt = torch.tensor(Q), torch.tensor(b)
        return (lambda x: 0.5 * x @ Q @ x - b @ x,
                lambda x: (0.5 * ((x @ Qt) * x).sum(-1) - x @ bt,
                           x @ Qt - bt))

    def rosen_j(x):
        return jnp.sum(100 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)

    def rosen_t(x):
        return torch.sum(100 * (x[..., 1:] - x[..., :-1] ** 2) ** 2
                         + (1 - x[..., :-1]) ** 2, -1)

    tt = torch.tensor(t)
    return {
        "quadratic": (*quad(Q, b), np.zeros(20), -1e10, 1e10,
                      dict(pgtol=1e-9)),
        "active_box": (lambda x: jnp.sum((x - t) ** 2),
                       lambda x: (((x - tt) ** 2).sum(-1), 2 * (x - tt)),
                       np.full(30, 0.5), 0.0, 1.0, dict(pgtol=1e-10)),
        "rosenbrock_box": (rosen_j, rosen_t, np.zeros(6), -2.0, 2.0,
                           dict(max_iters=2000, pgtol=1e-10)),
        "scipy_box": (*quad(Q2, b2), np.zeros(15), 0.0, 1.0,
                      dict(max_iters=1000, pgtol=1e-10)),
    }


PROBLEMS = _problems()


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_matches_jax(name):
    f_np, f_t, x0, lo, hi, kw = PROBLEMS[name]
    want = jlbfgsb(jax.value_and_grad(f_np), jnp.asarray(x0), lo, hi, **kw)
    if name == "rosenbrock_box":  # the value only: autograd's gradient
        got = tl.lbfgsb(f_t, torch.tensor(x0)[None], lo, hi,
                        value_and_grad=False, **kw)
    else:
        got = tl.lbfgsb(f_t, torch.tensor(x0)[None], lo, hi, **kw)
    np.testing.assert_allclose(got.x[0].numpy(), np.asarray(want.x),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(got.f[0]), float(want.f), rtol=TOL)
    if float(want.pg_norm) < kw["pgtol"]:
        assert int(got.n_iters[0]) == int(want.n_iters)
    if name == "scipy_box":
        from scipy import optimize

        Q, b = _scipy_box()
        sp = optimize.minimize(
            lambda x: (0.5 * x @ Q @ x - b @ x, Q @ x - b), np.zeros(15),
            jac=True, method="L-BFGS-B", bounds=[(0, 1)] * 15,
            options={"ftol": 1e-15, "gtol": 1e-12})
        np.testing.assert_allclose(got.x[0].numpy(), sp.x, atol=1e-5)


def _lane_problem(L=5, d=12, seed=3):
    """L box-constrained quadratics, one a lane, of different conditioning
    so that the lanes stop at different iterations."""
    rng = np.random.default_rng(seed)
    Qs = []
    for lane in range(L):
        a = rng.normal(size=(d, d))
        Qs.append(a @ a.T + (0.05 + lane) * np.eye(d))
    Q = torch.tensor(np.stack(Qs))
    b = torch.tensor(rng.normal(size=(L, d)) * 3)

    def fun(x):
        Qx = (Q[: x.shape[0]] @ x[..., None])[..., 0]
        return 0.5 * (Qx * x).sum(-1) - (b[: x.shape[0]] * x).sum(-1), \
            Qx - b[: x.shape[0]]

    return fun, Q, b, torch.tensor(rng.normal(size=(L, d)))


def test_a_lane_batch_equals_lanes_one_at_a_time():
    fun, Q, b, x0 = _lane_problem()
    kw = dict(max_iters=300, pgtol=1e-9)
    batch = tl.lbfgsb(fun, x0, -0.5, 0.5, **kw)
    assert len(set(batch.n_iters.tolist())) > 1  # lanes stop apart
    for lane in range(x0.shape[0]):
        def one(x, lane=lane):
            Qx = (Q[lane] @ x[..., None])[..., 0]
            return 0.5 * (Qx * x).sum(-1) - (b[lane] * x).sum(-1), Qx - b[lane]

        alone = tl.lbfgsb(one, x0[lane:lane + 1], -0.5, 0.5, **kw)
        np.testing.assert_allclose(batch.x[lane].numpy(), alone.x[0].numpy(),
                                   rtol=1e-12, atol=1e-14)
        assert int(batch.n_iters[lane]) == int(alone.n_iters[0])


def test_extra_iterations_leave_stopped_lanes_bit_for_bit(monkeypatch):
    """With the host's check after every iteration the loop ends when the
    last lane stops; checking only every 64 iterations runs the stopped
    lanes through many more masked iterations, which must change none of
    their outputs."""
    fun, _, _, x0 = _lane_problem()
    kw = dict(max_iters=300, pgtol=1e-9)
    monkeypatch.setattr(tl, "SYNC_ITERS", 1)
    tl.Counters.reset()
    tight = tl.lbfgsb(fun, x0, -0.5, 0.5, **kw)
    tight_iters = tl.Counters.read()["iterations"]
    monkeypatch.setattr(tl, "SYNC_ITERS", 64)
    tl.Counters.reset()
    loose = tl.lbfgsb(fun, x0, -0.5, 0.5, **kw)
    counts = tl.Counters.read()
    assert counts["iterations"] > tight_iters == int(tight.n_iters.max())
    assert counts["lane_iterations"] == int(loose.n_iters.sum())
    for a, b_ in zip(tight, loose):
        assert torch.equal(a, b_)
