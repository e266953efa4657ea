"""The port's lane-batched NUTS (amf_tpu_torch/mcmc/nuts.py) against the
JAX package's, in float64 on the CPU, with JAX's key stream replayed into
the port's noise source (tests/torch_nuts_replay.py).

One transition of six lanes, which stop at different depths, agrees with
six vmapped JAX transitions to 1e-10; the step-size search finds the same
step sizes; the warmup schedule is the same. Port-only runs hold the
sampler to the posterior moments tests/test_nuts.py holds the JAX one to,
chains as lanes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_nuts_replay as rp
import torch_threads  # noqa: F401  (one torch thread a worker)
from amf_tpu.mcmc import nuts as jnuts
from amf_tpu_torch.mcmc import nuts as tnuts

TOL = 1e-10
L, DIM, DEPTH = 6, 4, 5
EPS = np.array([0.05, 0.1, 0.3, 0.6, 1.0, 2.0])


def _close(got, want, tol=TOL):
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1.0))


@pytest.fixture(scope="module")
def gaussian():
    """A correlated Gaussian target, as a JAX and a lane-batched torch
    log density."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(DIM, DIM))
    prec = np.linalg.inv(a @ a.T + 0.5 * np.eye(DIM))
    mu = rng.normal(size=DIM)
    P, M = torch.tensor(prec), torch.tensor(mu)

    def jlogp(q):
        z = q - mu
        return -0.5 * z @ jnp.asarray(prec) @ z

    def tlogp(q):
        z = q - M
        return -0.5 * ((z @ P) * z).sum(-1)

    return jlogp, tlogp, rng


@pytest.fixture(scope="module")
def bpmf_target():
    """The BPMF w0identity posterior of a 6 x 5 problem at d = 2, both
    packages, and a spread of starting points."""
    from amf_tpu import types as jtypes
    from amf_tpu.data import make_fake_data
    from amf_tpu.models import bpmf_hmc as jh
    from amf_tpu_torch import convert
    from amf_tpu_torch.models import bpmf_hmc as th

    rng = np.random.default_rng(11)
    real, known, _ = make_fake_data(num_users=6, num_items=5, rank=2,
                                    data_type=5, mask_type=0.5, rng=rng)
    jprob = jtypes.problem_from_dense(real, known, dtype=jnp.float64)
    tprob = convert.problem(jprob, device="cpu", dtype=torch.float64)
    s = jh.ParamShapes(6, 5, 2)
    jcfg, tcfg = jh.HMCConfig(latent_d=2), th.HMCConfig(latent_d=2)
    mr = jprob.mean_rating()

    def jlogp(q):
        return jh.log_posterior(q, jprob, mr, jcfg, s)

    def tlogp(q):
        return th.log_posterior(q, tprob, tprob.mean_rating(), tcfg,
                                th.ParamShapes(6, 5, 2))

    return jlogp, tlogp, s.dim, rng.normal(size=(L, s.dim)) * 0.3


def test_leapfrog_kinetic_and_turning_match_jax(gaussian):
    jlogp, tlogp, rng = gaussian
    q, p, im = (rng.normal(size=(L, DIM)) for _ in range(3))
    im = np.abs(im) + 0.5
    pe_and_grad = tnuts.potential(tlogp)
    pe, g = pe_and_grad(torch.tensor(q))

    def jstep(q, p, e, i):
        v, gr = jax.value_and_grad(lambda x: -jlogp(x))(q)
        end = jnuts._leapfrog(jnuts._End(q, p, v, gr), e, i,
                              jax.value_and_grad(lambda x: -jlogp(x)))
        return end.q, end.p, end.pe, end.grad

    want = jax.vmap(jstep)(*(jnp.asarray(x) for x in (q, p, EPS, im)))
    end = tnuts._leapfrog(tnuts._End(torch.tensor(q), torch.tensor(p), pe, g),
                          torch.tensor(EPS), torch.tensor(im), pe_and_grad)
    for got, w in zip(end, want):
        _close(got, w)
    _close(tnuts._kinetic(torch.tensor(p), torch.tensor(im)),
           jax.vmap(jnuts._kinetic)(jnp.asarray(p), jnp.asarray(im)))
    p_sum = rng.normal(size=(L, DIM))
    for a, b in ((p, q), (q, p), (p, -p)):
        got = tnuts._is_turning(*(torch.tensor(x) for x in (a, b, p_sum, im)))
        want = jax.vmap(jnuts._is_turning)(
            *(jnp.asarray(x) for x in (a, b, p_sum, im)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_find_reasonable_step_size_matches_jax(gaussian):
    """With JAX's momentum, the same step size on every lane, from step
    sizes that must halve and that must double."""
    jlogp, tlogp, rng = gaussian
    keys = jax.random.split(jax.random.PRNGKey(5), L)
    q = rng.normal(size=(L, DIM))
    im = np.abs(rng.normal(size=(L, DIM))) + 0.5
    for init in (1e-3, 1.0, 8.0):
        want = jax.vmap(lambda k, x, i: jnuts.find_reasonable_step_size(
            k, x, jlogp, i, init))(keys, jnp.asarray(q), jnp.asarray(im))
        got = tnuts.find_reasonable_step_size(
            rp.search_momentum(keys, DIM), torch.tensor(q),
            tnuts.potential(tlogp), torch.tensor(im), init)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("warmup", [0, 4, 19, 40, 149, 150, 400, 1000])
@pytest.mark.parametrize("adapt_mass", [True, False])
def test_warmup_schedule_matches_jax(warmup, adapt_mass):
    for got, want in zip(tnuts._warmup_schedule(warmup, adapt_mass),
                         jnuts._warmup_schedule(warmup, adapt_mass)):
        np.testing.assert_array_equal(got, want)


def _one_transition(jlogp, tlogp, q, dim):
    keys = jax.random.split(jax.random.PRNGKey(1), L)
    im = np.abs(np.random.default_rng(3).normal(size=(L, dim))) + 0.5
    cfg = jnuts.NUTSConfig(max_depth=DEPTH)
    jq, jinfo = jax.vmap(
        lambda k, x, e, i: jnuts.nuts_kernel(k, x, jlogp, e, i, cfg))(
        keys, jnp.asarray(q), jnp.asarray(EPS), jnp.asarray(im))
    tq, tinfo = tnuts.nuts_kernel(
        torch.tensor(q), tnuts.potential(tlogp), torch.tensor(EPS),
        torch.tensor(im), rp.transition_noise(keys, dim, DEPTH),
        tnuts.NUTSConfig(max_depth=DEPTH))
    _close(tq, jq)
    _close(tinfo.logprob, jinfo.logprob)
    _close(tinfo.accept_prob, jinfo.accept_prob)
    np.testing.assert_array_equal(tinfo.num_leaves.numpy(),
                                  np.asarray(jinfo.num_leaves))
    np.testing.assert_array_equal(tinfo.diverging.numpy(),
                                  np.asarray(jinfo.diverging))
    return tinfo


def test_one_transition_matches_jax_gaussian(gaussian):
    jlogp, tlogp, rng = gaussian
    info = _one_transition(jlogp, tlogp, rng.normal(size=(L, DIM)), DIM)
    # the lanes stop at different depths: the masks are exercised
    assert len(set(info.num_leaves.tolist())) >= 3


def test_one_transition_matches_jax_bpmf(bpmf_target):
    jlogp, tlogp, dim, q = bpmf_target
    info = _one_transition(jlogp, tlogp, q, dim)
    assert len(set(info.num_leaves.tolist())) >= 2


def test_generator_noise_is_per_lane_and_windowed():
    """Lane l's draws come from its generator alone, whatever the other
    lanes, across windows."""
    def gens(seeds):
        return [torch.Generator().manual_seed(s) for s in seeds]

    a = tnuts.GeneratorNoise(gens([1, 2, 3]), 5, 4, torch.float64, "cpu",
                             window=3)
    b = tnuts.GeneratorNoise(gens([2]), 5, 4, torch.float64, "cpu", window=3)
    for t in range(8):
        sa, sb = a.step(t), b.step(t)
        for x, y in zip(sa, sb):
            np.testing.assert_array_equal(x[1].numpy(), y[0].numpy())
    assert a.step(2).u_leaf.shape == (3, 2 ** 4 - 1)
    assert a.step(2).go_right.dtype == torch.bool


def _lanes(logp, q0, draws, warmup, seed=0, max_depth=10):
    Lq = q0.shape[0]
    noise = tnuts.GeneratorNoise(
        [torch.Generator().manual_seed(seed + i) for i in range(Lq)],
        q0.shape[1], max_depth, torch.float64, "cpu")
    s, info = tnuts.run_nuts(noise, q0, logp, draws, warmup,
                             tnuts.NUTSConfig(max_depth=max_depth))
    return s.numpy(), info


def test_std_normal_moments():
    s, info = _lanes(lambda q: -0.5 * (q ** 2).sum(-1),
                     torch.zeros(8, 1, dtype=torch.float64), 250, 300)
    s = s.ravel()
    assert abs(s.mean()) < 0.1
    assert s.std() == pytest.approx(1.0, abs=0.1)
    assert float(info.diverging.double().mean()) < 0.01


def test_correlated_gaussian_moments():
    rng = np.random.default_rng(0)
    d = 4
    a = rng.normal(size=(d, d))
    cov = a @ a.T + 0.5 * np.eye(d)
    prec, mu = torch.tensor(np.linalg.inv(cov)), torch.tensor(rng.normal(size=d))

    def logp(q):
        z = q - mu
        return -0.5 * ((z @ prec) * z).sum(-1)

    s, info = _lanes(logp, torch.zeros(8, d, dtype=torch.float64), 250, 200)
    s = s.reshape(-1, d)
    np.testing.assert_allclose(s.mean(0), mu.numpy(), atol=0.25)
    np.testing.assert_allclose(np.cov(s.T), cov, atol=0.5, rtol=0.25)
    assert 0.5 < float(info.accept_prob.mean()) <= 1.0
    assert float(info.diverging.double().mean()) < 0.02


def test_anisotropic_needs_mass_adaptation():
    scales = torch.tensor([0.1, 10.0], dtype=torch.float64)
    s, _ = _lanes(lambda q: -0.5 * ((q / scales) ** 2).sum(-1),
                  torch.zeros(8, 2, dtype=torch.float64), 250, 200,
                  max_depth=8)
    np.testing.assert_allclose(s.reshape(-1, 2).std(0), scales.numpy(),
                               rtol=0.2)


def test_funnel_chain_keeps_moving():
    """The ESJD-grid warmup keeps a chain on Neal's funnel travelling (the
    frozen-chain regression tests/test_nuts.py guards on the JAX side)."""
    def logp(q):
        v, x = q[:, 0], q[:, 1:]
        return (-0.5 * (v / 3.0) ** 2 - 0.5 * (x ** 2).sum(-1) * torch.exp(-v)
                - 0.5 * (q.shape[1] - 1) * v)

    s, _ = _lanes(logp, torch.zeros(1, 8, dtype=torch.float64), 600, 400,
                  max_depth=8)
    s = s[0]
    jumps = np.sum(np.diff(s, axis=0) ** 2, axis=1)
    assert jumps.mean() > 0.5, jumps.mean()
    assert s[:, 0].std() > 1.0, s[:, 0].std()
    assert np.isfinite(s).all()


def test_banana_no_nans():
    def logp(q):
        x, y = q[:, 0], q[:, 1]
        return -0.5 * (x ** 2 / 4 + (y - x ** 2) ** 2)

    q0 = torch.full((4, 2), 0.1, dtype=torch.float64)
    s, info = _lanes(logp, q0, 100, 200)
    assert np.isfinite(s).all()
    assert float(info.num_leaves.double().mean()) > 3


def test_counters_count_lockstep_and_syncs():
    tnuts.Counters.reset()
    _lanes(lambda q: -0.5 * (q ** 2).sum(-1),
           torch.zeros(3, 2, dtype=torch.float64), 10, 10)
    c = tnuts.Counters.read()
    assert c["transitions"] == 20 and c["lane_transitions"] == 60
    # lockstep runs at least the deepest lane's leaves each transition
    assert c["lockstep_leapfrogs"] * 3 >= c["lane_leaves"] > 0
    assert c["syncs"] > 0


@pytest.mark.cuda
def test_graphed_potential_matches_eager_on_the_card(bpmf_target):
    """The potential replayed from its CUDA graph gives the eager pass's
    values and gradients, call after call, on new inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA graph has no CPU mode")
    _, tlogp, dim, q = bpmf_target
    q = torch.tensor(q, device="cuda")
    graphed = tnuts.potential(tlogp)
    eager = tnuts.potential(tlogp, graph=False)
    for scale in (1.0, 0.5, 2.0):
        pe_g, g_g = graphed(q * scale)
        pe_e, g_e = eager(q * scale)
        assert torch.equal(pe_g, pe_e) and torch.equal(g_g, g_e)
