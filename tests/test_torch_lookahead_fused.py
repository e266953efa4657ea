"""The port's whole-line-search lookahead refit
(``amf_tpu_torch/ops/pmf_kernels.py::pmf_lookahead_fused_t``) against the
JAX package's Pallas kernel (``amf_tpu/ops/pallas_kernels.py``, interpret
mode) and against the port's own proposal loop.

Every lane starts at a fitted base state, so at ``max_steps = 40`` every
lane converges before its budget ends (two after one step, one after 38)
and skips the steps left. Tolerances are those of
tests/test_pallas_kernels.py:176-186, which holds the JAX fused kernel to
its proposal loop: the value to rtol 1e-4, the factors to rtol 1e-3 with
atol 1e-5. The two sides take the same accept/reject decisions, but sum
each evaluation in another order, and over a long trajectory at a growing
lr those float32 differences grow (to ~2e-5 of the value here). bf16 rounds
the same values at the same points on both sides; its factors are held to
one bf16 rounding (rtol 2^-7, atol 1e-3).

The JAX package is imported by a fixture, so the tests marked ``cuda`` also
run on a card host without JAX:
``python -m pytest --noconftest tests/test_torch_lookahead_fused.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from amf_tpu_torch.models import pmf as tpmf
from amf_tpu_torch.ops import pmf_kernels as tpk
from amf_tpu_torch.types import Problem

STEPS = 40
TOL = {False: dict(val=1e-4, rtol=1e-3, atol=1e-5),
       True: dict(val=1e-4, rtol=2 ** -7, atol=1e-3)}


def _problem(rng, n, m):
    rated = rng.random((n, m)) < 0.5
    R = np.where(rated, rng.integers(1, 6, (n, m)), 0).astype(np.float32)
    return R, rated


@pytest.fixture(scope="module")
def case():
    """(Ut0, Vt0, R, rated, di, dj, dv, sigmas, ls_params) as numpy: the
    base factors fitted by the port's ``fit`` on a 13 x 9 problem, d = 3,
    and three lanes, the first on a rated cell."""
    rng = np.random.default_rng(21)
    n, m, d = 13, 9, 3
    R, rated = _problem(rng, n, m)
    cfg = tpmf.PMFConfig(latent_d=d)
    prob = Problem(R_obs=torch.as_tensor(R), rated=torch.as_tensor(rated),
                   queryable=torch.as_tensor(~rated),
                   test=torch.as_tensor(rated))
    st = tpmf.init_state(torch.Generator().manual_seed(0), n, m, cfg, prob)
    st, _ = tpmf.fit(st, prob, cfg)
    on = np.argwhere(rated)[0]
    di = np.asarray([on[0], 5, 12], np.int32)
    dj = np.asarray([on[1], 8, 0], np.int32)
    dv = np.asarray([3.0, 1.0, 5.0], np.float32)
    sig = np.asarray([1.0, 10.0, 10.0], np.float32)
    ls = np.asarray([cfg.learning_rate, cfg.stop_thresh,
                     cfg.min_learning_rate], np.float32)
    return (st.U.T.numpy().copy(), st.V.T.numpy().copy(), R, rated, di, dj,
            dv, sig, ls)


def _torch(arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                               rtol=tol["val"])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w, np.float32),
                                   rtol=tol["rtol"], atol=tol["atol"])


@pytest.fixture(scope="module")
def jpk():
    """The JAX package's pallas_kernels module."""
    pytest.importorskip("jax")
    from amf_tpu.ops import pallas_kernels

    return pallas_kernels


@pytest.fixture
def interpret(jpk, monkeypatch):
    """Run the Pallas kernels in interpret mode on the CPU, as
    tests/test_pallas_kernels.py:109-118 does."""
    orig_call = jpk.pl.pallas_call

    def interp_call(*args, **kw):
        kw["interpret"] = True
        return orig_call(*args, **kw)

    monkeypatch.setattr(jpk.pl, "pallas_call", interp_call)


@pytest.mark.parametrize("bf16", [False, True])
def test_matches_pallas_kernel_interpret(jpk, interpret, case, bf16):
    """Lane padding (L = 3, 2 lanes a block) and row padding (n = 13,
    8-row blocks) on the JAX side; every lane converges early."""
    want = jpk.pmf_lookahead_fused_t.__wrapped__(
        *(jpk.jnp.asarray(a) for a in case), max_steps=STEPS, block_rows=8,
        lanes_per_block=2, bf16=bf16)
    got = tpk.pmf_lookahead_fused_t(*_torch(case), max_steps=STEPS,
                                    block_rows=8, lanes_per_block=2,
                                    bf16=bf16)
    assert got[1].shape == (3, 3, 13) and got[2].shape == (3, 3, 9)
    assert all(x.dtype == torch.float32 for x in got)
    _close([x.numpy() for x in got], want, TOL[bf16])
    *_, evals = tpk.pmf_lookahead_fused_plain(*_torch(case), STEPS, bf16)
    assert 1 < int(evals.max()) < 1 + STEPS  # converged lanes stopped


def test_float32_equals_the_proposal_loop(case):
    """In float32 the fused line search is the lane-blocked proposal loop
    of ``fit_lookahead_batch``."""
    Ut0, Vt0, R, rated, di, dj, dv, sig, ls = _torch(case)
    f, Ut, Vt = tpk.pmf_lookahead_fused_t(
        Ut0, Vt0, R, rated, di, dj, dv, sig, ls, max_steps=STEPS, bf16=False)
    state = tpmf.PMFState(U=Ut0.T, V=Vt0.T, sigma_sq=sig[0],
                          sigma_u_sq=sig[1], sigma_v_sq=sig[2],
                          mean_rating=torch.tensor(0.0))
    prob = Problem(R_obs=R, rated=rated, queryable=~rated, test=rated)
    U, V, f_loop = tpmf.fit_lookahead_batch(
        state, prob, di, dj, dv, tpmf.PMFConfig(latent_d=3),
        max_steps=STEPS, lane_block=2, bf16=False)
    _close([f.numpy(), Ut.mT.numpy(), Vt.mT.numpy()],
           [f_loop.numpy(), U.numpy(), V.numpy()],
           TOL[False])


def test_cpu_wrapper_runs_the_plain_version_and_launches_nothing(case):
    x = _torch(case)
    launches = sum(tpk.pmf_lookahead_fused_cuda.launches.values())
    calls = tpk.pmf_lookahead_fused_plain.calls
    tpk.pmf_lookahead_fused_t(*x, max_steps=3, bf16=False)
    tpk.pmf_lookahead_fused_t(*x, max_steps=3, bf16=True)
    assert tpk.pmf_lookahead_fused_plain.calls == calls + 2
    assert sum(tpk.pmf_lookahead_fused_cuda.launches.values()) == launches


def test_cuda_launcher_refuses_cpu_tensors(case):
    launches = sum(tpk.pmf_lookahead_fused_cuda.launches.values())
    with pytest.raises(ValueError, match="CUDA"):
        tpk.pmf_lookahead_fused_cuda(*_torch(case), 3, False)
    assert sum(tpk.pmf_lookahead_fused_cuda.launches.values()) == launches


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 16, 32])
@pytest.mark.parametrize("bf16", [False, True])
def test_cuda_kernel_matches_plain(cuda_device, bf16, d):
    """Random base factors (no lane converges at once), ragged 13 x 9."""
    rng = np.random.default_rng(d)
    R, rated = _problem(rng, 13, 9)
    x = [0.3 * rng.random((d, 13)).astype(np.float32),
         0.3 * rng.random((d, 9)).astype(np.float32), R, rated,
         np.asarray([0, 5, 12], np.int32), np.asarray([1, 8, 0], np.int32),
         np.asarray([3.0, 1.0, 5.0], np.float32),
         np.asarray([1.0, 10.0, 10.0], np.float32),
         np.asarray([1e-2, 1e-4, 1e-10], np.float32)]
    x = _torch(x, cuda_device)
    launches = sum(tpk.pmf_lookahead_fused_cuda.launches.values())
    calls = tpk.pmf_lookahead_fused_plain.calls
    got = tpk.pmf_lookahead_fused_t(*x, max_steps=STEPS, bf16=bf16)
    assert sum(tpk.pmf_lookahead_fused_cuda.launches.values()) == launches + 1
    assert tpk.pmf_lookahead_fused_plain.calls == calls
    want = tpk.pmf_lookahead_fused_t(*x, max_steps=STEPS, bf16=bf16,
                                     kernel=False)
    tol = TOL[False] if not bf16 else dict(val=1e-3, rtol=2e-2, atol=2e-2)
    _close([g.cpu().numpy() for g in got], [w.cpu().numpy() for w in want],
           tol)


@pytest.mark.cuda
def test_cuda_kernel_refuses_cells_outside_the_problem(cuda_device, case):
    x = _torch(case, cuda_device)
    x[5] = torch.tensor([0, 9, 0], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="outside"):
        tpk.pmf_lookahead_fused_t(*x, max_steps=3)


@pytest.mark.cuda
def test_cuda_refit_paths_launch_the_kernels_and_never_the_plain(cuda_device,
                                                                 case):
    """fit_lookahead_batch on CUDA tensors: the poly-LS path launches B2 and
    B3, the fused path B5; no plain version runs."""
    Ut0, Vt0, R, rated, di, dj, dv, sig, _ = _torch(case, cuda_device)
    state = tpmf.PMFState(U=Ut0.T, V=Vt0.T, sigma_sq=sig[0],
                          sigma_u_sq=sig[1], sigma_v_sq=sig[2],
                          mean_rating=torch.tensor(0.0, device=cuda_device))
    prob = Problem(R_obs=R, rated=rated, queryable=~rated, test=rated)
    counts = (tpk.pmf_value_grad_plain, tpk.pmf_line_coeffs_plain,
              tpk.pmf_lookahead_fused_plain)
    calls = [c.calls for c in counts]
    before = [sum(c.launches.values()) for c in (
        tpk.pmf_value_grad_cuda, tpk.pmf_line_coeffs_cuda,
        tpk.pmf_lookahead_fused_cuda)]
    for kw in (dict(poly_ls=True), dict(fused=True)):
        _, _, f = tpmf.fit_lookahead_batch(
            state, prob, di, dj, dv, tpmf.PMFConfig(latent_d=3),
            max_steps=STEPS, lane_block=2, bf16=True, **kw)
        assert bool(torch.isfinite(f).all())
    after = [sum(c.launches.values()) for c in (
        tpk.pmf_value_grad_cuda, tpk.pmf_line_coeffs_cuda,
        tpk.pmf_lookahead_fused_cuda)]
    assert after[0] > before[0] and after[1] > before[1]
    assert after[2] == before[2] + 1
    assert [c.calls for c in counts] == calls
