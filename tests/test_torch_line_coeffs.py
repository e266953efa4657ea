"""The port's improvement-quartic coefficients of the poly line search
(``amf_tpu_torch/ops/pmf_kernels.py::pmf_line_coeffs_t``) against the JAX
package's Pallas kernel (``amf_tpu/ops/pallas_kernels.py``, interpret mode)
and against the port's own per-lane quartic ``models/pmf._delta_poly``.

Tolerances: c1..c4 to rtol 1e-4 with atol 1e-4 times the largest |c| of
the lane set: the sums run over the same products in other orders, and c2
is a difference of two such sums. With bf16 both sides round R and the
factors to bf16 in the same way and sum in float32, so the same bound holds.
Against ``_delta_poly`` (float32, unrounded) the tolerance is that of
tests/test_pallas_kernels.py:283-289: rtol 1e-4, atol 1e-6 on c3 and c4.

The JAX package is imported by a fixture, so the tests marked ``cuda`` also
run on a card host without JAX:
``python -m pytest --noconftest tests/test_torch_line_coeffs.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from amf_tpu_torch.models import pmf as tpmf
from amf_tpu_torch.ops import pmf_kernels as tpk
from amf_tpu_torch.types import Problem

RTOL, ATOL_SCALE = 1e-4, 1e-4


def _inputs(seed, L=3, n=13, m=9, d=3):
    """(Ut, Vt, Gut, Gvt, R, rated, di, dj, dv, sigmas) as numpy. Lane 0's
    cell is rated in the base, lane 1's is not."""
    rng = np.random.default_rng(seed)
    rated = rng.random((n, m)) < 0.5
    di = rng.integers(0, n, L).astype(np.int32)
    dj = rng.integers(0, m, L).astype(np.int32)
    on, off = np.argwhere(rated), np.argwhere(~rated)
    di[0], dj[0] = on[rng.integers(len(on))]
    di[1], dj[1] = off[rng.integers(len(off))]
    return (rng.normal(size=(L, d, n)).astype(np.float32),
            rng.normal(size=(L, d, m)).astype(np.float32),
            rng.normal(size=(L, d, n)).astype(np.float32),
            rng.normal(size=(L, d, m)).astype(np.float32),
            np.where(rated, rng.integers(1, 6, (n, m)), 0).astype(np.float32),
            rated, di, dj,
            rng.integers(1, 6, L).astype(np.float32),
            np.asarray([0.8, 10.0, 7.0], np.float32))


def _torch(arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


def _close(got, want):
    got = np.stack([np.asarray(c, np.float64) for c in got])
    want = np.stack([np.asarray(c, np.float64) for c in want])
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_SCALE * np.abs(want).max())


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
def test_matches_pallas_kernel_interpret(jpk, interpret, bf16):
    """Lane padding (L = 3, 2 lanes a block) and row padding (n = 13,
    8-row blocks) on the JAX side."""
    x = _inputs(11 + bf16)
    want = jpk.pmf_line_coeffs_t.__wrapped__(
        *(jpk.jnp.asarray(a) for a in x), block_rows=8, lanes_per_block=2,
        bf16=bf16)
    got = tpk.pmf_line_coeffs_t(*_torch(x), block_rows=8, lanes_per_block=2,
                                bf16=bf16)
    assert all(c.shape == (3,) and c.dtype == torch.float32 for c in got)
    _close([c.numpy() for c in got], want)


def test_matches_delta_poly_per_lane():
    """Each lane's coefficients are the quartic of its own problem (the base
    plus its cell), as ``_delta_poly`` builds it from whole matrices."""
    Ut, Vt, Gut, Gvt, R, rated, di, dj, dv, sig = _torch(_inputs(5))
    got = tpk.pmf_line_coeffs_t(Ut, Vt, Gut, Gvt, R, rated, di, dj, dv, sig,
                                bf16=False)
    state = tpmf.PMFState(U=None, V=None, sigma_sq=sig[0], sigma_u_sq=sig[1],
                          sigma_v_sq=sig[2], mean_rating=torch.tensor(0.0))
    prob = Problem(R_obs=R, rated=rated, queryable=~rated, test=rated)
    cfg = tpmf.PMFConfig(latent_d=3)
    for lane in range(3):
        lane_prob = prob.add_rating(int(di[lane]), int(dj[lane]),
                                    float(dv[lane]))
        want = tpmf._delta_poly(state, lane_prob, cfg,
                                (Ut[lane].T, Vt[lane].T),
                                (Gut[lane].T, Gvt[lane].T))
        for q, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(float(g[lane]), float(w), rtol=1e-4,
                                       atol=1e-6 if q >= 2 else 0)


def test_cpu_wrapper_runs_the_plain_version_and_launches_nothing():
    x = _torch(_inputs(2))
    launches = sum(tpk.pmf_line_coeffs_cuda.launches.values())
    calls = tpk.pmf_line_coeffs_plain.calls
    tpk.pmf_line_coeffs_t(*x, bf16=False)
    tpk.pmf_line_coeffs_t(*x, bf16=True)
    assert tpk.pmf_line_coeffs_plain.calls == calls + 2
    assert sum(tpk.pmf_line_coeffs_cuda.launches.values()) == launches


def test_cuda_launcher_refuses_cpu_tensors():
    x = _torch(_inputs(3))
    launches = sum(tpk.pmf_line_coeffs_cuda.launches.values())
    with pytest.raises(ValueError, match="CUDA"):
        tpk.pmf_line_coeffs_cuda(*x[:-1])
    assert sum(tpk.pmf_line_coeffs_cuda.launches.values()) == launches


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 16, 32])
@pytest.mark.parametrize("bf16", [False, True])
def test_cuda_kernel_matches_plain(cuda_device, bf16, d):
    x = _torch(_inputs(d, d=d), cuda_device)
    launches = sum(tpk.pmf_line_coeffs_cuda.launches.values())
    calls = tpk.pmf_line_coeffs_plain.calls
    got = tpk.pmf_line_coeffs_t(*x, bf16=bf16)
    assert sum(tpk.pmf_line_coeffs_cuda.launches.values()) == launches + 1
    assert tpk.pmf_line_coeffs_plain.calls == calls
    want = tpk.pmf_line_coeffs_t(*x, bf16=bf16, kernel=False)
    _close([c.cpu().numpy() for c in got], [c.cpu().numpy() for c in want])


@pytest.mark.cuda
def test_cuda_kernel_refuses_large_d(cuda_device):
    x = _torch(_inputs(0, d=33), cuda_device)
    with pytest.raises(ValueError, match="d <= 32"):
        tpk.pmf_line_coeffs_t(*x)
