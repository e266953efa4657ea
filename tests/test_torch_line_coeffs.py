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

The kernel walks the index of the rated cells (``rated_index``), which only
the card reads. Its walk is held here on the CPU: a numpy walk of the index
in the kernel's order (``line_coeff_sides``: a walked and a gathered side)
gives the plain version's four sums, in float64 to 1e-12 scaled (the same
products, summed in another order), and the JAX kernel's coefficients.

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


def _ragged_case(seed, n, m, d=4, dtype=np.float32):
    """n x m at 30 % rated with an empty row and an empty column; lane 0
    hypothesises a rated cell, lane 1 an unrated one in the empty row, lane
    2 an unrated one in the empty column, lane 3 the last cell, unrated."""
    rng = np.random.default_rng(seed)
    rated = rng.random((n, m)) < 0.3
    rated[11, :] = False
    rated[:, 17] = False
    rated[3, 4] = True
    rated[n - 1, m - 1] = False
    R = np.where(rated, rng.integers(1, 6, (n, m)), 0).astype(dtype)
    fac = [rng.normal(size=(4, d, k)).astype(dtype) for k in (n, m, n, m)]
    return (*fac, R, rated, np.asarray([3, 11, 20, n - 1], np.int32),
            np.asarray([4, 30, 17, m - 1], np.int32),
            rng.integers(1, 6, 4).astype(dtype),
            np.asarray([0.8, 10.0, 7.0], dtype))


def _walk(ix, Ut, Vt, Gut, Gvt, di, dj, dv):
    """(L, 4) [a2, a11, a12, a22] by the kernel's walk of the index: a
    thread a row of the walked side, the lane's own cell in place of the
    rated value or after the row's rated cells."""
    (X, GX), (Y, GY), ptr, idx, r, cell_w, cell_g = (
        tuple(np.asarray(t) for t in side) if isinstance(side, tuple)
        else np.asarray(side)
        for side in tpk.line_coeff_sides(ix, Ut, Vt, Gut, Gvt, di, dj))
    L, _, rows_w = X.shape
    acc = np.zeros((L, 4), X.dtype)
    for l in range(L):
        for w in range(rows_w):
            cells = [(idx[e], r[e]) for e in range(ptr[w], ptr[w + 1])]
            if w == cell_w[l]:
                hit = [k for k, (g, _) in enumerate(cells) if g == cell_g[l]]
                if hit:
                    cells[hit[0]] = (cell_g[l], dv[l])
                else:
                    cells.append((cell_g[l], dv[l]))
            for g, rv in cells:
                x, gx, y, gy = X[l, :, w], GX[l, :, w], Y[l, :, g], GY[l, :, g]
                err = rv - x @ y
                p1, p2 = gx @ y + x @ gy, gx @ gy
                acc[l] += (err * p2, p1 * p1, p1 * p2, p2 * p2)
    return acc


@pytest.mark.parametrize("shape", [(37, 53), (53, 37)])
def test_index_walk_matches_plain_and_jax_kernel(jpk, interpret, shape):
    """The shorter side is gathered: 37 x 53 walks the columns (CSC),
    53 x 37 the rows (CSR). Float64 against the plain version; the
    coefficients assembled from the walk's float32 sums against the JAX
    kernel."""
    x = _ragged_case(sum(shape), *shape, dtype=np.float64)
    Ut, Vt, Gut, Gvt, R, rated, di, dj, dv, sig = x
    assert rated[di[0], dj[0]] and not rated[di[1:], dj[1:]].any()
    assert not rated[11].any() and not rated[:, 17].any()
    ix = tpk.rated_index(torch.as_tensor(rated), torch.as_tensor(R))
    sides = tpk.line_coeff_sides(ix, Ut, Vt, Gut, Gvt, di, dj)
    assert sides[1][0].shape[2] == min(shape)  # the gathered side
    want = tpk.pmf_line_coeffs_plain(*_torch(x[:9])).numpy()
    got = _walk(ix, *x[:4], di, dj, dv)
    assert np.max(np.abs(got - want) / (1 + np.abs(want))) <= 1e-12

    x32 = tuple(a.astype(np.float32) if a.dtype == np.float64 else a
                for a in x)
    a2, a11, a12, a22 = _walk(ix, *x32[:4], di, dj, x32[8]).T
    uu, vv = (x32[2] ** 2).sum((1, 2)), (x32[3] ** 2).sum((1, 2))
    s, s_u, s_v = x32[9]
    mine = (uu + vv, -(a11 - 2 * a2) / (2 * s) - (uu / s_u + vv / s_v) / 2,
            -a12 / s, -a22 / (2 * s))
    jax_c = jpk.pmf_line_coeffs_t.__wrapped__(
        *(jpk.jnp.asarray(a) for a in x32), block_rows=8, lanes_per_block=2,
        bf16=False)
    _close(mine, jax_c)


def test_index_is_ignored_on_the_cpu_and_checked_on_mismatch():
    x = _torch(_ragged_case(0, 37, 53))
    ix = tpk.rated_index(x[5], x[4])
    a = tpk.pmf_line_coeffs_t(*x, bf16=False, index=ix)
    b = tpk.pmf_line_coeffs_t(*x, bf16=False)
    for p, q in zip(a, b):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
    with pytest.raises(ValueError, match="does not fit"):
        tpk._index_for(ix, x[5].T, x[4].T, torch.float32)
    with pytest.raises(ValueError, match="does not fit"):
        tpk._index_for(ix, x[5], x[4], torch.bfloat16)


def test_poly_refit_hands_the_refits_index_to_the_coefficients(monkeypatch):
    """``fit_lookahead_batch(poly_ls=True)`` gives ``pmf_line_coeffs_t`` the
    index it gives the value+gradient function: on the CPU none is built,
    on a card the one of the refit (the ``cuda`` twin below counts it)."""
    Ut, Vt, _, _, R, rated, di, dj, dv, sig = _torch(_inputs(4))
    state = tpmf.PMFState(U=Ut[0].T.contiguous(), V=Vt[0].T.contiguous(),
                          sigma_sq=sig[0], sigma_u_sq=sig[1],
                          sigma_v_sq=sig[2], mean_rating=torch.tensor(0.0))
    prob = Problem(R_obs=R, rated=rated, queryable=~rated, test=rated)
    seen = []
    inner = tpk.pmf_line_coeffs_t

    def coeffs(*a, **kw):
        seen.append(kw["index"])
        return inner(*a, **kw)

    monkeypatch.setattr(tpk, "pmf_line_coeffs_t", coeffs)
    builds = tpk.rated_index.calls
    tpmf.fit_lookahead_batch(state, prob, di, dj, dv,
                             tpmf.PMFConfig(latent_d=3), max_steps=4,
                             lane_block=2, poly_ls=True)
    assert seen and all(ix is None for ix in seen)
    assert tpk.rated_index.calls == builds


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
    with pytest.raises(ValueError, match="CUDA"):
        tpk.pmf_line_coeffs_cuda(*x[:-1], index=tpk.rated_index(x[5], x[4]))
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
    """d > 32 raises on the card, through the public function too."""
    x = _torch(_inputs(0, d=33), cuda_device)
    calls = tpk.pmf_line_coeffs_plain.calls
    with pytest.raises(ValueError, match="d <= 32"):
        tpk.pmf_line_coeffs_t(*x, bf16=False)
    assert tpk.pmf_line_coeffs_plain.calls == calls


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(37, 53), (53, 37)])
@pytest.mark.parametrize("bf16", [False, True])
def test_cuda_kernel_walks_the_given_index(cuda_device, bf16, shape):
    """Ragged shapes, both walks, lanes on rated and unrated cells; the
    index is built once and handed in, a wrong one is refused, and the sums
    repeat bit for bit."""
    x = _torch(_ragged_case(7, *shape), cuda_device)
    ix = tpk.rated_index(x[5], x[4], bf16=bf16)
    builds = tpk.rated_index.calls
    before = tpk.pmf_line_coeffs_cuda.variants["shared"]
    got = tpk.pmf_line_coeffs_t(*x, bf16=bf16, index=ix)
    again = tpk.pmf_line_coeffs_t(*x, bf16=bf16, index=ix)
    assert tpk.rated_index.calls == builds
    assert tpk.pmf_line_coeffs_cuda.variants["shared"] == before + 2
    want = tpk.pmf_line_coeffs_t(*x, bf16=bf16, kernel=False)
    _close([c.cpu().numpy() for c in got], [c.cpu().numpy() for c in want])
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    with pytest.raises(ValueError, match="does not fit"):
        tpk.pmf_line_coeffs_t(*x, bf16=not bf16, index=ix)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_cuda_kernel_global_memory_variant(cuda_device, bf16):
    """943 rows at d = 32 do not fit a block's shared memory."""
    rng = np.random.default_rng(5)
    L, n, m, d = 3, 943, 1682, 32
    rated = rng.random((n, m)) < 0.01
    x = [*(0.3 * rng.normal(size=(L, d, k)).astype(np.float32)
           for k in (n, m, n, m)),
         np.where(rated, rng.integers(1, 6, (n, m)), 0).astype(np.float32),
         rated, np.asarray([0, 5, n - 1], np.int32),
         np.asarray([1, 8, m - 1], np.int32),
         np.asarray([3.0, 1.0, 5.0], np.float32),
         np.asarray([0.8, 10.0, 7.0], np.float32)]
    x = _torch(x, cuda_device)
    before = tpk.pmf_line_coeffs_cuda.variants["global"]
    got = tpk.pmf_line_coeffs_t(*x, bf16=bf16)
    assert tpk.pmf_line_coeffs_cuda.variants["global"] == before + 1
    want = tpk.pmf_line_coeffs_t(*x, bf16=bf16, kernel=False)
    _close([c.cpu().numpy() for c in got], [c.cpu().numpy() for c in want])


@pytest.mark.cuda
def test_cuda_poly_refit_builds_one_index(cuda_device):
    Ut, Vt, _, _, R, rated, di, dj, dv, sig = _torch(_inputs(4), cuda_device)
    state = tpmf.PMFState(U=Ut[0].T.contiguous(), V=Vt[0].T.contiguous(),
                          sigma_sq=sig[0], sigma_u_sq=sig[1],
                          sigma_v_sq=sig[2],
                          mean_rating=torch.tensor(0.0, device=cuda_device))
    prob = Problem(R_obs=R, rated=rated, queryable=~rated, test=rated)
    builds = tpk.rated_index.calls
    launches = sum(tpk.pmf_line_coeffs_cuda.launches.values())
    tpmf.fit_lookahead_batch(state, prob, di, dj, dv,
                             tpmf.PMFConfig(latent_d=3), max_steps=4,
                             lane_block=2, poly_ls=True)
    assert tpk.rated_index.calls == builds + 1
    assert sum(tpk.pmf_line_coeffs_cuda.launches.values()) > launches
