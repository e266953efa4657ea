"""The port's per-lane PMF value+gradient (amf_tpu_torch/ops/pmf_kernels.py)
against the JAX package's (amf_tpu/ops/pallas_kernels.py).

Tolerances are those of tests/test_pallas_kernels.py:78-82 (float32): the
value to rtol 1e-5, the gradients to rtol 1e-4 with atol 1e-5; the sums run
in different orders. The bf16 path is held to the JAX bf16 kernel to one
bf16 rounding of the gradients (rtol 2e-2, atol 2e-2): a residual or an
output that lies near a rounding boundary may round the other way.

The kernel walks an index of the rated cells (``rated_index``) that only
the card reads. Its contract is held here on the CPU: it equals scipy's CSR
and CSC of the same mask, and a numpy walk of it in the kernel's order gives
the plain version's and the JAX reference's value and gradients.

The JAX package is imported by a fixture, so the tests marked ``cuda`` also
run on a card host without JAX:
``python -m pytest --noconftest tests/test_torch_pmf_kernels.py -m cuda``.
"""

import numpy as np
import pytest
import scipy.sparse
import torch

from amf_tpu_torch.ops import pmf_kernels as tpk

VAL = dict(rtol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
GRAD_BF16 = dict(rtol=2e-2, atol=2e-2)


def _inputs(seed, L, n, m, d):
    """(U, V, R, rated, di, dj, dv, sigmas) as numpy, f32 / bool / int32."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(L, n, d)).astype(np.float32),
            rng.normal(size=(L, m, d)).astype(np.float32),
            rng.integers(1, 6, size=(n, m)).astype(np.float32),
            rng.random((n, m)) < 0.4,
            rng.integers(0, n, L).astype(np.int32),
            rng.integers(0, m, L).astype(np.int32),
            rng.integers(1, 6, L).astype(np.float32),
            np.asarray([0.8, 10.0, 7.0], np.float32))


def _torch(arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


def _t(x):
    """(L, a, b) -> (L, b, a), numpy or torch."""
    return np.swapaxes(x, 1, 2) if isinstance(x, np.ndarray) else x.mT


def _jax(jpk, arrays):
    return [jpk.jnp.asarray(a) for a in arrays]


def _close(got, want, grad_tol=GRAD, val_tol=VAL):
    np.testing.assert_allclose(got[0].float().numpy(), np.asarray(want[0]),
                               **val_tol)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), **grad_tol)


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


@pytest.mark.parametrize("shape",
                         [(3, 12, 9, 4), (5, 13, 8, 4), (2, 7, 11, 1)])
def test_plain_matches_jax_reference(jpk, shape):
    x = _inputs(sum(shape), *shape)
    want = jpk.pmf_batched_value_grad_reference(*_jax(jpk, x))
    _close(tpk.pmf_batched_value_grad_reference(*_torch(x)), want)


@pytest.mark.parametrize("n", [16, 13])
def test_wrapper_matches_pallas_kernel_interpret(jpk, interpret, n):
    """(L, rows, d) layout; n = 13 is not a multiple of the 8-row block."""
    x = _inputs(n, 4, n, 8, 4)
    want = jpk.pmf_batched_value_grad.__wrapped__(*_jax(jpk, x),
                                                  block_rows=8)
    _close(tpk.pmf_batched_value_grad(*_torch(x), block_rows=8), want)


def test_t_wrapper_matches_lane_blocked_kernel_interpret(jpk, interpret):
    """(L, d, rows) layout with lane padding (L = 5, 2 lanes a block) and
    row padding (n = 13, 8-row blocks)."""
    x = _inputs(7, 5, 13, 8, 4)
    xt = (_t(x[0]), _t(x[1])) + x[2:]
    want = jpk.pmf_batched_value_grad_t.__wrapped__(
        *_jax(jpk, xt), block_rows=8, lanes_per_block=2, bf16=False)
    got = tpk.pmf_batched_value_grad_t(*_torch(xt), block_rows=8,
                                       lanes_per_block=2, bf16=False)
    assert got[1].shape == (5, 4, 13) and got[1].dtype == torch.float32
    _close(got, want)


def test_t_wrapper_bf16_matches_lane_blocked_kernel_interpret(jpk, interpret):
    """bf16: R, mask and factors in bf16, the residual rounded to bf16 before
    the contractions, bf16 gradients, float32 sums and value."""
    x = _inputs(8, 4, 13, 8, 4)
    xt = (_t(x[0]), _t(x[1])) + x[2:]
    want = jpk.pmf_batched_value_grad_t.__wrapped__(
        *_jax(jpk, xt), block_rows=8, lanes_per_block=2, bf16=True)
    got = tpk.pmf_batched_value_grad_t(*_torch(xt), block_rows=8,
                                       lanes_per_block=2, bf16=True)
    assert got[1].dtype == got[2].dtype == torch.bfloat16
    assert got[0].dtype == torch.float32
    _close(got, want, grad_tol=GRAD_BF16)


def test_wide_d_on_the_cpu_matches_jax_reference(jpk):
    """d = 40 is above the CUDA kernels' 32; the JAX kernels take any d."""
    x = _inputs(40, 2, 7, 6, 40)
    want = jpk.pmf_batched_value_grad_reference(*_jax(jpk, x))
    _close(tpk.pmf_batched_value_grad(*_torch(x)), want)


def test_dispatch_sends_only_cpu_tensors_to_the_plain_version():
    """The rule, held without a card: a CUDA tensor is the kernel's at any
    width (whose launcher refuses d > 32), the plain version's only with
    ``kernel=False``; a CPU tensor is always the plain version's."""
    import types

    on_card = types.SimpleNamespace(device=torch.device("cuda"))
    on_cpu = types.SimpleNamespace(device=torch.device("cpu"))
    on_meta = types.SimpleNamespace(device=torch.device("meta"))
    assert tpk._use_kernel(on_card, True, "pmf_value_grad")
    assert not tpk._use_kernel(on_card, False, "pmf_value_grad")
    assert not tpk._use_kernel(on_cpu, True, "pmf_value_grad")
    with pytest.raises(ValueError, match="pmf_line_coeffs runs on cpu or "
                       "cuda, not meta"):
        tpk._use_kernel(on_meta, True, "pmf_line_coeffs")
    assert tpk.MAX_D == 32


def test_cpu_wrappers_run_the_plain_version_and_launch_nothing():
    x = _torch(_inputs(1, 3, 6, 5, 2))
    launches = sum(tpk.pmf_value_grad_cuda.launches.values())
    calls = tpk.pmf_value_grad_plain.calls
    a = tpk.pmf_batched_value_grad(*x)
    b = tpk.pmf_batched_value_grad_t(_t(x[0]), _t(x[1]), *x[2:], bf16=False)
    assert tpk.pmf_value_grad_plain.calls == calls + 2
    assert sum(tpk.pmf_value_grad_cuda.launches.values()) == launches
    for p, q in zip(a, (b[0], _t(b[1]), _t(b[2]))):
        torch.testing.assert_close(p, q, rtol=0, atol=0)


def test_cuda_launcher_refuses_cpu_tensors():
    x = _torch(_inputs(2, 2, 4, 3, 2))
    launches = sum(tpk.pmf_value_grad_cuda.launches.values())
    with pytest.raises(ValueError, match="CUDA"):
        tpk.pmf_value_grad_cuda(*x, transposed=False, round_resid=False,
                                out_dtype=torch.float32)
    assert sum(tpk.pmf_value_grad_cuda.launches.values()) == launches


# ---------------------------------------------------------------------------
# the rated-cell index


def _ragged_case(seed):
    """37 x 53 at 30 % rated with an empty row and an empty column; lane 0
    hypothesises a rated cell, lane 1 an unrated one in the empty row, lane
    2 an unrated one in the empty column."""
    x = list(_inputs(seed, 4, 37, 53, 5))
    rng = np.random.default_rng(1000 + seed)
    rated = rng.random((37, 53)) < 0.3
    rated[11, :] = False
    rated[:, 17] = False
    rated[3, 4] = True
    x[3] = rated
    x[4] = np.asarray([3, 11, 20, 36], np.int32)
    x[5] = np.asarray([4, 30, 17, 52], np.int32)
    return tuple(x)


def _walk(ix, U, V, di, dj, dv, sig):
    """sqerr, Gu, Gv of every lane by the kernel's walk of the index, in
    float32: a row pass over CSR that keeps each cell's residual in CSR
    order, then a column pass over CSC that fetches it through csc_pos."""
    f = np.float32
    row_ptr, col_idx, r_row, col_ptr, row_idx, _, csc_pos = (
        t.numpy() for t in ix[:7])
    nnz = ix.nnz
    L, n, d = U.shape
    m = V.shape[1]
    sq = np.zeros(L, f)
    Gu, Gv = np.zeros_like(U), np.zeros_like(V)
    for l in range(L):
        E = np.zeros(nnz + 1, f)
        for i in range(n):
            mine, found = i == di[l], False
            cells = [(e, col_idx[e], r_row[e])
                     for e in range(row_ptr[i], row_ptr[i + 1])]
            for e, j, r in list(cells):
                if mine and j == dj[l]:
                    found = True
                    cells[e - row_ptr[i]] = (e, j, dv[l])
            if mine and not found:
                cells.append((nnz, dj[l], dv[l]))
            for e, j, r in cells:
                E[e] = f(r) - U[l, i] @ V[l, j]
                sq[l] += E[e] * E[e]
                Gu[l, i] += E[e] / sig[0] * V[l, j]
        for j in range(m):
            mine, found = j == dj[l], False
            for e in range(col_ptr[j], col_ptr[j + 1]):
                found |= mine and row_idx[e] == di[l]
                Gv[l, j] += E[csc_pos[e]] / sig[0] * U[l, row_idx[e]]
            if mine and not found:
                Gv[l, j] += E[nnz] / sig[0] * U[l, di[l]]
    return sq, Gu - U / sig[1], Gv - V / sig[2]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rated_index_equals_scipy_csr_and_csc(seed):
    _, _, R, rated = _ragged_case(seed)[:4]
    ix = tpk.rated_index(torch.as_tensor(rated), torch.as_tensor(R))
    vals = np.where(rated, R, 0.0)
    csr = scipy.sparse.csr_matrix(vals)
    csc = scipy.sparse.csc_matrix(vals)
    for got, want in ((ix.row_ptr, csr.indptr), (ix.col_idx, csr.indices),
                      (ix.col_ptr, csc.indptr), (ix.row_idx, csc.indices)):
        assert got.dtype == torch.int32 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ix.r_row.numpy(), csr.data)
    np.testing.assert_array_equal(ix.r_col.numpy(), csc.data)
    assert ix.nnz == csr.nnz == int(rated.sum()) and ix.shape == (37, 53)
    assert ix.csc_pos.dtype == torch.int32
    # the CSC entry and the CSR entry it points at are the same cell
    pos = ix.csc_pos.numpy()
    rows_of_csr = np.repeat(np.arange(37), np.diff(csr.indptr))
    cols_of_csc = np.repeat(np.arange(53), np.diff(csc.indptr))
    np.testing.assert_array_equal(rows_of_csr[pos], csc.indices)
    np.testing.assert_array_equal(csr.indices[pos], cols_of_csc)
    assert sorted(pos) == list(range(csr.nnz))
    assert tpk.rated_index(torch.as_tensor(rated), torch.as_tensor(R),
                           bf16=True).r_row.dtype == torch.bfloat16


@pytest.mark.parametrize("seed", [0, 1])
def test_rated_index_rebuilds_the_rated_cells(seed):
    """The index holds the problem's rated cells and no other, by row and
    by column, with R's values; ``_index_for`` hands a fitting index back
    and refuses one of another problem or dtype."""
    _, _, R, rated = _ragged_case(seed)[:4]
    rt, Rt = torch.as_tensor(rated), torch.as_tensor(R)
    ix = tpk.rated_index(rt, Rt)
    row_ptr, col_idx, r_row, col_ptr, row_idx, r_col, pos = (
        t.numpy() for t in ix[:7])
    assert ix.shape == (37, 53) and ix.nnz == int(rated.sum())
    by_row = np.zeros((37, 53), np.float32)
    for i in range(37):
        e = slice(row_ptr[i], row_ptr[i + 1])
        assert (np.diff(col_idx[e]) > 0).all()
        by_row[i, col_idx[e]] = r_row[e]
    by_col = np.zeros((37, 53), np.float32)
    for j in range(53):
        e = slice(col_ptr[j], col_ptr[j + 1])
        assert (np.diff(row_idx[e]) > 0).all()
        by_col[row_idx[e], j] = r_col[e]
        np.testing.assert_array_equal(r_row[pos[e]], r_col[e])
    np.testing.assert_array_equal(by_row, np.where(rated, R, 0))
    np.testing.assert_array_equal(by_col, by_row)
    assert tpk._index_for(ix, rt, Rt, torch.float32) is ix
    with pytest.raises(ValueError, match="does not fit"):
        tpk._index_for(ix, rt, Rt, torch.bfloat16)
    with pytest.raises(ValueError, match="does not fit"):
        tpk._index_for(ix, rt[:, :-1], Rt[:, :-1], torch.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_index_walk_matches_plain_and_jax_reference(jpk, seed):
    x = _ragged_case(seed)
    U, V, R, rated, di, dj, dv, sig = x
    assert rated[di[0], dj[0]] and not rated[di[1:], dj[1:]].any()
    assert not rated[11].any() and not rated[:, 17].any()
    ix = tpk.rated_index(torch.as_tensor(rated), torch.as_tensor(R))
    sq, Gu, Gv = _walk(ix, U, V, di, dj, dv, sig)
    val = (sq / (2 * sig[0]) + (U * U).sum((1, 2)) / (2 * sig[1])
           + (V * V).sum((1, 2)) / (2 * sig[2]))
    plain = tpk.pmf_batched_value_grad(*_torch(x), kernel=False)
    jax_ref = jpk.pmf_batched_value_grad_reference(*_jax(jpk, x))
    for want in (plain, jax_ref):
        want = [np.asarray(w) for w in want]
        np.testing.assert_allclose(val, want[0], rtol=1e-5)
        for g, w in zip((Gu, Gv), want[1:]):
            assert np.max(np.abs(g - w) / (1 + np.abs(w))) <= 1e-4


def test_index_is_ignored_on_the_cpu_and_checked_on_mismatch():
    x = _torch(_ragged_case(0))
    ix = tpk.rated_index(x[3], x[2])
    a = tpk.pmf_batched_value_grad(*x, index=ix)
    b = tpk.pmf_batched_value_grad(*x)
    for p, q in zip(a, b):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
    with pytest.raises(ValueError, match="does not fit"):
        tpk._index_for(ix, x[3][:5], x[2][:5], torch.float32)
    with pytest.raises(ValueError, match="does not fit"):
        tpk._index_for(ix, x[3], x[2], torch.bfloat16)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _kernel_vs_plain(fn, args, **kw):
    launches = sum(tpk.pmf_value_grad_cuda.launches.values())
    got = fn(*args, **kw)
    want = fn(*args, kernel=False, **kw)
    assert sum(tpk.pmf_value_grad_cuda.launches.values()) == launches + 1
    return [g.cpu() for g in got], [w.cpu() for w in want]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 5, 10, 32])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("layout", ["rows", "t"])
def test_cuda_kernel_matches_plain(cuda_device, layout, bf16, d):
    x = _torch(_inputs(d, 6, 37, 53, d), cuda_device)
    if layout == "t":
        got, want = _kernel_vs_plain(tpk.pmf_batched_value_grad_t,
                                     [_t(x[0]), _t(x[1]), *x[2:]], bf16=bf16)
    else:
        got, want = _kernel_vs_plain(tpk.pmf_batched_value_grad, x, bf16=bf16)
    tol = GRAD_BF16 if bf16 and layout == "t" else GRAD
    _close(got, [w.float().numpy() for w in want], grad_tol=tol)


@pytest.mark.cuda
def test_cuda_kernel_refuses_large_d(cuda_device):
    """d > 32 raises on the card, through the public function too."""
    x = _torch(_inputs(0, 2, 5, 4, 33), cuda_device)
    calls = tpk.pmf_value_grad_plain.calls
    with pytest.raises(ValueError, match="d <= 32"):
        tpk.pmf_batched_value_grad(*x)
    assert tpk.pmf_value_grad_plain.calls == calls


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("layout", ["rows", "t"])
def test_cuda_kernel_matches_plain_on_ragged_index(cuda_device, layout, bf16):
    """An empty row, an empty column, rated and unrated lane cells; the
    index is built once and handed in; the value repeats bit for bit."""
    x = _torch(_ragged_case(3), cuda_device)
    ix = tpk.rated_index(x[3], x[2], bf16=bf16)
    if layout == "t":
        fn, args = tpk.pmf_batched_value_grad_t, [_t(x[0]).contiguous(),
                                                  _t(x[1]).contiguous(), *x[2:]]
    else:
        fn, args = tpk.pmf_batched_value_grad, x
    got, want = _kernel_vs_plain(fn, args, bf16=bf16, index=ix)
    tol = GRAD_BF16 if bf16 and layout == "t" else GRAD
    _close(got, [w.float().numpy() for w in want], grad_tol=tol)
    again = fn(*args, bf16=bf16, index=ix)
    assert torch.equal(again[0].cpu(), got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("layout", ["rows", "t"])
def test_cuda_kernel_global_memory_variant(cuda_device, layout, bf16):
    """943 x 1682 at d = 32 does not fit a block's shared memory."""
    rng = np.random.default_rng(5)
    L, n, m, d = 3, 943, 1682, 32
    x = [0.3 * rng.random((L, n, d)).astype(np.float32),
         0.3 * rng.random((L, m, d)).astype(np.float32),
         rng.integers(1, 6, size=(n, m)).astype(np.float32),
         rng.random((n, m)) < 0.01,
         np.asarray([0, 5, n - 1], np.int32), np.asarray([1, 8, m - 1], np.int32),
         np.asarray([3.0, 1.0, 5.0], np.float32),
         np.asarray([0.8, 10.0, 7.0], np.float32)]
    x = _torch(x, cuda_device)
    before = tpk.pmf_value_grad_cuda.variants["global"]
    if layout == "t":
        got, want = _kernel_vs_plain(
            tpk.pmf_batched_value_grad_t,
            [_t(x[0]).contiguous(), _t(x[1]).contiguous(), *x[2:]], bf16=bf16)
    else:
        got, want = _kernel_vs_plain(tpk.pmf_batched_value_grad, x, bf16=bf16)
    assert tpk.pmf_value_grad_cuda.variants["global"] == before + 1
    tol = GRAD_BF16 if bf16 and layout == "t" else GRAD
    _close(got, [w.float().numpy() for w in want], grad_tol=tol)
