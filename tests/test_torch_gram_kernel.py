"""The Gibbs row draws' masked Gram from the rated-cell index
(amf_tpu_torch/ops/gram_kernel.py) against the dense product of the mask
(``gram_kernel.dense_gram``), and the rule that picks between them.

The two paths sum the same products in other orders: the plain index
version agrees with the dense product to 1e-5 (relative Frobenius) in
float32 and 1e-12 in float64, as the CUDA kernel does with the plain
version. The index path against the JAX package's draws is in
``tests/test_torch_bpmf_gibbs.py``; here the chain's span says which path
it took.

Nothing here imports JAX, so the tests marked ``cuda`` run on a card host
without it: ``python -m pytest --noconftest tests/test_torch_gram_kernel.py``.
"""

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a worker)
from amf_tpu_torch.models import bpmf_gibbs as tbg
from amf_tpu_torch.ops import gram_kernel as tgk
from amf_tpu_torch.ops import pmf_kernels as tpk

RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _rel(got, want):
    return float((got - want).norm() / want.norm().clamp(min=1e-300))


def _problem(seed, n, m, density, dtype, empty=False, full_row=0,
             full_col=0, device="cpu"):
    """A rated mask of ``density`` with ratings 1..5; ``full_row`` /
    ``full_col`` rate that many cells of row 0 and column 0; ``empty`` then
    clears row 1 and column 1."""
    rng = np.random.default_rng(seed)
    rated = rng.random((n, m)) < density
    rated[0, :full_row] = True
    rated[:full_col, 0] = True
    if empty:
        rated[1] = False
        rated[:, 1] = False
    R = rng.integers(1, 6, (n, m)).astype(float)
    return (torch.as_tensor(rated, device=device),
            torch.as_tensor(R, dtype=dtype, device=device))


def _sides(rated, R, dtype, L, d, seed):
    """Both orientations: (dense mask, masked ratings, other, index rows)."""
    n, m = rated.shape
    gen = torch.Generator(device=rated.device).manual_seed(seed)
    by_row, by_col = tgk.index_sides(tpk.rated_index(rated, R, dtype=dtype))
    mask = rated.to(dtype)
    masked_r = torch.where(rated, R, 0.0).to(dtype)

    def other(c):
        return torch.randn(L, c, d, generator=gen, dtype=dtype,
                           device=rated.device)

    return {"U": (mask, masked_r, other(m), by_row),
            "V": (mask.t().contiguous(), masked_r.t().contiguous(), other(n),
                  by_col)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("side", ["U", "V"])
@pytest.mark.parametrize("density", ["empty_row", 0.01, 0.3, 1.0])
@pytest.mark.parametrize("L", [1, 5])
@pytest.mark.parametrize("d", [1, 3, 20])
def test_index_gram_matches_the_dense_product(d, L, density, side, dtype):
    """Gt and mrt from the index equal the mask's matrix products, in the
    same layout; a row with no rated cell gets zeros."""
    empty = density == "empty_row"
    rated, R = _problem(d * 10 + L, 23, 41, 0.3 if empty else density, dtype,
                        empty=empty)
    mask, masked_r, other, rows = _sides(rated, R, dtype, L, d, seed=L)[side]
    want = tgk.dense_gram(mask, masked_r, other)
    got = tgk.masked_gram(rows, other)
    p = d * (d + 1) // 2
    r = mask.shape[0]
    for g, w, shape in zip(got, want, [(L, p + d, r), (L, d, r)]):
        assert g.shape == shape and g.dtype == dtype and g.is_contiguous()
        if w.norm() == 0:
            assert g.norm() == 0
        else:
            assert _rel(g, w) <= RTOL[dtype]
    if empty:
        assert not got[0][:, :, 1].any() and not got[1][:, :, 1].any()


@pytest.mark.parametrize("nnz, shape, device, want", [
    (5000, (943, 1682), "cuda", True),  # ml100k-bpmf-d20: 0.315 %
    (400, (70, 306), "cuda", True),  # db70x306-bpmf-d20: 1.9 %
    (943 * 1682, (943, 1682), "cuda", False),  # every cell rated
    (5000, (943, 1682), "cpu", False),  # the CPU keeps the dense product
])
def test_the_path_follows_the_density(nnz, shape, device, want):
    assert tgk.use_index(nnz, shape, device) is want


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("path", ["dense", "index"])
def test_sides_take_the_form_the_rule_picks(monkeypatch, path, dtype):
    """``sides`` gives both sides in the form ``use_index`` picks (read at
    call time, so a test can force the index on the CPU), in the chain's
    dtype; each side's products are the dense form's of its orientation."""
    from amf_tpu_torch import types as ttypes

    rated, R = _problem(3, 11, 17, 0.3, torch.float64)
    prob = ttypes.problem_from_dense(R.numpy(), rated.numpy(),
                                     dtype=torch.float64, device="cpu")
    if path == "index":
        monkeypatch.setattr(tgk, "use_index", lambda *a: True)
    u_side, v_side = tgk.sides(prob, dtype)
    dense = _sides(rated, R, dtype, 2, 3, seed=4)
    for side, name in ((u_side, "U"), (v_side, "V")):
        mask, masked_r, other, _ = dense[name]
        assert side.indexed is (path == "index")
        assert isinstance(side, tgk.RatedRows if side.indexed
                          else tgk.DenseRows)
        for g, w in zip(side.products(other),
                        tgk.dense_gram(mask, masked_r, other)):
            assert g.dtype == dtype and _rel(g, w) <= RTOL[dtype]


@pytest.mark.parametrize("d", [1, 20, 32, 48])
def test_the_kernel_is_built_one_library_a_width(d):
    from amf_tpu_torch.ops import cuda_build

    assert cuda_build.width_defines("masked_gram", d) == (f"AMF_ONLY_D={d}",)


@pytest.mark.parametrize("path", ["dense", "index"])
def test_the_chain_span_names_its_gram_path(monkeypatch, path):
    """``gibbs.chain`` carries ``gram_index`` under ``profiling.tracing()``;
    the index path (forced on the CPU, so the plain version runs) sums the
    masked Gram once a half sweep."""
    from amf_tpu_torch import types as ttypes
    from amf_tpu_torch.utils import profiling

    rng = np.random.default_rng(5)
    known = rng.random((9, 13)) < 0.3
    prob = ttypes.problem_from_dense(rng.integers(1, 6, (9, 13)).astype(
        float), known, dtype=torch.float64, device="cpu")
    chain = tbg.ChainState(torch.as_tensor(rng.normal(size=(9, 3))),
                           torch.as_tensor(rng.normal(size=(13, 3))),
                           torch.tensor(3.0, dtype=torch.float64))
    if path == "index":
        monkeypatch.setattr(tgk, "use_index", lambda *a: True)
    calls = tgk.masked_gram_plain.calls
    profiling.spans(reset=True)
    with profiling.tracing():
        tbg.run_chain(chain, prob, tbg.GibbsConfig(latent_d=3), 3,
                      generator=torch.Generator().manual_seed(7))
    (sp,) = [s for s in profiling.spans(reset=True)
             if s.name == "gibbs.chain"]
    index = path == "index"
    assert sp.attrs["gram_index"] == int(index)
    assert tgk.masked_gram_plain.calls - calls == (3 * 2 * 2 if index else 0)


def test_cuda_wrapper_refuses_cpu_tensors():
    rated, R = _problem(0, 5, 6, 0.5, torch.float32)
    _, _, other, rows = _sides(rated, R, torch.float32, 2, 3, 0)["U"]
    launches = tgk.masked_gram_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        tgk.masked_gram_cuda(rows, other)
    assert tgk.masked_gram_cuda.launches == launches


# ---------------------------------------------------------------------------
# the CUDA kernel, on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


# (lanes, n, m, rated cells) of the two configurations' lookahead tiles
CELLS = {"ml100k": (160, 943, 1682, 5000), "db70x306": (512, 70, 306, 400)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("side", ["U", "V"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cuda_kernel_matches_plain(cuda_device, cell, side, dtype):
    """At the cells' shapes, d = 20, with a row and a column of no rated
    cell and a row of 200 rated cells (and a column of 200, or of all but
    one of 70)."""
    L, n, m, nnz = CELLS[cell]
    rated, R = _problem(1, n, m, nnz / (n * m), dtype, empty=True,
                        full_row=201, full_col=min(201, n),
                        device=cuda_device)
    assert rated[0].sum() >= 200
    _, _, other, rows = _sides(rated, R, dtype, L, 20, 2)[side]
    launches = tgk.masked_gram_cuda.launches
    got = tgk.masked_gram(rows, other)
    assert tgk.masked_gram_cuda.launches == launches + 1
    want = tgk.masked_gram(rows, other, kernel=False)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.is_contiguous()
        assert _rel(g, w) <= RTOL[dtype]
    assert not got[0][:, :, 1].any() and not got[1][:, :, 1].any()


@pytest.mark.cuda
def test_cuda_kernel_takes_expanded_lanes_and_a_wide_d(cuda_device):
    """``other`` expanded over lanes (stride 0, as the chain's first sweep
    hands it), and d = 40, from a library of that width."""
    rated, R = _problem(3, 57, 91, 0.05, torch.float32, empty=True,
                        full_row=60, device=cuda_device)
    for d in (20, 40):
        _, _, other, rows = _sides(rated, R, torch.float32, 1, d, 4)["U"]
        other = other.expand(6, *other.shape[1:])
        got = tgk.masked_gram(rows, other)
        want = tgk.masked_gram(rows, other.contiguous(), kernel=False)
        for g, w in zip(got, want):
            assert _rel(g, w) <= RTOL[torch.float32]
