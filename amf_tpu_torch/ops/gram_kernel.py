"""The Gibbs row draws' masked Gram: its two forms, the rule between them,
and the CUDA kernel and plain version of the index form.

Every Gibbs half sweep (models/bpmf_gibbs._sample_rows) needs, for every
lane l and row i of the factor being drawn, with o_j = other[l, j] and the
rated cells j of row i, the products the Cholesky kernel
(``ops/chol_kernel.chol_gram_solve_sample``) reads:

    Gt (L, p + d, r):  the packed lower triangle of sum_j o_j o_j^T
                       (``tril_pairs`` order), then sum_j o_j;
    mrt (L, d, r):     sum_j r_ij o_j.

``sides(problem, dtype)`` gives, once a chain, the U side and the V side
of a problem in one of two forms; each answers ``products(other)`` with
(Gt, mrt) and says by ``indexed`` which form it is:

  * ``DenseRows``, the dense form (``dense_gram``): two matrix products of
    the shared 0/1 mask and the masked ratings, as the JAX package forms
    them;
  * ``RatedRows``, the index form (``masked_gram``): sums over the rated
    cells alone, from the index the PMF kernels walk
    (``ops/pmf_kernels.rated_index``), by row (CSR) for the U side and by
    column (CSC) for the V side, ratings in the chain's dtype. The
    hand-written kernel is ``amf_tpu_torch/csrc/masked_gram.cu`` (it
    replaces no Pallas kernel: the JAX package leaves the product to XLA);
    ``masked_gram_plain`` is its plain PyTorch version.

Which form (``use_index``): a CUDA problem whose density nnz / (r c) is at
most ``GRAM_INDEX_MAX_DENSITY`` takes the index; a denser one, and every
CPU tensor, the dense form, which is the JAX reference's and what the CPU
tests hold the port to.

Dispatch of ``masked_gram``: a CPU tensor goes to the plain version; a
CUDA tensor to the kernel, in float32 or float64, at any d (one library a
width, built at its first use: ``cuda_build.width_defines``), or to the
plain version when ``kernel`` is False, to compare the two on the same
inputs.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple, Union

import torch

from amf_tpu_torch.ops.chol_kernel import tril_pairs
from amf_tpu_torch.ops.pmf_kernels import RatedIndex, rated_index
from amf_tpu_torch.types import Problem

_SOURCE = "masked_gram"

# The density nnz / (r c) above which the dense matrix product of the mask
# is faster than the index kernel, measured at one shape only: 8.6 % in f32
# and 8.4 % in f64 on an H100 (700 W) at 160 lanes, d = 20, 943 x 1682,
# uniform masks (``probe_kernels --gram``; PERF.md §6). Problems above it:
# the reference's 10 x 10 experiments (``run/experiment.py``), whose Gibbs
# arm starts from 10 of 100 cells rated and rates more every step.
GRAM_INDEX_MAX_DENSITY = 0.08


class RatedRows(NamedTuple):
    """The index form of one side: the rated cells of one orientation, row
    by row, which the index Gram walks for the factor whose rows they
    are."""

    ptr: torch.Tensor  # (r + 1,) int32, each row's first cell
    idx: torch.Tensor  # (nnz,) int32, each cell's row of ``other``
    vals: torch.Tensor  # (nnz,) each cell's rating, in the chain's dtype

    indexed = True

    def products(self, other: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        return masked_gram(self, other)


def index_sides(ix: RatedIndex) -> Tuple[RatedRows, RatedRows]:
    """(U side, V side) of a rated-cell index: its CSR and its CSC."""
    return (RatedRows(ix.row_ptr, ix.col_idx, ix.r_row),
            RatedRows(ix.col_ptr, ix.row_idx, ix.r_col))


def use_index(nnz: int, shape: Tuple[int, int], device) -> bool:
    """Whether the row draws of a problem of ``shape`` with ``nnz`` rated
    cells on ``device`` take the index Gram (the module docstring's rule)."""
    r, c = shape
    return (torch.device(device).type == "cuda"
            and nnz <= GRAM_INDEX_MAX_DENSITY * r * c)


@functools.cache
def _library_fns(defines):
    from amf_tpu_torch.ops import cuda_build

    lib = cuda_build.load(_SOURCE, defines)
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    fns = {}
    for dtype, suffix in ((torch.float32, "f32"), (torch.float64, "f64")):
        fn = getattr(lib, "amf_masked_gram_" + suffix)
        fn.argtypes = [p] * 6 + [ll] * 3 + [ctypes.c_int, p]
        fn.restype = ctypes.c_int
        fns[dtype] = fn
    return fns


def _entry_points(d: int):
    from amf_tpu_torch.ops import cuda_build

    return _library_fns(cuda_build.width_defines(_SOURCE, d))


def masked_gram_plain(rows: RatedRows, other: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version -> (Gt (L, p + d, r), mrt (L, d, r)), contiguous.

    Gathers every rated cell's factor row, forms its p + 2 d products and
    adds them into their rows."""
    masked_gram_plain.calls += 1
    L, _, d = other.shape
    r, nnz = rows.ptr.shape[0] - 1, rows.idx.shape[0]
    a, b = tril_pairs(d, other.device)
    p = a.shape[0]
    row_of = torch.repeat_interleave(
        torch.arange(r, device=other.device), rows.ptr.diff().long(),
        output_size=nnz)
    o = other[:, rows.idx.long()]  # (L, nnz, d)
    terms = torch.cat([o[..., a] * o[..., b], o, rows.vals[:, None] * o],
                      dim=-1)
    sums = other.new_zeros((L, r, p + 2 * d)).index_add_(1, row_of, terms)
    return (sums[..., :p + d].mT.contiguous(),
            sums[..., p + d:].mT.contiguous())


masked_gram_plain.calls = 0


def masked_gram_cuda(rows: RatedRows, other: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel -> (Gt (L, p + d, r), mrt (L, d, r)).

    ``other`` (L, c, d) in float32 or float64 with any lane stride but
    contiguous (c, d) slabs (copied otherwise); ``rows`` on the same CUDA
    device, int32 pointers and indices, ratings in other's dtype. One launch
    on the current stream, no synchronisation; the outputs are allocated
    here.
    """
    if other.dim() != 3:
        raise ValueError(f"want other (L, c, d); got {tuple(other.shape)}")
    L, _, d = other.shape
    ptr, idx, vals = rows
    if ptr.dim() != 1 or idx.shape != vals.shape or idx.dim() != 1:
        raise ValueError(f"want ptr (r + 1,), idx and vals (nnz,); got "
                         f"{tuple(ptr.shape)}, {tuple(idx.shape)}, "
                         f"{tuple(vals.shape)}")
    dev = other.device
    if dev.type != "cuda" or any(x.device != dev for x in rows):
        raise ValueError("masked_gram kernel: want every tensor on one CUDA "
                         "device")
    if other.dtype not in (torch.float32, torch.float64) or (
            vals.dtype != other.dtype):
        raise TypeError(f"want other and the ratings in one dtype, float32 "
                        f"or float64; got {other.dtype}, {vals.dtype}")
    if ptr.dtype != torch.int32 or idx.dtype != torch.int32:
        raise TypeError(f"want int32 pointers and indices; got {ptr.dtype}, "
                        f"{idx.dtype}")
    if d < 1:
        raise ValueError(f"masked_gram kernel takes d >= 1; got d={d}")
    r = ptr.shape[0] - 1
    p = d * (d + 1) // 2
    Gt = torch.empty((L, p + d, r), dtype=other.dtype, device=dev)
    mrt = torch.empty((L, d, r), dtype=other.dtype, device=dev)
    if L == 0 or r == 0:
        return Gt, mrt
    if not (other.stride(2) == 1 and other.stride(1) == d):
        other = other.contiguous()
    ptr, idx, vals = ptr.contiguous(), idx.contiguous(), vals.contiguous()
    fn = _entry_points(d)[other.dtype]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(ptr.data_ptr(), idx.data_ptr(), vals.data_ptr(),
             other.data_ptr(), Gt.data_ptr(), mrt.data_ptr(), L, r,
             other.stride(0), d, stream)
    if err:
        raise RuntimeError(f"masked_gram kernel launch failed: CUDA error "
                           f"{err} (L={L}, r={r}, d={d}, {other.dtype})")
    masked_gram_cuda.launches += 1
    return Gt, mrt


masked_gram_cuda.launches = 0


def masked_gram(rows: RatedRows, other: torch.Tensor, kernel: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every lane's masked Gram and right-hand-side products of the rows
    ``rows`` indexes, summed over their rated cells -> (Gt, mrt), in the
    layout of ``dense_gram``. Dispatch as the module docstring says."""
    if other.device.type == "cpu" or (other.device.type == "cuda"
                                      and not kernel):
        return masked_gram_plain(rows, other)
    if other.device.type != "cuda":
        raise ValueError(f"masked_gram runs on cpu or cuda, not "
                         f"{other.device}")
    return masked_gram_cuda(rows, other)


# ---------------------------------------------------------------------------
# the dense form, and the choice of form


def dense_gram(
    mask: torch.Tensor, masked_r: torch.Tensor, other: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every lane's masked Gram and right-hand-side products, rows minor,
    as the solve-and-sample kernel reads them: the dense form.

    mask, masked_r (r, c) shared by all lanes, other (L, c, d). With
    p = d (d + 1) / 2: Gt (L, p + d, r) holds, for every row i, the packed
    lower triangle of sum_j mask_ij o_j o_j^T and then sum_j mask_ij o_j;
    mrt (L, d, r) holds sum_j masked_r_ij o_j. Two matrix products over
    every cell of the mask; only the p distinct products o_a o_b are
    formed. ``masked_gram`` gives the same from the rated cells alone.
    """
    L, c, d = other.shape
    r = mask.shape[0]
    a, b = tril_pairs(d, other.device)
    p = a.shape[0]
    ot = other.mT
    Xt = other.new_empty((L, p + d, c))
    torch.mul(ot[:, a], ot[:, b], out=Xt[:, :p])
    Xt[:, p:] = ot
    Gt = (Xt.view(L * (p + d), c) @ mask.T).view(L, p + d, r)
    mrt = torch.bmm(Xt[:, p:], masked_r.T.expand(L, c, r))
    return Gt, mrt


class DenseRows(NamedTuple):
    """The dense form of one side, in its orientation: the factor's rows
    are the rows of both matrices."""

    mask: torch.Tensor  # (r, c) 0/1, in the chain's dtype
    masked_r: torch.Tensor  # (r, c) mask * ratings

    indexed = False

    def products(self, other: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        return dense_gram(self.mask, self.masked_r, other)


Side = Union[DenseRows, RatedRows]


def sides(problem: Problem, dtype) -> Tuple[Side, Side]:
    """(U side, V side) of ``problem`` in the form ``use_index`` picks, in
    ``dtype``: built once a chain, as reading the count of rated cells and
    the index's ``nonzero`` synchronise the host."""
    rated = problem.rated
    nnz = int(rated.sum())
    if use_index(nnz, problem.shape, rated.device):
        return index_sides(rated_index(rated, problem.R_obs, dtype=dtype))
    mask = rated.to(dtype)
    masked_r = torch.where(rated, problem.R_obs, 0.0).to(dtype)
    return (DenseRows(mask, masked_r),
            DenseRows(mask.t().contiguous(), masked_r.t().contiguous()))
