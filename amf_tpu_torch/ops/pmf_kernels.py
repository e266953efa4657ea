"""PMF lookahead-refit kernels: CUDA kernels and their plain versions.

The batched lookahead refit (``models/pmf.fit_lookahead_batch``) refits,
for each of L lanes (the shared base problem plus the lane's own cell
(i, j) rated with value v), the MAP factors of PMF by the adaptive
accept/reject ascent. Its kernels mirror ``amf_tpu/ops/pallas_kernels.py``:

  * value and ascent gradients (``pmf_batched_value_grad`` with factors
    (L, rows, d), ``pmf_batched_value_grad_t`` with (L, d, rows)), one CUDA
    source for both layouts, ``csrc/pmf_value_grad.cu``::

        E      = mask * (R - U V^T)
        neg_ll = sum E^2 / 2s + sum U^2 / 2su + sum V^2 / 2sv
        Gu     = E V / s - U / su,        Gv = E^T U / s - V / sv

    The kernel returns the data term ``sum E^2`` and the gradients; the
    wrappers add the prior terms, as the JAX wrappers do. It walks an
    index of the rated cells (``rated_index``: CSR, CSC and the CSC -> CSR
    positions), built once a refit tile and handed down, never the dense
    mask;
  * the improvement quartic of the poly line search along the ray
    (U + a Gu, V + a Gv) (``pmf_line_coeffs_t``, ``csrc/pmf_line_coeffs.cu``):
    the kernel gives the masked reductions a2 = <E, P2>, a11 = <mP1, P1>,
    a12 = <mP1, P2>, a22 = <mP2, P2> with P1 = Gu V^T + U Gv^T and
    P2 = Gu Gv^T, by one walk of the same index; the wrapper assembles
    c1..c4 from them and from the gradients' norms;
  * the whole line search of every lane in one launch
    (``pmf_lookahead_fused_t``, ``csrc/pmf_lookahead_fused.cu``), on the
    same index.

Precision: ``bf16`` streams R, the mask and the factors in bfloat16 and
accumulates every sum in float32. The (L, d, rows) value+gradient kernel
then also rounds the scaled residual E / s to bf16 before the gradient
contractions and returns bf16 gradients, as its TPU kernel does; the
(L, rows, d) layout returns float32 gradients. The fused line search keeps
each lane's factors and gradients in the streaming dtype, forms proposals
in float32 and rounds them to bf16 for the products only. The prior terms
come from the caller's factors, or from the float32 proposal.

Dispatch: a CPU tensor goes to the plain version, at any d. A CUDA tensor
goes to the kernel, at any d, as the JAX kernels take any d: the kernels
keep a row of d values in registers, so each source's library is built for
its widths (``cuda_build.width_defines``): one library serves d <= 32 for
the value+gradient and line-coefficient sources, and a wider d builds a
library for that d at its first use; the fused line search is one library
a width. ``kernel=False`` sends a CUDA tensor to the plain version on
purpose, to compare the two.
``block_rows`` and ``lanes_per_block`` are the JAX signatures' TPU tiling;
they are accepted and change nothing.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from amf_tpu_torch.ops.cuda_build import width_defines
from amf_tpu_torch.ops.linesearch import CHECK_EVERY

_F32 = torch.float32
_BF16 = torch.bfloat16
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# argument types of each source's C function ``amf_<source>``
_ARGTYPES = {
    "pmf_value_grad": [_I] * 4 + [_P] * 16 + [_LL] * 4 + [_I] + [_LL] * 6
    + [_P],
    "pmf_line_coeffs": [_I] * 2 + [_P] * 11 + [_LL] * 3 + [_I] + [_P],
    "pmf_lookahead_fused": [_I] * 2 + [_P] * 20 + [_LL] * 4 + [_I] * 2 + [_P],
}
# and of its ``amf_<source>_smem_bytes``, the shape of a lane
_SHAPE_ARGTYPES = {
    "pmf_value_grad": [_LL] * 3 + [_I],  # n, m, nnz, d
    "pmf_line_coeffs": [_LL, _I],  # rows of the gathered side, d
    "pmf_lookahead_fused": [_LL] * 3,  # n, m, nnz
}


@functools.cache
def _entry_point(source: str, defines: Tuple[str, ...]):
    """The C function of kernel library ``csrc/<source>.cu`` built with
    ``defines`` (``width_defines(source, d)``; built at first use)."""
    from amf_tpu_torch.ops import cuda_build

    fn = getattr(cuda_build.load(source, defines), "amf_" + source)
    fn.argtypes = _ARGTYPES[source]
    fn.restype = ctypes.c_int
    return fn


def _lane_residual(U, V, R, rated, delta_i, delta_j, delta_v):
    """E = mask * (R - U V^T) of every lane, (L, n, m) in U's dtype, with
    the lane's own cell rated at its value. R and ``rated`` are shared by
    all lanes and never copied per lane."""
    dt = U.dtype
    lane = torch.arange(U.shape[0], device=U.device)
    di, dj = delta_i.long(), delta_j.long()
    cell = delta_v.to(dt) - (U[lane, di] * V[lane, dj]).sum(-1)
    E = U @ V.mT
    E.neg_().add_(R.to(dt)).masked_fill_(~rated.bool(), 0.0)
    E[lane, di, dj] = cell
    return E


def _lane_masked(P, rated, delta_i, delta_j):
    """``P`` (L, n, m) zeroed off each lane's rated cells, in place."""
    lane = torch.arange(P.shape[0], device=P.device)
    di, dj = delta_i.long(), delta_j.long()
    cell = P[lane, di, dj]
    P.masked_fill_(~rated.bool(), 0.0)
    P[lane, di, dj] = cell
    return P


def _use_kernel(x: torch.Tensor, kernel: bool, name: str) -> bool:
    """The dispatch rule of the module docstring."""
    if x.device.type == "cpu":
        return False
    if x.device.type == "cuda":
        return kernel
    raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")


def _check_cuda(name, *tensors):
    dev = tensors[0].device
    if not (dev.type == "cuda" and all(x.device == dev for x in tensors)):
        raise ValueError(f"{name}: want every tensor on one CUDA device")
    return dev


class RatedIndex(NamedTuple):
    """The rated cells of a shared (n, m) problem as the kernels walk them:
    by row (CSR), by column (CSC), and each CSC entry's position in CSR
    order. Indices int32, columns ascending within a row and rows within a
    column; R's values in the streaming dtype."""

    row_ptr: torch.Tensor  # (n + 1,) CSR pointers
    col_idx: torch.Tensor  # (nnz,) column of each cell, row by row
    r_row: torch.Tensor  # (nnz,) R of each cell, in CSR order
    col_ptr: torch.Tensor  # (m + 1,) CSC pointers
    row_idx: torch.Tensor  # (nnz,) row of each cell, column by column
    r_col: torch.Tensor  # (nnz,) R of each cell, in CSC order
    csc_pos: torch.Tensor  # (nnz,) CSR position of each CSC entry
    shape: Tuple[int, int]
    nnz: int


def rated_index(rated: torch.Tensor, R: torch.Tensor,
                bf16: bool = False,
                dtype: Optional[torch.dtype] = None) -> RatedIndex:
    """Index the rated cells of ``rated`` (n, m), with R rounded to the
    streaming dtype (bfloat16 with ``bf16``, else float32), or to ``dtype``
    where given (the Gibbs chain's, ``ops/gram_kernel.py``).

    Built with torch ops; ``nonzero`` synchronises the host, so a refit
    builds it once a tile (``models/pmf.fit_lookahead_batch``) and not once
    an evaluation.
    """
    rated_index.calls += 1
    n, m = rated.shape
    mask = rated.to(torch.bool)
    rows, cols = torch.nonzero(mask, as_tuple=True)  # row by row
    r_row = R[rows, cols].to(dtype or (_BF16 if bf16 else _F32))
    # column by column, rows ascending: sort the cells by (column, row)
    csc_pos = torch.argsort(cols * n + rows)

    def pointers(idx, size):
        ptr = torch.zeros(size + 1, dtype=torch.int32, device=R.device)
        ptr[1:] = torch.cumsum(torch.bincount(idx, minlength=size), 0)
        return ptr

    i32 = torch.int32
    return RatedIndex(
        row_ptr=pointers(rows, n), col_idx=cols.to(i32),
        r_row=r_row.contiguous(), col_ptr=pointers(cols, m),
        row_idx=rows[csc_pos].to(i32), r_col=r_row[csc_pos],
        csc_pos=csc_pos.to(i32), shape=(n, m), nnz=rows.shape[0])


rated_index.calls = 0


def _index_for(index: Optional[RatedIndex], rated, R, io) -> RatedIndex:
    """``index`` checked against the problem, or a fresh one."""
    if index is None:
        return rated_index(rated, R, bf16=io == _BF16)
    if index.shape != tuple(rated.shape) or index.r_row.dtype != io or (
            index.r_row.device != R.device):
        raise ValueError(f"rated-cell index of shape {index.shape}, "
                         f"{index.r_row.dtype} on {index.r_row.device} does "
                         f"not fit a {tuple(rated.shape)} problem in {io} on "
                         f"{R.device}")
    return index


def pmf_value_grad_plain(
    U: torch.Tensor, V: torch.Tensor, R: torch.Tensor, rated: torch.Tensor,
    delta_i: torch.Tensor, delta_j: torch.Tensor, delta_v: torch.Tensor,
    sigmas: torch.Tensor, round_resid: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: (sum E^2 (L,), Gu (L, n, d), Gv (L, m, d)).

    U (L, n, d) and V (L, m, d) in any float dtype, which sets the working
    dtype; R and ``rated`` (n, m) are shared by all lanes.
    ``round_resid`` rounds E / s to bf16 before the contractions.
    """
    pmf_value_grad_plain.calls += 1
    dt = U.dtype
    s, s_u, s_v = (x.to(dt) for x in sigmas)
    E = _lane_residual(U, V, R, rated, delta_i, delta_j, delta_v)
    sqerr = (E * E).sum(dim=(1, 2))
    E.mul_(1.0 / s)
    if round_resid:
        E = E.to(_BF16).to(dt)
    return sqerr, E @ V - U / s_u, E.mT @ U - V / s_v


pmf_value_grad_plain.calls = 0


def _neg_ll(sqerr, U, V, sigmas) -> torch.Tensor:
    """Data term plus the prior terms of the factors (either layout), in
    float32, or float64 for float64 factors."""
    dt = torch.promote_types(U.dtype, _F32)
    s, s_u, s_v = (x.to(dt) for x in sigmas)
    U, V = U.to(dt), V.to(dt)
    return (sqerr.to(dt) / (2 * s) + (U * U).sum(dim=(1, 2)) / (2 * s_u)
            + (V * V).sum(dim=(1, 2)) / (2 * s_v))


def pmf_batched_value_grad_reference(
    U, V, R, rated, delta_i, delta_j, delta_v, sigmas
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version with the JAX reference's contract: (neg_ll (L,),
    Gu (L, n, d), Gv (L, m, d)) in U's dtype (pallas_kernels.py:862-882)."""
    sqerr, gu, gv = pmf_value_grad_plain(
        U, V, R, rated, delta_i, delta_j, delta_v, sigmas)
    return _neg_ll(sqerr, U, V, sigmas), gu, gv


def pmf_value_grad_cuda(
    U: torch.Tensor, V: torch.Tensor, R: torch.Tensor, rated: torch.Tensor,
    delta_i: torch.Tensor, delta_j: torch.Tensor, delta_v: torch.Tensor,
    sigmas: torch.Tensor, *, transposed: bool, round_resid: bool,
    out_dtype: torch.dtype, index: Optional[RatedIndex] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel -> (sum E^2 (L,) f32, Gu like U, Gv like V).

    U and V on one CUDA device in one dtype, float32 or bfloat16; U is
    (L, n, d) and V (L, m, d), or (L, d, n) and (L, d, m) when
    ``transposed``; d >= 1. The kernel walks ``index``, the rated
    cells of (``rated``, R) in U's dtype; without one it is built here,
    which synchronises the host. Gradients come back in ``out_dtype``, in
    U's and V's layout; the variants are (float32 in and out), (bf16 in,
    float32 out) and (bf16 in and out with ``round_resid``). A lane's
    factors and residuals go to shared memory where they fit a block, else
    the factors stay in global memory (``variants`` counts both). One
    launch on the current stream, no synchronisation. ``launches`` counts
    launches by (layout, input dtype).
    """
    if U.dim() != 3 or V.dim() != 3:
        raise ValueError(f"want 3-d factors; got {tuple(U.shape)}, "
                         f"{tuple(V.shape)}")
    L = U.shape[0]
    if transposed:
        d, n = U.shape[1:]
        m = V.shape[2]
        v_want = (L, d, m)
    else:
        n, d = U.shape[1:]
        m = V.shape[1]
        v_want = (L, m, d)
    if tuple(V.shape) != v_want or tuple(R.shape) != (n, m) or tuple(
            rated.shape) != (n, m):
        raise ValueError(f"shape mismatch: U {tuple(U.shape)}, V "
                         f"{tuple(V.shape)}, R {tuple(R.shape)}, rated "
                         f"{tuple(rated.shape)} (transposed={transposed})")
    dev = _check_cuda("pmf_value_grad", U, V, R, rated, delta_i, delta_j,
                      delta_v, sigmas)
    if U.dtype not in (_F32, _BF16) or V.dtype != U.dtype:
        raise TypeError(f"want U and V in one dtype, float32 or bfloat16; "
                        f"got {U.dtype}, {V.dtype}")
    combo = (U.dtype == _BF16, out_dtype == _BF16, bool(round_resid))
    if combo not in ((False, False, False), (True, False, False),
                     (True, True, True)):
        raise TypeError(f"unsupported kernel variant: input {U.dtype}, "
                        f"output {out_dtype}, round_resid={round_resid}")
    if not (L >= 1 and n >= 1 and m >= 1 and d >= 1):
        raise ValueError(f"pmf_value_grad kernel takes L, n, m, d >= 1; got "
                         f"L={L}, n={n}, m={m}, d={d}")
    ix = _index_for(index, rated, R, U.dtype)
    U, V = U.contiguous(), V.contiguous()
    di = delta_i.long().contiguous()
    dj = delta_j.long().contiguous()
    dv = delta_v.to(_F32).contiguous()
    sig = sigmas.to(_F32).contiguous()
    gu = torch.empty(U.shape, dtype=out_dtype, device=dev)
    gv = torch.empty(V.shape, dtype=out_dtype, device=dev)
    sqerr = torch.empty((L,), dtype=_F32, device=dev)
    defines = width_defines("pmf_value_grad", d)
    fn = _entry_point("pmf_value_grad", defines)
    shared = _fits_shared("pmf_value_grad", n, m, ix.nnz, d, defines=defines)
    scratch = None if shared else torch.empty((L, ix.nnz + 1), dtype=_F32,
                                              device=dev)
    # element strides (lane, row, k) of each contiguous factor
    su = (d * n, 1, n) if transposed else (n * d, d, 1)
    sv = (d * m, 1, m) if transposed else (m * d, d, 1)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(
        *map(int, combo), int(shared), U.data_ptr(), V.data_ptr(),
        ix.row_ptr.data_ptr(), ix.col_idx.data_ptr(), ix.r_row.data_ptr(),
        ix.col_ptr.data_ptr(), ix.row_idx.data_ptr(), ix.csc_pos.data_ptr(),
        di.data_ptr(), dj.data_ptr(), dv.data_ptr(), sig.data_ptr(),
        gu.data_ptr(), gv.data_ptr(),
        0 if shared else scratch.data_ptr(), sqerr.data_ptr(), L, n, m,
        ix.nnz, d, *su, *sv, stream)
    if err:
        raise RuntimeError(f"pmf_value_grad kernel launch failed: CUDA error "
                           f"{err} (L={L}, n={n}, m={m}, d={d}, {U.dtype}, "
                           f"shared={shared})")
    pmf_value_grad_cuda.launches[
        ("L,d,rows" if transposed else "L,rows,d", str(U.dtype))] += 1
    pmf_value_grad_cuda.variants["shared" if shared else "global"] += 1
    return sqerr, gu, gv


pmf_value_grad_cuda.launches = collections.Counter()
pmf_value_grad_cuda.variants = collections.Counter()


@functools.cache
def _fits_shared(source: str, *shape: int,
                 defines: Tuple[str, ...] = ()) -> bool:
    """Whether what a block of ``csrc/<source>.cu`` keeps in shared memory
    for a lane of this shape fits: the library's
    ``amf_<source>_smem_bytes(*shape)`` against its
    ``amf_<source>_smem_limit()``."""
    from amf_tpu_torch.ops import cuda_build

    lib = cuda_build.load(source, defines)
    need = getattr(lib, f"amf_{source}_smem_bytes")
    limit = getattr(lib, f"amf_{source}_smem_limit")
    need.argtypes, limit.argtypes = _SHAPE_ARGTYPES[source], []
    need.restype = limit.restype = _LL
    return need(*shape) <= limit()


def _value_grad(U, V, R, rated, delta_i, delta_j, delta_v, sigmas, *,
                transposed, bf16, round_resid, out_dtype, kernel, index):
    """The shared body of both wrappers (see the module docstring)."""
    io = _BF16 if bf16 else _F32
    Ui, Vi = U.to(io), V.to(io)
    if _use_kernel(U, kernel, "pmf_value_grad"):
        sqerr, gu, gv = pmf_value_grad_cuda(
            Ui, Vi, R, rated, delta_i, delta_j, delta_v, sigmas,
            transposed=transposed, round_resid=round_resid,
            out_dtype=out_dtype, index=index)
    else:
        def rows(x):  # the plain version works in (L, rows, d)
            return x.mT if transposed else x

        sqerr, gu, gv = pmf_value_grad_plain(
            rows(Ui.to(_F32)), rows(Vi.to(_F32)), R.to(io).to(_F32), rated,
            delta_i, delta_j, delta_v, sigmas, round_resid=round_resid)
        gu = rows(gu).to(out_dtype).contiguous()
        gv = rows(gv).to(out_dtype).contiguous()
    return _neg_ll(sqerr, U, V, sigmas), gu, gv


def pmf_batched_value_grad(
    U, V, R, rated, delta_i, delta_j, delta_v, sigmas,
    block_rows: int = 256, bf16: bool = False, kernel: bool = True,
    index: Optional[RatedIndex] = None,
):
    """Per-lane (neg_ll (L,), Gu (L, n, d), Gv (L, m, d)); factors
    (L, rows, d).

    The port of ``amf_tpu/ops/pallas_kernels.py::pmf_batched_value_grad``.
    Gradients are float32, also with ``bf16``. ``index`` is the problem's
    ``rated_index`` in the streaming dtype, for the kernel; without one the
    kernel path builds it. The plain version ignores it.
    """
    del block_rows  # the TPU's tiling (module docstring)
    return _value_grad(U, V, R, rated, delta_i, delta_j, delta_v, sigmas,
                       transposed=False, bf16=bf16, round_resid=False,
                       out_dtype=_F32, kernel=kernel, index=index)


def pmf_batched_value_grad_t(
    Ut, Vt, R, rated, delta_i, delta_j, delta_v, sigmas,
    block_rows: int = 256, lanes_per_block: int = 8, bf16: bool = True,
    kernel: bool = True, index: Optional[RatedIndex] = None,
):
    """Per-lane (neg_ll (L,), Gut (L, d, n), Gvt (L, d, m)); factors
    (L, d, rows).

    The port of ``amf_tpu/ops/pallas_kernels.py::pmf_batched_value_grad_t``.
    With ``bf16`` the residual is rounded to bf16 before the contractions
    and the gradients come back in bf16. ``index`` as in
    ``pmf_batched_value_grad``.
    """
    del block_rows, lanes_per_block  # the TPU's tiling (module docstring)
    return _value_grad(Ut, Vt, R, rated, delta_i, delta_j, delta_v, sigmas,
                       transposed=True, bf16=bf16, round_resid=bf16,
                       out_dtype=_BF16 if bf16 else _F32, kernel=kernel,
                       index=index)


# ---------------------------------------------------------------------------
# B3: the improvement quartic of the poly line search


def pmf_line_coeffs_plain(Ut, Vt, Gut, Gvt, R, rated, delta_i, delta_j,
                          delta_v) -> torch.Tensor:
    """Plain version of the kernel: (L, 4) = [a2, a11, a12, a22] per lane.

    Factors and directions (L, d, rows) in any float dtype, which sets the
    working dtype; R and ``rated`` (n, m) are shared by all lanes.
    """
    pmf_line_coeffs_plain.calls += 1
    U, V, Gu, Gv = (x.mT for x in (Ut, Vt, Gut, Gvt))
    args = (rated, delta_i, delta_j)
    E = _lane_residual(U, V, R, *args, delta_v)
    mp2 = _lane_masked(Gu @ Gv.mT, *args)
    a2 = (E * mp2).sum(dim=(1, 2))
    del E
    mp1 = Gu @ V.mT
    mp1 += U @ Gv.mT
    mp1 = _lane_masked(mp1, *args)
    return torch.stack([a2, (mp1 * mp1).sum(dim=(1, 2)),
                        (mp1 * mp2).sum(dim=(1, 2)),
                        (mp2 * mp2).sum(dim=(1, 2))], dim=1)


pmf_line_coeffs_plain.calls = 0


def line_coeff_sides(ix: RatedIndex, Ut, Vt, Gut, Gvt, delta_i, delta_j):
    """How the line-coefficient kernel takes a problem: ((X, GX), (Y, GY),
    ptr, idx, r, cell_w, cell_g), a walked side, a thread a row of it, and
    a gathered side, copied to shared memory. The four sums do not change
    when the sides swap, so the shorter side is gathered (less to stage,
    and it fits where the longer would not): the rows, walked by column
    (CSC), where n <= m, else the columns, walked by row (CSR)."""
    if ix.shape[0] <= ix.shape[1]:
        return ((Vt, Gvt), (Ut, Gut), ix.col_ptr, ix.row_idx, ix.r_col,
                delta_j, delta_i)
    return ((Ut, Gut), (Vt, Gvt), ix.row_ptr, ix.col_idx, ix.r_row,
            delta_i, delta_j)


def pmf_line_coeffs_cuda(Ut, Vt, Gut, Gvt, R, rated, delta_i, delta_j,
                         delta_v, index: Optional[RatedIndex] = None
                         ) -> torch.Tensor:
    """Launch the CUDA kernel -> (L, 4) float32 [a2, a11, a12, a22].

    Ut, Gut (L, d, n), Vt, Gvt (L, d, m) on one CUDA device in one dtype,
    float32 or bfloat16; d >= 1. The kernel walks ``index``, the
    rated cells of (``rated``, R) in that dtype, and reads neither the mask
    nor R; without an index it is built here, which synchronises the host.
    Every product and sum is float32. The gathered side's factor and
    direction go to shared memory where they fit a block, else they stay in
    global memory (``variants`` counts both). One launch on the current
    stream, no synchronisation, no scratch: only the (L, 4) result is
    allocated. ``launches`` counts launches by input dtype.
    """
    L, d, n = Ut.shape
    m = Vt.shape[2]
    if (tuple(Gut.shape) != (L, d, n) or tuple(Vt.shape) != (L, d, m)
            or tuple(Gvt.shape) != (L, d, m) or tuple(R.shape) != (n, m)
            or tuple(rated.shape) != (n, m)):
        raise ValueError(f"shape mismatch: Ut {tuple(Ut.shape)}, Vt "
                         f"{tuple(Vt.shape)}, Gut {tuple(Gut.shape)}, Gvt "
                         f"{tuple(Gvt.shape)}, R {tuple(R.shape)}, rated "
                         f"{tuple(rated.shape)}")
    dev = _check_cuda("pmf_line_coeffs", Ut, Vt, Gut, Gvt, R, rated,
                      delta_i, delta_j, delta_v)
    if Ut.dtype not in (_F32, _BF16) or any(
            x.dtype != Ut.dtype for x in (Vt, Gut, Gvt)):
        raise TypeError("want Ut, Vt, Gut, Gvt in one dtype, float32 or "
                        "bfloat16")
    if not (L >= 1 and n >= 1 and m >= 1 and d >= 1):
        raise ValueError(f"pmf_line_coeffs kernel takes L, n, m, d >= 1; got "
                         f"L={L}, n={n}, m={m}, d={d}")
    ix = _index_for(index, rated, R, Ut.dtype)
    Ut, Vt, Gut, Gvt = (x.contiguous() for x in (Ut, Vt, Gut, Gvt))
    walked, gathered, ptr, idx, r, cell_w, cell_g = line_coeff_sides(
        ix, Ut, Vt, Gut, Gvt, delta_i.long().contiguous(),
        delta_j.long().contiguous())
    rows_w, rows_g = walked[0].shape[2], gathered[0].shape[2]
    dv = delta_v.to(_F32).contiguous()
    defines = width_defines("pmf_line_coeffs", d)
    shared = _fits_shared("pmf_line_coeffs", rows_g, d, defines=defines)
    acc = torch.empty((L, 4), dtype=_F32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _entry_point("pmf_line_coeffs", defines)(
        int(Ut.dtype == _BF16), int(shared), *(x.data_ptr() for x in (
            *walked, *gathered, ptr, idx, r, cell_w, cell_g, dv, acc)),
        L, rows_w, rows_g, d, stream)
    if err:
        raise RuntimeError(f"pmf_line_coeffs kernel launch failed: CUDA "
                           f"error {err} (L={L}, n={n}, m={m}, d={d}, "
                           f"{Ut.dtype}, shared={shared})")
    pmf_line_coeffs_cuda.launches[str(Ut.dtype)] += 1
    pmf_line_coeffs_cuda.variants["shared" if shared else "global"] += 1
    return acc


pmf_line_coeffs_cuda.launches = collections.Counter()
pmf_line_coeffs_cuda.variants = collections.Counter()


def pmf_line_coeffs_t(
    Ut, Vt, Gut, Gvt, R, rated, delta_i, delta_j, delta_v, sigmas,
    block_rows: int = 256, lanes_per_block: int = 8, bf16: bool = True,
    kernel: bool = True, index: Optional[RatedIndex] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Improvement-quartic coefficients (c1, c2, c3, c4), each (L,), of

        delta(a) = f(U, V) - f(U + a Gu, V + a Gv)
                 = c1 a + c2 a^2 + c3 a^3 + c4 a^4

    per lane; factors and ascent directions (L, d, rows). The port of
    ``amf_tpu/ops/pallas_kernels.py::pmf_line_coeffs_t``: the masked
    reductions come from the kernel (with ``bf16`` from bf16-rounded R and
    factors, float32 sums); c1 = |Gu|^2 + |Gv|^2 and the prior term b2 come
    from the float32 cast of the given directions, not from the cancelling
    difference a1/s - <U, Gu>/su - <V, Gv>/sv. ``index`` as in
    ``pmf_batched_value_grad``.
    """
    del block_rows, lanes_per_block  # the TPU's tiling (module docstring)
    io = _BF16 if bf16 else _F32
    ins = [x.to(io) for x in (Ut, Vt, Gut, Gvt)]
    args = (rated, delta_i, delta_j, delta_v)
    if _use_kernel(Ut, kernel, "pmf_line_coeffs"):
        acc = pmf_line_coeffs_cuda(*ins, R, *args, index=index)
    else:
        acc = pmf_line_coeffs_plain(*(x.to(_F32) for x in ins),
                                    R.to(io).to(_F32), *args)
    a2, a11, a12, a22 = acc.unbind(1)
    gu, gv = Gut.to(_F32), Gvt.to(_F32)
    s, s_u, s_v = sigmas.to(_F32)
    uu, vv = (gu * gu).sum(dim=(1, 2)), (gv * gv).sum(dim=(1, 2))
    b2 = 0.5 * (uu / s_u + vv / s_v)
    return (uu + vv, -(a11 - 2.0 * a2) / (2.0 * s) - b2, -a12 / s,
            -a22 / (2.0 * s))


# ---------------------------------------------------------------------------
# B5: the whole line search of every lane in one launch


def pmf_lookahead_fused_plain(
    Ut0, Vt0, R, rated, delta_i, delta_j, delta_v, sigmas, ls_params,
    max_steps: int, bf16: bool,
) -> Tuple[torch.Tensor, ...]:
    """Plain version of the kernel -> (f (L,) float32, Ut (L, d, n),
    Vt (L, d, m) in the streaming dtype, evaluations (L,) int32, accepted
    proposals (L,) int32).

    Every lane starts at (Ut0, Vt0) (d, rows), rounded to the streaming
    dtype, and runs the adaptive accept/reject ascent with
    ``ls_params = [lr0, stop_thresh, min_lr]``: an init evaluation, then
    ``max_steps`` steps, which a converged lane skips. It reproduces the
    kernel's roundings: the lane's factors and gradients are stored in the
    streaming dtype; a proposal ``U + lr Gu`` is formed in float32 from
    that storage; with ``bf16`` the products take the proposal rounded to
    bf16 and the scaled residual is rounded to bf16 before the two
    contractions, while the squared error, the prior terms of the value and
    of the gradients take the float32 values.
    """
    pmf_lookahead_fused_plain.calls += 1
    io = _BF16 if bf16 else _F32
    L = delta_i.shape[0]
    d, n = Ut0.shape
    m = Vt0.shape[1]
    s, s_u, s_v = sigmas.to(_F32)
    lr0, stop, min_lr = ls_params.to(_F32)
    inv_sig = 1.0 / s
    R32 = R.to(io).to(_F32)
    args = (rated, delta_i, delta_j, delta_v)

    def evaluate(up, vp):
        """(f, Gu, Gv) at the float32 proposal (L, n, d), (L, m, d)."""
        pu, pv = up.to(io).to(_F32), vp.to(io).to(_F32)
        E = _lane_residual(pu, pv, R32, *args)
        sqerr = (E * E).sum(dim=(1, 2))
        E.mul_(inv_sig)
        E = E.to(io).to(_F32)
        f = (sqerr / (2 * s) + (up * up).sum(dim=(1, 2)) / (2 * s_u)
             + (vp * vp).sum(dim=(1, 2)) / (2 * s_v))
        return f, E @ pv - up / s_u, E.mT @ pu - vp / s_v

    up = Ut0.to(io).to(_F32).mT.expand(L, n, d)
    vp = Vt0.to(io).to(_F32).mT.expand(L, m, d)
    f, gup, gvp = evaluate(up, vp)
    state = [x.to(io) for x in (up, vp, gup, gvp)]
    lr = lr0.expand(L).clone()
    done = torch.zeros(L, dtype=torch.bool, device=f.device)
    evals = torch.ones(L, dtype=torch.int32, device=f.device)
    accepts = torch.zeros(L, dtype=torch.int32, device=f.device)
    for step in range(max_steps):
        if step % CHECK_EVERY == 0 and bool(done.all()):
            break
        u, v, gu, gv = state
        up = u.to(_F32) + lr[:, None, None] * gu.to(_F32)
        vp = v.to(_F32) + lr[:, None, None] * gv.to(_F32)
        fp, gup, gvp = evaluate(up, vp)
        active = ~done
        accept = active & torch.isfinite(fp) & (fp < f)
        conv = torch.where(accept, (f - fp) < stop, lr * 0.5 < min_lr)
        sel = accept[:, None, None]
        state = [torch.where(sel, new.to(io), old)
                 for new, old in zip((up, vp, gup, gvp), state)]
        f = torch.where(accept, fp, f)
        lr = torch.where(active, torch.where(accept, lr * 1.25, lr * 0.5), lr)
        done = done | (active & conv)
        evals += active
        accepts += accept
    return f, state[0].mT, state[1].mT, evals, accepts


pmf_lookahead_fused_plain.calls = 0


def pmf_lookahead_fused_cuda(
    Ut0, Vt0, R, rated, delta_i, delta_j, delta_v, sigmas, ls_params,
    max_steps: int, bf16: bool, index: Optional[RatedIndex] = None,
) -> Tuple[torch.Tensor, ...]:
    """Launch the CUDA kernel -> (f (L,) float32, Ut (L, d, n), Vt (L, d, m)
    in the streaming dtype, evaluations (L,) int32, accepted proposals (L,)
    int32); the contract of ``pmf_lookahead_fused_plain``.

    Ut0 (d, n), Vt0 (d, m), R and ``rated`` (n, m) on one CUDA device;
    d >= 1; every lane's cell inside the problem. The kernel walks
    ``index`` (``rated_index`` of the problem in the streaming dtype);
    without one it is built here. The kernel's library is built for this d
    at first use (``width_defines``). One thread block runs one lane's whole
    line search, on two sets of (L, d, rows) state buffers allocated here
    (set 0 comes back as the result). The proposal's factors and the
    residuals go to shared memory where they fit a block, else the factors
    are gathered from global memory and the residuals take an
    (L, nnz + 1) scratch (``variants`` counts both). The launch goes on the
    current stream and does not synchronise, but checking the cells (and
    indexing the mask, without ``index``) does. ``launches`` counts launches
    by streaming dtype.
    """
    d, n = Ut0.shape
    m = Vt0.shape[1]
    L = delta_i.shape[0]
    if (tuple(Vt0.shape) != (d, m) or tuple(R.shape) != (n, m)
            or tuple(rated.shape) != (n, m)):
        raise ValueError(f"shape mismatch: Ut0 {tuple(Ut0.shape)}, Vt0 "
                         f"{tuple(Vt0.shape)}, R {tuple(R.shape)}, rated "
                         f"{tuple(rated.shape)}")
    dev = _check_cuda("pmf_lookahead_fused", Ut0, Vt0, R, rated, delta_i,
                      delta_j, delta_v, sigmas, ls_params)
    if not (L >= 1 and n >= 1 and m >= 1 and d >= 1 and max_steps >= 0):
        raise ValueError(f"pmf_lookahead_fused kernel takes L, n, m, d >= 1 "
                         f"and max_steps >= 0; got L={L}, n={n}, m={m}, "
                         f"d={d}, max_steps={max_steps}")
    if bool(((delta_i < 0) | (delta_i >= n) | (delta_j < 0)
             | (delta_j >= m)).any()):
        raise ValueError(f"pmf_lookahead_fused: a lane's cell lies outside "
                         f"the {n} x {m} problem")
    io = _BF16 if bf16 else _F32
    ix = _index_for(index, rated, R, io)
    u0, v0 = Ut0.to(io).contiguous(), Vt0.to(io).contiguous()
    di = delta_i.to(torch.int32).contiguous()
    dj = delta_j.to(torch.int32).contiguous()
    dv = delta_v.to(_F32).contiguous()
    sig = sigmas.to(_F32).contiguous()
    ls = ls_params.to(_F32).contiguous()
    # both sets of every lane's factors and gradients, (d, rows) a lane
    u, gu = (torch.empty((2, L, d, n), dtype=io, device=dev) for _ in "ab")
    v, gv = (torch.empty((2, L, d, m), dtype=io, device=dev) for _ in "ab")
    f = torch.empty((L,), dtype=_F32, device=dev)
    # evaluations and accepted proposals of every lane
    counts = torch.empty((L, 2), dtype=torch.int32, device=dev)
    defines = width_defines("pmf_lookahead_fused", d)
    shared = _fits_shared("pmf_lookahead_fused", n, m, ix.nnz,
                          defines=defines)
    scratch = None if shared else torch.empty((L, ix.nnz + 1), dtype=_F32,
                                              device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _entry_point("pmf_lookahead_fused", defines)(
        int(bf16), int(shared), *(x.data_ptr() for x in (
            u0, v0, ix.row_ptr, ix.col_idx, ix.r_row, ix.col_ptr, ix.row_idx,
            ix.csc_pos, di, dj, dv, sig, ls, u, v, gu, gv)),
        0 if shared else scratch.data_ptr(), f.data_ptr(), counts.data_ptr(),
        L, n, m, ix.nnz, d, int(max_steps), stream)
    if err:
        raise RuntimeError(f"pmf_lookahead_fused kernel launch failed: CUDA "
                           f"error {err} (L={L}, n={n}, m={m}, d={d}, {io}, "
                           f"shared={shared})")
    pmf_lookahead_fused_cuda.launches[str(io)] += 1
    pmf_lookahead_fused_cuda.variants["shared" if shared else "global"] += 1
    return f, u[0], v[0], counts[:, 0], counts[:, 1]


pmf_lookahead_fused_cuda.launches = collections.Counter()
pmf_lookahead_fused_cuda.variants = collections.Counter()


def pmf_lookahead_fused_t(
    Ut0, Vt0, R, rated, delta_i, delta_j, delta_v, sigmas, ls_params,
    max_steps: int, block_rows: int = 256, lanes_per_block: int = 8,
    bf16: bool = True, kernel: bool = True,
    index: Optional[RatedIndex] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Whole-line-search lookahead refit -> (neg_ll (L,), Ut (L, d, n),
    Vt (L, d, m)), float32.

    The port of ``amf_tpu/ops/pallas_kernels.py::pmf_lookahead_fused_t``:
    every lane starts at the base factors (Ut0 (d, n), Vt0 (d, m)) and runs
    the accept/reject ascent of ``fit_lookahead_batch`` with
    ``ls_params = [lr0, stop_thresh, min_lr]`` for ``max_steps`` steps, in
    one launch (see ``pmf_lookahead_fused_plain`` for the roundings).
    ``index`` as in ``pmf_batched_value_grad``.
    """
    del block_rows, lanes_per_block  # the TPU's tiling (module docstring)
    args = (Ut0, Vt0, R, rated, delta_i, delta_j, delta_v, sigmas, ls_params,
            max_steps, bf16)
    if _use_kernel(Ut0, kernel, "pmf_lookahead_fused"):
        f, Ut, Vt, *_ = pmf_lookahead_fused_cuda(*args, index=index)
    else:
        f, Ut, Vt, *_ = pmf_lookahead_fused_plain(*args)
    return f, Ut.to(_F32), Vt.to(_F32)
