"""Per-lane PMF value and ascent gradients: CUDA kernel and plain version.

The batched lookahead refit (``models/pmf.fit_lookahead_batch``) evaluates,
for each of L lanes (the shared base problem plus the lane's own cell
(i, j) rated with value v), the negative log posterior and its ascent
gradients::

    E      = mask * (R - U V^T)
    neg_ll = sum E^2 / 2s + sum U^2 / 2su + sum V^2 / 2sv
    Gu     = E V / s - U / su,        Gv = E^T U / s - V / sv

Mirrors ``amf_tpu/ops/pallas_kernels.py``, whose two Pallas kernels for it
differ only in layout: ``pmf_batched_value_grad`` takes factors as
(L, rows, d), ``pmf_batched_value_grad_t`` as (L, d, rows). Here one CUDA
source (``amf_tpu_torch/csrc/pmf_value_grad.cu``) serves both: it is given
the factors' strides. The kernel returns the data term ``sum E^2`` and the
gradients; the wrappers add the prior terms in plain PyTorch, as the JAX
wrappers do outside their kernels.

Precision: ``bf16`` streams R, the mask and the factors in bfloat16 and
accumulates every sum in float32. The (L, d, rows) layout then also rounds
the scaled residual E / s to bf16 before the gradient contractions and
returns bf16 gradients, as its TPU kernel does; the (L, rows, d) layout
returns float32 gradients. The prior terms come from the caller's factors.

Dispatch: a CPU tensor goes to the plain version. A CUDA tensor goes to the
kernel, or raises; ``kernel=False`` sends it to the plain version on
purpose, to compare the two. ``block_rows`` and ``lanes_per_block`` are the
JAX signatures' TPU tiling; they are accepted and change nothing.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Tuple

import torch

MAX_D = 32
_SOURCE = "pmf_value_grad"
_F32 = torch.float32
_BF16 = torch.bfloat16


@functools.cache
def _entry_point():
    """The kernel library's C function (built at first use)."""
    from amf_tpu_torch.ops import cuda_build

    fn = cuda_build.load(_SOURCE).amf_pmf_value_grad
    fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 12
                   + [ctypes.c_longlong] * 3 + [ctypes.c_int]
                   + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def pmf_value_grad_plain(
    U: torch.Tensor, V: torch.Tensor, R: torch.Tensor, rated: torch.Tensor,
    delta_i: torch.Tensor, delta_j: torch.Tensor, delta_v: torch.Tensor,
    sigmas: torch.Tensor, round_resid: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: (sum E^2 (L,), Gu (L, n, d), Gv (L, m, d)).

    U (L, n, d) and V (L, m, d) in any float dtype, which sets the working
    dtype; R and ``rated`` (n, m) are shared by all lanes and never copied
    per lane: each lane's cell is patched into its own residual.
    ``round_resid`` rounds E / s to bf16 before the contractions.
    """
    pmf_value_grad_plain.calls += 1
    dt = U.dtype
    s, s_u, s_v = (x.to(dt) for x in sigmas)
    lane = torch.arange(U.shape[0], device=U.device)
    di, dj = delta_i.long(), delta_j.long()
    cell = delta_v.to(dt) - (U[lane, di] * V[lane, dj]).sum(-1)
    E = U @ V.mT
    E.neg_().add_(R.to(dt)).masked_fill_(~rated.bool(), 0.0)
    E[lane, di, dj] = cell
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
    out_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel -> (sum E^2 (L,) f32, Gu like U, Gv like V).

    U, V and R on one CUDA device in one dtype, float32 or bfloat16; U is
    (L, n, d) and V (L, m, d), or (L, d, n) and (L, d, m) when
    ``transposed``; 1 <= d <= 32. Gradients come back in ``out_dtype``, in
    U's and V's layout; the variants are (float32 in and out), (bf16 in,
    float32 out) and (bf16 in and out with ``round_resid``). The launch
    goes on the current stream and does not synchronise. ``launches``
    counts launches by (layout, input dtype).
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
    dev = U.device
    if not (U.is_cuda and all(x.device == dev for x in (
            V, R, rated, delta_i, delta_j, delta_v, sigmas))):
        raise ValueError("want every tensor on one CUDA device")
    if U.dtype not in (_F32, _BF16) or not (V.dtype == R.dtype == U.dtype):
        raise TypeError(f"want U, V, R in one dtype, float32 or bfloat16; "
                        f"got {U.dtype}, {V.dtype}, {R.dtype}")
    combo = (U.dtype == _BF16, out_dtype == _BF16, bool(round_resid))
    if combo not in ((False, False, False), (True, False, False),
                     (True, True, True)):
        raise TypeError(f"unsupported kernel variant: input {U.dtype}, "
                        f"output {out_dtype}, round_resid={round_resid}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"pmf_value_grad kernel takes 1 <= d <= {MAX_D}; "
                         f"got d={d}")
    if not (1 <= L <= 65535 and n >= 1 and m >= 1):
        raise ValueError(f"pmf_value_grad kernel takes 1 <= L <= 65535 "
                         f"lanes and n, m >= 1; got L={L}, n={n}, m={m}")
    U, V, R = U.contiguous(), V.contiguous(), R.contiguous()
    mask = rated.to(torch.bool).contiguous().view(torch.uint8)
    di = delta_i.to(torch.int32).contiguous()
    dj = delta_j.to(torch.int32).contiguous()
    dv = delta_v.to(_F32).contiguous()
    sig = sigmas.to(_F32).contiguous()
    gu = torch.empty(U.shape, dtype=out_dtype, device=dev)
    gv = torch.empty(V.shape, dtype=out_dtype, device=dev)
    row_sq = torch.empty((L, n), dtype=_F32, device=dev)
    sqerr = torch.empty((L,), dtype=_F32, device=dev)
    # element strides (lane, row, k) of each factor
    su = (U.stride(0), U.stride(2), U.stride(1)) if transposed else U.stride()
    sv = (V.stride(0), V.stride(2), V.stride(1)) if transposed else V.stride()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _entry_point()(
        *map(int, combo), U.data_ptr(), V.data_ptr(), R.data_ptr(),
        mask.data_ptr(), di.data_ptr(), dj.data_ptr(), dv.data_ptr(),
        sig.data_ptr(), gu.data_ptr(), gv.data_ptr(), row_sq.data_ptr(),
        sqerr.data_ptr(), L, n, m, d, *su, *sv, stream)
    if err:
        raise RuntimeError(f"pmf_value_grad kernel launch failed: CUDA error "
                           f"{err} (L={L}, n={n}, m={m}, d={d}, {U.dtype})")
    pmf_value_grad_cuda.launches[
        ("L,d,rows" if transposed else "L,rows,d", str(U.dtype))] += 1
    return sqerr, gu, gv


pmf_value_grad_cuda.launches = collections.Counter()


def _value_grad(U, V, R, rated, delta_i, delta_j, delta_v, sigmas, *,
                transposed, bf16, round_resid, out_dtype, kernel):
    """The shared body of both wrappers (see the module docstring)."""
    io = _BF16 if bf16 else _F32
    Ui, Vi, Ri = U.to(io), V.to(io), R.to(io)
    if U.device.type == "cpu" or (U.device.type == "cuda" and not kernel):
        def rows(x):  # the plain version works in (L, rows, d)
            return x.mT if transposed else x

        sqerr, gu, gv = pmf_value_grad_plain(
            rows(Ui.to(_F32)), rows(Vi.to(_F32)), Ri.to(_F32), rated,
            delta_i, delta_j, delta_v, sigmas, round_resid=round_resid)
        gu = rows(gu).to(out_dtype).contiguous()
        gv = rows(gv).to(out_dtype).contiguous()
    elif U.device.type == "cuda":
        sqerr, gu, gv = pmf_value_grad_cuda(
            Ui, Vi, Ri, rated, delta_i, delta_j, delta_v, sigmas,
            transposed=transposed, round_resid=round_resid,
            out_dtype=out_dtype)
    else:
        raise ValueError(f"pmf_value_grad runs on cpu or cuda, not {U.device}")
    return _neg_ll(sqerr, U, V, sigmas), gu, gv


def pmf_batched_value_grad(
    U, V, R, rated, delta_i, delta_j, delta_v, sigmas,
    block_rows: int = 256, bf16: bool = False, kernel: bool = True,
):
    """Per-lane (neg_ll (L,), Gu (L, n, d), Gv (L, m, d)); factors
    (L, rows, d).

    The port of ``amf_tpu/ops/pallas_kernels.py::pmf_batched_value_grad``.
    Gradients are float32, also with ``bf16``.
    """
    del block_rows  # the TPU's tiling (module docstring)
    return _value_grad(U, V, R, rated, delta_i, delta_j, delta_v, sigmas,
                       transposed=False, bf16=bf16, round_resid=False,
                       out_dtype=_F32, kernel=kernel)


def pmf_batched_value_grad_t(
    Ut, Vt, R, rated, delta_i, delta_j, delta_v, sigmas,
    block_rows: int = 256, lanes_per_block: int = 8, bf16: bool = True,
    kernel: bool = True,
):
    """Per-lane (neg_ll (L,), Gut (L, d, n), Gvt (L, d, m)); factors
    (L, d, rows).

    The port of ``amf_tpu/ops/pallas_kernels.py::pmf_batched_value_grad_t``.
    With ``bf16`` the residual is rounded to bf16 before the contractions
    and the gradients come back in bf16.
    """
    del block_rows, lanes_per_block  # the TPU's tiling (module docstring)
    return _value_grad(Ut, Vt, R, rated, delta_i, delta_j, delta_v, sigmas,
                       transposed=True, bf16=bf16, round_resid=bf16,
                       out_dtype=_BF16 if bf16 else _F32, kernel=kernel)
