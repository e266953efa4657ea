"""Batched small-matrix Cholesky solve-and-sample: CUDA kernel and plain version.

The Gibbs row draws (models/bpmf_gibbs._sample_rows) need, for every row i
of a factor, x_i = S_i^{-1} b_i + L_i^{-T} z_i with S_i = L_i L_i^T a d x d
posterior precision and z_i standard normal. At lookahead width that is
~10^5 independent factor-and-solves per sweep.

The hand-written kernel is ``amf_tpu_torch/csrc/chol_solve_sample.cu`` (it
replaces the JAX package's Pallas kernel
``amf_tpu/ops/chol_kernel.py::chol_solve_sample_tpu``). It computes
x = L^{-T}(L^{-1} b + z): one forward and one back substitution. It has two
entry points, each with a wrapper that counts its launches:

  * ``chol_solve_sample`` takes S, b and z, as the JAX function does.
    ``chol_solve_sample_batch_minor`` launches the kernel on batch-minor
    buffers; ``chol_solve_sample_cuda`` puts (B, d, d) inputs into that
    layout;
  * ``chol_gram_solve_sample`` is what the Gibbs row draws call. It takes
    the masked Gram products in the layout ``ops/gram_kernel`` leaves them
    in, whichever form made them (``Gt``, the packed lower triangle of
    every row's Gram followed by mask @ other, and ``mrt``, both
    row-minor) and the lane's prior and cell, and the kernel assembles S
    and b itself (``chol_gram_solve_sample_cuda``): nothing is transposed,
    unpacked or assembled in PyTorch. A group of threads works each matrix
    (``gram_group`` of them), with its block's rows staged in shared
    memory (``gram_smem_bytes``).

``chol_solve_sample_reference`` is the plain PyTorch version with two back
substitutions, as the JAX reference has; the two differ only in rounding.
``chol_gram_solve_sample_reference`` unpacks the triangle, assembles S and b
with tensor operations and calls it.

Dispatch (both): a CPU tensor goes to the plain version. A CUDA tensor goes
to the kernel, in float32 or float64, from a library built for that d at
its first use (``cuda_build.width_defines``): the S-given entry at any d,
the Gram-fed entry at every d whose block fits the H100's shared memory
(d <= 149 in float32; d <= 77 and 81 <= d <= 104 in float64), and a
wider d raises before anything is built. ``kernel=False``
sends a CUDA tensor to the plain version on purpose, to compare the two on
the same inputs. Where a matrix is not positive definite the plain version
gives NaN on its row, as ``jnp.linalg.cholesky`` does and the kernel does (a
square root of a negative pivot).
"""

from __future__ import annotations

import atexit
import ctypes
import functools
import json
import os
import sys
from typing import Optional, Tuple

import torch

from amf_tpu_torch.utils.linalg import cholesky_or_nan

_SOURCE = "chol_solve_sample"
# The Gram-fed kernel's threads a block (csrc/chol_solve_sample.cu's
# kThreads), and the shared memory a block may have on the H100 (opted in)
THREADS = 128
SMEM_PER_BLOCK = 227 * 1024


def gram_group(d: int) -> int:
    """Threads that share one matrix in the Gram-fed kernel at width d:
    the source's ``coop_group``, a power of two that gives a thread about
    five rows."""
    g = 2
    while g < 32 and 5 * g < d:
        g *= 2
    return g


def gram_smem_bytes(d: int, itemsize: int) -> int:
    """Shared memory a block of the Gram-fed kernel takes at width d
    (the source's ``coop_smem_bytes``): a record of p + 3 d values, at an
    odd stride, for each of its rows, and the lane's p + 2 d constants."""
    p = d * (d + 1) // 2
    rows = THREADS // gram_group(d)
    return itemsize * (rows * ((p + 3 * d) | 1) + p + 2 * d)


def _entry_points(d: int):
    """The C functions, by dtype, of the kernel library that takes width d
    (built at first use)."""
    from amf_tpu_torch.ops import cuda_build

    return _library_fns(cuda_build.width_defines(_SOURCE, d))


@functools.cache
def _library_fns(defines):
    from amf_tpu_torch.ops import cuda_build

    lib = cuda_build.load(_SOURCE, defines)
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fns = {}
    for dtype, suffix in ((torch.float32, "f32"), (torch.float64, "f64")):
        plain = getattr(lib, "amf_chol_solve_sample_" + suffix)
        plain.argtypes = [p] * 4 + [ll, i, p]
        gram = getattr(lib, "amf_chol_gram_solve_sample_" + suffix)
        gram.argtypes = [p] * 12 + [ctypes.c_double] + [ll] * 5 + [i, p]
        plain.restype = gram.restype = i
        fns[dtype] = plain
        fns[dtype, "gram"] = gram
    return fns


def chol_solve_sample_reference(
    S: torch.Tensor, rhs: torch.Tensor, z: torch.Tensor
) -> torch.Tensor:
    """Plain version: S (..., d, d), rhs and z (..., d) -> (..., d); NaN on
    the rows whose S is not positive definite."""
    chol_solve_sample_reference.calls += 1
    L = cholesky_or_nan(S)
    Lt = L.transpose(-1, -2)
    y = torch.linalg.solve_triangular(L, rhs.unsqueeze(-1), upper=False)
    mean = torch.linalg.solve_triangular(Lt, y, upper=True)
    x = torch.linalg.solve_triangular(Lt, z.unsqueeze(-1), upper=True)
    return (mean + x).squeeze(-1)


chol_solve_sample_reference.calls = 0


def chol_solve_sample_batch_minor(
    s_t: torch.Tensor, rhs_t: torch.Tensor, z_t: torch.Tensor
) -> torch.Tensor:
    """Launch the CUDA kernel on batch-minor buffers -> x_t (d, B).

    s_t (d*d, B) holds S_b(i, j) at row i*d + j; rhs_t and z_t are (d, B).
    All contiguous, on one CUDA device, one dtype (float32 or float64),
    d >= 1 (above 32 from a library of that width). The output is
    allocated here; the launch goes on the current stream and does not
    synchronise.
    """
    if rhs_t.dim() != 2:
        raise ValueError(f"want rhs_t (d, B); got {tuple(rhs_t.shape)}")
    d, B = rhs_t.shape
    if s_t.shape != (d * d, B) or z_t.shape != (d, B):
        raise ValueError(f"shape mismatch: s_t {tuple(s_t.shape)}, rhs_t "
                         f"{tuple(rhs_t.shape)}, z_t {tuple(z_t.shape)}")
    if not (s_t.is_cuda and rhs_t.device == s_t.device
            and z_t.device == s_t.device):
        raise ValueError(f"want tensors on one CUDA device; got {s_t.device}, "
                         f"{rhs_t.device}, {z_t.device}")
    if s_t.dtype not in (torch.float32, torch.float64) or not (
            rhs_t.dtype == z_t.dtype == s_t.dtype):
        raise TypeError(f"want one dtype, float32 or float64; got "
                        f"{s_t.dtype}, {rhs_t.dtype}, {z_t.dtype}")
    if not (s_t.is_contiguous() and rhs_t.is_contiguous()
            and z_t.is_contiguous()):
        raise ValueError("want contiguous batch-minor buffers")
    if d < 1:
        raise ValueError(f"chol_solve_sample kernel takes d >= 1; got d={d}")
    out = torch.empty((d, B), dtype=s_t.dtype, device=s_t.device)
    if B == 0:
        return out
    fn = _entry_points(d)[s_t.dtype]
    stream = torch.cuda.current_stream(s_t.device).cuda_stream
    err = fn(s_t.data_ptr(), rhs_t.data_ptr(), z_t.data_ptr(), out.data_ptr(),
             B, d, stream)
    if err:
        raise RuntimeError(f"chol_solve_sample kernel launch failed: CUDA "
                           f"error {err} (B={B}, d={d}, {s_t.dtype})")
    chol_solve_sample_batch_minor.launches += 1
    return out


chol_solve_sample_batch_minor.launches = 0


def chol_solve_sample_cuda(
    S: torch.Tensor, rhs: torch.Tensor, z: torch.Tensor
) -> torch.Tensor:
    """The kernel on S (B, d, d), rhs and z (B, d) -> (B, d).

    Transposes to the kernel's batch-minor layout (so a warp's threads read
    neighbouring addresses) and back.
    """
    if S.dim() != 3 or S.shape[-1] != S.shape[-2]:
        raise ValueError(f"want S (B, d, d); got {tuple(S.shape)}")
    B, d, _ = S.shape
    out = chol_solve_sample_batch_minor(
        S.reshape(B, d * d).t().contiguous(), rhs.t().contiguous(),
        z.t().contiguous())
    return out.t()


def chol_solve_sample(
    S: torch.Tensor, rhs: torch.Tensor, z: torch.Tensor, kernel: bool = True
) -> torch.Tensor:
    """x = S^{-1} rhs + chol(S)^{-T} z for SPD S (..., d, d), rhs, z (..., d).

    A CPU tensor goes to the plain version. A CUDA tensor goes to the CUDA
    kernel, at any d, or to the plain version when ``kernel`` is False.
    """
    if S.device.type == "cpu" or (S.device.type == "cuda" and not kernel):
        return chol_solve_sample_reference(S, rhs, z)
    if S.device.type != "cuda":
        raise ValueError(f"chol_solve_sample runs on cpu or cuda, not {S.device}")
    batch = S.shape[:-2]
    d = S.shape[-1]
    out = chol_solve_sample_cuda(
        S.reshape(-1, d, d), rhs.reshape(-1, d), z.reshape(-1, d))
    return out.reshape(*batch, d)


# ---------------------------------------------------------------------------
# fed from the Gram: what the Gibbs row draws call

Cells = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def tril_pairs(d: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, b) of the packed lower triangle, a >= b, in the kernel's order:
    entry a (a + 1) / 2 + b."""
    a, b = torch.tril_indices(d, d, device=device)
    return a, b


def chol_gram_solve_sample_reference(
    Gt: torch.Tensor, mrt: torch.Tensor, z: torch.Tensor,
    alpha: torch.Tensor, mu: torch.Tensor, beta: float,
    center: Optional[torch.Tensor] = None, cells: Optional[Cells] = None,
    other: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the Gram-fed function -> x (L, r, d).

    Unpacks the triangle, assembles S = alpha + beta G and
    b = beta (mr - center G_o) + alpha mu, adds each lane's cell, and calls
    ``chol_solve_sample_reference``. Arguments as ``chol_gram_solve_sample``.
    """
    L, d, r = mrt.shape
    p = d * (d + 1) // 2
    a, b = tril_pairs(d, Gt.device)
    full = torch.empty((d, d), dtype=torch.long, device=Gt.device)
    full[a, b] = full[b, a] = torch.arange(p, device=Gt.device)
    G = Gt[:, full.reshape(-1)].permute(0, 2, 1).reshape(L, r, d, d)
    S = alpha[:, None] + beta * G
    mr = mrt.mT
    if center is not None:
        mr = mr - center[:, None, None] * Gt[:, p:].mT
    rhs = beta * mr + (alpha @ mu[..., None])[:, None, :, 0]
    if cells is not None:
        row, col, dm, dr = cells
        lane = torch.arange(L, device=Gt.device)
        o = other[lane, col]  # (L, d) the lane cell's factor row
        S[lane, row] += (beta * dm)[:, None, None] * (o[:, :, None] * o[:, None, :])
        shift = dr if center is None else dr - dm * center
        rhs[lane, row] += (beta * shift)[:, None] * o
    return chol_solve_sample_reference(S, rhs, z)


def chol_gram_solve_sample_cuda(
    Gt: torch.Tensor, mrt: torch.Tensor, z: torch.Tensor,
    alpha: torch.Tensor, mu: torch.Tensor, beta: float,
    center: Optional[torch.Tensor] = None, cells: Optional[Cells] = None,
    other: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the Gram-fed CUDA kernel -> x (L, r, d), contiguous.

    Arguments as ``chol_gram_solve_sample``; all on one CUDA device in one
    dtype, float32 or float64; Gt and mrt contiguous; d >= 1. z (and,
    with cells, other) may have any lane stride but contiguous (rows, d)
    slabs. One launch on the current stream, no synchronisation; the output
    is allocated here.
    """
    if mrt.dim() != 3 or Gt.dim() != 3:
        raise ValueError(f"want Gt (L, p + d, r) and mrt (L, d, r); got "
                         f"{tuple(Gt.shape)}, {tuple(mrt.shape)}")
    L, d, r = mrt.shape
    p = d * (d + 1) // 2
    if (tuple(Gt.shape) != (L, p + d, r) or tuple(z.shape) != (L, r, d)
            or tuple(alpha.shape) != (L, d, d) or tuple(mu.shape) != (L, d)):
        raise ValueError(f"shape mismatch: Gt {tuple(Gt.shape)}, mrt "
                         f"{tuple(mrt.shape)}, z {tuple(z.shape)}, alpha "
                         f"{tuple(alpha.shape)}, mu {tuple(mu.shape)}")
    small = [alpha, mu] + ([] if center is None else [center])
    floats = [Gt, mrt, z, *small]
    ints = []
    if cells is not None:
        if other is None or other.dim() != 3 or other.shape[0] != L or (
                other.shape[2] != d):
            raise ValueError("cells need other (L, c, d)")
        row, col, dm, dr = cells
        floats += [other, dm, dr]
        ints = [row, col]
    dev = Gt.device
    if dev.type != "cuda" or any(x.device != dev for x in floats + ints):
        raise ValueError("chol_gram_solve_sample kernel: want every tensor "
                         "on one CUDA device")
    if Gt.dtype not in (torch.float32, torch.float64) or any(
            x.dtype != Gt.dtype for x in floats):
        raise TypeError("want one dtype, float32 or float64; got "
                        + ", ".join(str(x.dtype) for x in floats))
    if not (Gt.is_contiguous() and mrt.is_contiguous()):
        raise ValueError("want contiguous Gt and mrt")
    if d < 1:
        raise ValueError(f"chol_gram_solve_sample kernel takes d >= 1; got "
                         f"d={d}")
    smem = gram_smem_bytes(d, Gt.element_size())
    if smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"chol_gram_solve_sample kernel: at d={d} a block's rows need "
            f"{smem} bytes of shared memory in {Gt.dtype}, more than the "
            f"{SMEM_PER_BLOCK} a block may have; it takes d <= 149 in "
            f"float32, and d <= 77 or 81 <= d <= 104 in float64")

    def slabs(x):  # contiguous (rows, d) a lane, any lane stride
        ok = x.stride(2) == 1 and x.stride(1) == d
        return x if ok else x.contiguous()

    out = torch.empty((L, r, d), dtype=Gt.dtype, device=dev)
    if L == 0 or r == 0:
        return out
    z = slabs(z)
    alpha, mu = alpha.contiguous(), mu.contiguous()
    ptr = dict(center=0, other=0, row=0, col=0, dm=0, dr=0)
    c = other_lane = 1
    if center is not None:
        center = center.contiguous()
        ptr["center"] = center.data_ptr()
    if cells is not None:
        other = slabs(other)
        c, other_lane = other.shape[1], other.stride(0)
        # kept alive until the launch is enqueued
        row, col, dm, dr = (row.long().contiguous(), col.long().contiguous(),
                            dm.contiguous(), dr.contiguous())
        ptr.update(other=other.data_ptr(), row=row.data_ptr(),
                   col=col.data_ptr(), dm=dm.data_ptr(), dr=dr.data_ptr())
    fn = _entry_points(d)[Gt.dtype, "gram"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(Gt.data_ptr(), mrt.data_ptr(), z.data_ptr(), alpha.data_ptr(),
             mu.data_ptr(), ptr["center"], ptr["other"], ptr["row"],
             ptr["col"], ptr["dm"], ptr["dr"], out.data_ptr(), float(beta),
             L, r, c, z.stride(0), other_lane, d, stream)
    if err:
        raise RuntimeError(f"chol_gram_solve_sample kernel launch failed: "
                           f"CUDA error {err} (L={L}, r={r}, d={d}, "
                           f"{Gt.dtype})")
    chol_gram_solve_sample_cuda.launches += 1
    return out


chol_gram_solve_sample_cuda.launches = 0


def chol_gram_solve_sample(
    Gt: torch.Tensor, mrt: torch.Tensor, z: torch.Tensor,
    alpha: torch.Tensor, mu: torch.Tensor, beta: float,
    center: Optional[torch.Tensor] = None, cells: Optional[Cells] = None,
    other: Optional[torch.Tensor] = None, kernel: bool = True,
) -> torch.Tensor:
    """Every lane's row draws from their masked Gram -> x (L, r, d).

    For lane l and row i, with S = alpha_l + beta G and
    b = beta (mr - center_l G_o) + alpha_l mu_l, x = S^{-1} b + chol(S)^{-T} z.
    Gt (L, p + d, r): entry a (a + 1) / 2 + b (a >= b) of row i's Gram
    sum_j mask_ij o_ja o_jb, p = d (d + 1) / 2 of them, then the d values
    G_o = sum_j mask_ij o_j; mrt (L, d, r): sum_j mask_ij r_ij o_j. z
    (L, r, d) standard normals, alpha (L, d, d), mu (L, d), ``center`` (L,)
    or None. ``cells`` = (row, col, dm, dr), each (L,), adds lane l's one
    cell with o = other[l, col]: S += beta dm o o^T and
    b += beta (dr - dm center) o on row ``row``; ``other`` (L, c, d) is read
    only then.

    A CPU tensor goes to the plain version. A CUDA tensor goes to the CUDA
    kernel, at any d, or to the plain version when ``kernel`` is False.
    """
    if Gt.device.type == "cpu" or (Gt.device.type == "cuda" and not kernel):
        fn = chol_gram_solve_sample_reference
    elif Gt.device.type == "cuda":
        fn = chol_gram_solve_sample_cuda
    else:
        raise ValueError(f"chol_gram_solve_sample runs on cpu or cuda, not "
                         f"{Gt.device}")
    return fn(Gt, mrt, z, alpha, mu, beta, center, cells, other)


def launch_counts() -> dict:
    """This process's counts: launches of the two entry points and calls of
    the plain version."""
    return {"gram_fed": chol_gram_solve_sample_cuda.launches,
            "s_given": chol_solve_sample_batch_minor.launches,
            "plain": chol_solve_sample_reference.calls}


def _append_counts(path: str) -> None:
    with open(path, "a") as f:
        f.write(json.dumps({"argv": sys.argv, **launch_counts()}) + "\n")


# A program that runs the port's CLIs as processes of their own (the
# experiment runner does) reads their counts from the file this variable
# names: every process that imports this module appends one JSON line of
# ``launch_counts()`` and its argv to it when it exits.
COUNTS_FILE_ENV = "AMF_TORCH_CHOL_COUNTS"
if os.environ.get(COUNTS_FILE_ENV):
    atexit.register(_append_counts, os.environ[COUNTS_FILE_ENV])
