"""Batched small-matrix Cholesky solve-and-sample: CUDA kernel and plain version.

The Gibbs row draws (models/bpmf_gibbs._sample_rows) need, for every row i
of a factor, x_i = S_i^{-1} b_i + L_i^{-T} z_i with S_i = L_i L_i^T a d x d
posterior precision and z_i standard normal. At lookahead width that is
~10^5 independent factor-and-solves per sweep.

``chol_solve_sample_batch_minor`` launches the hand-written kernel in
``amf_tpu_torch/csrc/chol_solve_sample.cu`` (it replaces the JAX package's
Pallas kernel ``amf_tpu/ops/chol_kernel.py::chol_solve_sample_tpu``) and
counts its launches; ``chol_solve_sample_cuda`` puts (B, d, d) inputs into
its layout. It computes x = L^{-T}(L^{-1} b + z): one forward and one back
substitution.
``chol_solve_sample_reference`` is the plain PyTorch version with two back
substitutions, as the JAX reference has; the two differ only in rounding.

Dispatch (``chol_solve_sample``): a CPU tensor goes to the plain version. A
CUDA tensor goes to the kernel, in float32 or float64, for d <= 32; d > 32
raises. ``kernel=False`` sends a CUDA tensor to the plain version on
purpose, to compare the two on the same inputs.
"""

from __future__ import annotations

import ctypes
import functools

import torch

MAX_D = 32
_SOURCE = "chol_solve_sample"


@functools.cache
def _entry_points():
    """The kernel library's C functions by dtype (built at first use)."""
    from amf_tpu_torch.ops import cuda_build

    lib = cuda_build.load(_SOURCE)
    fns = {
        torch.float32: lib.amf_chol_solve_sample_f32,
        torch.float64: lib.amf_chol_solve_sample_f64,
    }
    for fn in fns.values():
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fns


def chol_solve_sample_reference(
    S: torch.Tensor, rhs: torch.Tensor, z: torch.Tensor
) -> torch.Tensor:
    """Plain version: S (..., d, d), rhs and z (..., d) -> (..., d)."""
    chol_solve_sample_reference.calls += 1
    L = torch.linalg.cholesky(S)
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
    1 <= d <= 32. The output is allocated here; the launch goes on the
    current stream and does not synchronise.
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
    if not 1 <= d <= MAX_D:
        raise ValueError(f"chol_solve_sample kernel takes 1 <= d <= {MAX_D}; "
                         f"got d={d}")
    out = torch.empty((d, B), dtype=s_t.dtype, device=s_t.device)
    if B == 0:
        return out
    fn = _entry_points()[s_t.dtype]
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
    kernel, or to the plain version when ``kernel`` is False.
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
