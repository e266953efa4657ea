"""ctypes bindings for the native host kernels (``kernels.cc``; mirrors
``amf_tpu/_native``).

Host C++ over numpy arrays: the reference's MEX sparse kernels
(spouterprod, sprowsumprod, sprowcolsum), a COO-to-dense packer and a
masked RMSE. No path of the port calls them; they are a host fast path
and an oracle for the maxent sums (``models/ratingconc.py``).

The library is built by ``g++ -O3`` at first use into
``build/amf_tpu_torch/`` at the checkout root, under a name that carries a
hash of the source and the flags, so an edited source is rebuilt and a
stale library is never loaded; the build writes a temporary file and
renames it into place. ``available()`` is False where no compiler is
found, and then every function raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "kernels.cc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "amf_tpu_torch"
_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None

_c_i64 = ctypes.c_int64
_p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def library_path() -> Path:
    """Where the library built from this source and these flags lives."""
    h = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode())
    return _BUILD_DIR / f"libamfnative-{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", tmp], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        path = library_path()
        if not path.exists():
            try:
                _build(path)
            except FileNotFoundError as exc:  # no g++
                _build_error = str(exc)
                return None
            except subprocess.CalledProcessError as exc:
                _build_error = exc.stderr
                return None
        lib = ctypes.CDLL(str(path))
        lib.amf_spouterprod.argtypes = [
            _c_i64, _p_i64, _p_i64, _p_f64, _p_f64, ctypes.c_double, _p_f64]
        lib.amf_spouterprod.restype = None
        lib.amf_sprowsumprod.argtypes = [
            _c_i64, _c_i64, _c_i64, _p_i64, _p_i64, _p_f64, _p_f64, _p_f64,
            _p_f64]
        lib.amf_sprowsumprod.restype = None
        lib.amf_sprowcolsum.argtypes = [
            _c_i64, _c_i64, _p_i64, _p_i64, _p_f64, _p_f64, _p_f64]
        lib.amf_sprowcolsum.restype = None
        lib.amf_coo_to_dense.argtypes = [
            _c_i64, _c_i64, _c_i64, _p_f64, _p_f64, _p_u8]
        lib.amf_coo_to_dense.restype = _c_i64
        lib.amf_masked_rmse.argtypes = [_c_i64, _p_f64, _p_f64, _p_u8]
        lib.amf_masked_rmse.restype = ctypes.c_double
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library is built (or builds now) and loads."""
    return _load() is not None


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native library did not build: {_build_error}")
    return lib


def _coo(i_idx, j_idx, n: int, m: int):
    i_idx = np.ascontiguousarray(i_idx, np.int64)
    j_idx = np.ascontiguousarray(j_idx, np.int64)
    if i_idx.shape != j_idx.shape or i_idx.ndim != 1:
        raise ValueError("i_idx and j_idx must be 1-D of one length")
    if i_idx.size and not (0 <= i_idx.min() and i_idx.max() < n
                           and 0 <= j_idx.min() and j_idx.max() < m):
        raise ValueError(f"indices out of range for a ({n}, {m}) matrix")
    return i_idx, j_idx


def spouterprod(i_idx, j_idx, u, v, clamp: float = 1e128) -> np.ndarray:
    """u[i] * v[j] at each entry (i, j), clamped above at ``clamp``
    (reference: spouterprod.c:47-120)."""
    lib = _lib_or_raise()
    u = np.ascontiguousarray(u, np.float64)
    v = np.ascontiguousarray(v, np.float64)
    i_idx, j_idx = _coo(i_idx, j_idx, u.shape[0], v.shape[0])
    out = np.empty(i_idx.shape[0], np.float64)
    lib.amf_spouterprod(i_idx.shape[0], i_idx, j_idx, u, v, clamp, out)
    return out


def sprowsumprod(i_idx, j_idx, p, F, n: int, m: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Row and column sums of the entries' ``p @ F`` rows: (n, K) and
    (m, K) (reference: sprowsumprod.c:6-60)."""
    lib = _lib_or_raise()
    i_idx, j_idx = _coo(i_idx, j_idx, n, m)
    p = np.ascontiguousarray(p, np.float64)
    F = np.ascontiguousarray(F, np.float64)
    nnz, S = p.shape
    if nnz != i_idx.shape[0] or F.shape[0] != S:
        raise ValueError(f"p {p.shape} and F {F.shape} do not match "
                         f"{i_idx.shape[0]} entries")
    K = F.shape[1]
    rowsum = np.zeros((n, K), np.float64)
    colsum = np.zeros((m, K), np.float64)
    lib.amf_sprowsumprod(nnz, S, K, i_idx, j_idx, p, F, rowsum, colsum)
    return rowsum, colsum


def sprowcolsum(i_idx, j_idx, E, n: int, m: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Row and column sums of the entries' rows of E: (n, K) and (m, K)
    (reference: sprowcolsum.c)."""
    lib = _lib_or_raise()
    i_idx, j_idx = _coo(i_idx, j_idx, n, m)
    E = np.ascontiguousarray(E, np.float64)
    nnz, K = E.shape
    if nnz != i_idx.shape[0]:
        raise ValueError(f"E {E.shape} does not match {i_idx.shape[0]} "
                         "entries")
    rowsum = np.zeros((n, K), np.float64)
    colsum = np.zeros((m, K), np.float64)
    lib.amf_sprowcolsum(nnz, K, i_idx, j_idx, E, rowsum, colsum)
    return rowsum, colsum


def coo_to_dense(ratings, n: int, m: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """(values, mask, n_duplicates) from a (nnz, 3) [i, j, value] array;
    a cell given twice keeps its last value."""
    lib = _lib_or_raise()
    ratings = np.ascontiguousarray(ratings, np.float64)
    if ratings.ndim != 2 or ratings.shape[1] != 3:
        raise ValueError(f"ratings must be (nnz, 3), not {ratings.shape}")
    _coo(ratings[:, 0].astype(np.int64), ratings[:, 1].astype(np.int64), n, m)
    values = np.zeros((n, m), np.float64)
    mask = np.zeros((n, m), np.uint8)
    dups = lib.amf_coo_to_dense(ratings.shape[0], n, m, ratings, values, mask)
    return values, mask.astype(bool), int(dups)


def masked_rmse(pred, target, mask) -> float:
    """RMSE of ``pred`` against ``target`` over the cells of ``mask``."""
    lib = _lib_or_raise()
    pred = np.ascontiguousarray(pred, np.float64).ravel()
    target = np.ascontiguousarray(target, np.float64).ravel()
    mask = np.ascontiguousarray(mask, np.uint8).ravel()
    if not pred.shape == target.shape == mask.shape:
        raise ValueError("pred, target and mask must have one size")
    return float(lib.amf_masked_rmse(pred.shape[0], pred, target, mask))
