"""Build and load the port's hand-written CUDA kernels.

Each kernel source ``amf_tpu_torch/csrc/<name>.cu`` exports a plain C
interface. At first use it is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library under ``build/amf_tpu_torch/`` at the checkout root
and loaded with ``ctypes``. A source may be built for one value of a
parameter at a time (``defines``, as the fused line search is for its
factor width): each set of defines is a library of its own. The library's
file name carries a hash of the source and the flags, so an edited source
is rebuilt and a stale library is never loaded. The build writes to a
temporary file and renames it into place, so concurrent first uses cannot
load a half-written library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "amf_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default."""
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "of amf_tpu_torch are built at first use on a CUDA host"
        )
    return found


def _flags(defines: Tuple[str, ...]) -> Tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def library_path(name: str, defines: Tuple[str, ...] = ()) -> Path:
    """Where the library built from ``csrc/<name>.cu`` with ``defines``
    (``"NAME=value"`` each) lives."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(_flags(defines)).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str, defines: Tuple[str, ...] = ()) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists."""
    out = library_path(name, defines)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [nvcc_path(), *_flags(defines), "-o", tmp,
               str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(
                f"nvcc failed on {name}.cu ({proc.returncode}):\n"
                f"{proc.stderr}{proc.stdout}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.cache
def load(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<name>.cu``."""
    return ctypes.CDLL(str(build(name, defines)))
