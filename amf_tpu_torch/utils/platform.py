"""Device and precision policy for the port's entry points.

Every entry point takes an explicit ``device`` and resolves it here. The
policy:

  * ``None`` means ``cuda``, the current CUDA card; on a host without one
    it raises, as naming ``cuda`` does. The CPU runs only when it is named
    (``device="cpu"``, ``--device cpu``), as the tests do;
  * TF32 is off for matmuls and cuDNN on every path, so float32 products
    run in full float32 on the card as they do on the CPU;
  * float64 runs where it is asked for, the card included (the H100 has
    native f64), unlike the JAX package, which pinned f64 runs to the CPU
    because its TPU has no f64.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device to run on, with the precision policy applied."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"amf_tpu_torch runs on cpu or cuda, not {dev}")
    return dev


def setup(use_x64: bool, device=None) -> Tuple[torch.device, torch.dtype]:
    """Resolve the device for a run; returns (device, float dtype)."""
    return resolve_device(device), torch.float64 if use_x64 else torch.float32
