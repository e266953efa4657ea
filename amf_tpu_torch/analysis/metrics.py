"""Evaluation metrics (mirrors ``amf_tpu/analysis/metrics.py``).

Reference analogues: ``rmse``/``rmse_on`` (python-pmf/pmf.py:16-20),
``binary_misclassification`` (stan-bpmf/bpmf.py:53-54).
"""

from __future__ import annotations

import torch


def rmse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean((pred - target) ** 2))


def rmse_on(pred: torch.Tensor, target: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """RMSE over cells where ``mask`` is true."""
    d2 = torch.where(mask, (pred - target) ** 2, 0.0)
    cnt = mask.sum().clamp(min=1)
    return torch.sqrt(d2.sum() / cnt)


def binary_misclassification(pred: torch.Tensor, target: torch.Tensor,
                             mask=None) -> torch.Tensor:
    """Fraction of cells whose predicted sign disagrees with the target."""
    miss = torch.sign(pred) != target
    if mask is None:
        return miss.to(pred.dtype).mean()
    cnt = mask.sum().clamp(min=1)
    return torch.where(mask, miss, False).sum() / cnt
