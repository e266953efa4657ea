"""Factorisations that give NaN where they fail, as ``jnp.linalg`` does.

``torch.linalg.cholesky`` and ``inv`` raise on a matrix they cannot factor
(and wait for the host to find out); their ``_ex`` forms return unchecked
values and an ``info`` code. JAX returns NaN there, and NaN is what the
port's callers expect to reach the scores and the driver's finite-score
fallback (``active/driver.py``). Decided on the device: the host does not
wait for ``info``.
"""

from __future__ import annotations

import torch


def nan_where_failed(out: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    """``out`` (..., d, d) of a ``torch.linalg.*_ex`` call, NaN where its
    ``info`` reports a failed factorisation."""
    return torch.where((info > 0)[..., None, None], torch.nan, out)


def cholesky_or_nan(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of A (..., d, d); NaN where A is not positive
    definite."""
    return nan_where_failed(*torch.linalg.cholesky_ex(A))


def inverse_or_nan(A: torch.Tensor) -> torch.Tensor:
    """Inverse of A (..., d, d); NaN where A is singular."""
    return nan_where_failed(*torch.linalg.inv_ex(A))
