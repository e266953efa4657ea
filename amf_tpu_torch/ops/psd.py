"""PSD projection (mirrors ``amf_tpu/ops/psd.py``).

Reference analogue: ``project_psd`` (python-pmf/active_pmf.py:36-50;
stan-bpmf/bpmf.py:57-82): symmetrize, clamp the eigenvalue spectrum at
``min_eig``, re-symmetrize. The reference's "only project if the minimum
eigenvalue is negative" short-circuit becomes an unconditional reconstruct
(identical result, no data-dependent branch). Batched over any leading
dimensions: one ``torch.linalg.eigh`` for every lane's matrix.
"""

from __future__ import annotations

import torch


def project_psd(mat: torch.Tensor, min_eig: float = 0.0) -> torch.Tensor:
    """Project real matrices (..., k, k) to the symmetric PSD cone
    (eigenvalue clamp)."""
    mat = (mat + mat.mT) / 2
    vals, vecs = torch.linalg.eigh(mat)
    out = (vecs * vals.clamp(min=min_eig)[..., None, :]) @ vecs.mT
    return (out + out.mT) / 2
