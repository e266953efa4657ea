"""Expectation weights for continuous one-step lookahead integration
(mirrors ``normal_trapezoid_grid`` of ``amf_tpu/ops/quadrature.py``)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def normal_trapezoid_grid(num_pts: int) -> Tuple[np.ndarray, np.ndarray]:
    """Standard-normal quantile grid + trapezoid weights (reference:
    stan-bpmf/bpmf.py:505-510 — ``np.trapz(evals * dist.pdf(pts), pts)``
    over ppf(linspace(.001, .999))).

    Under the substitution pts = mu + sigma z the weights reduce to the
    candidate-independent c_k * phi(z_k) returned here: integrate any
    per-cell normal by evaluating at mu + sigma * z and dotting with w.
    """
    from scipy import stats as sp_stats

    z = sp_stats.norm.ppf(np.linspace(0.001, 0.999, num_pts))
    c = np.empty_like(z)
    c[1:-1] = (z[2:] - z[:-2]) / 2
    c[0] = (z[1] - z[0]) / 2
    c[-1] = (z[-1] - z[-2]) / 2
    return z, c * sp_stats.norm.pdf(z)
