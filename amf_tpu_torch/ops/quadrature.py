"""Expectation weights for one-step lookahead integration
(mirrors ``amf_tpu/ops/quadrature.py``).

Reference analogues (active_pmf._exp_with_rij:635-704, stan-bpmf
_integrate_lookahead:483-521):
  * discrete 'sum': weights = CDF-bin masses of a predictive normal between
    rating-value midpoints;
  * discrete 'simps': Simpson integration of evals * pdf over the values;
  * continuous: expectation over a +-2 sigma window on fixed Gauss-Legendre
    nodes (the reference uses scipy's adaptive ``stats.norm.expect``);
  * the Gibbs family's continuous lookahead: a trapezoid over a
    standard-normal quantile grid.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def norm_cdf(x, loc: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """CDF of N(loc, scale^2) at x (``jax.scipy.stats.norm.cdf``)."""
    return torch.special.ndtr((x - loc) / scale)


def norm_sf(x, loc: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Survival function of N(loc, scale^2) at x (``norm.sf``)."""
    return torch.special.ndtr((loc - x) / scale)


def norm_pdf(x, loc: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Density of N(loc, scale^2) at x (``norm.pdf``)."""
    y = (x - loc) / scale
    return torch.exp(-0.5 * y * y) / (math.sqrt(2 * math.pi) * scale)


def discrete_weights(mean: torch.Tensor, std: torch.Tensor,
                     bounds: np.ndarray) -> torch.Tensor:
    """Per-rating-value probability masses: diff of normal CDFs at the
    midpoint bounds (reference: active_pmf.py:687-689). Broadcasts over any
    leading shape of mean/std; returns shape mean.shape + (n_values,)."""
    b = torch.as_tensor(np.asarray(bounds), dtype=mean.dtype,
                        device=mean.device)
    cdfs = norm_cdf(b, mean[..., None], std[..., None].clamp(min=1e-12))
    return torch.diff(cdfs, dim=-1)


def simpson_weights(mean: torch.Tensor, std: torch.Tensor,
                    values: np.ndarray) -> torch.Tensor:
    """Simpson-rule weights over the discrete rating values: integrates
    evals(v) * pdf(v) dv (reference 'simps' mode: active_pmf.py:682-684)."""
    v = np.asarray(values, dtype=np.float64)
    n = v.size
    # composite Simpson coefficients on (possibly non-uniform) points via
    # per-interval Simpson on pairs; trapezoid when n is even
    w = np.zeros(n)
    if n >= 3 and n % 2 == 1:
        for k in range(0, n - 2, 2):
            h0 = v[k + 1] - v[k]
            h1 = v[k + 2] - v[k + 1]
            c = (h0 + h1) / 6.0
            w[k] += c * (2 - h1 / h0)
            w[k + 1] += c * (h0 + h1) ** 2 / (h0 * h1)
            w[k + 2] += c * (2 - h0 / h1)
    else:
        w[:-1] += np.diff(v) / 2
        w[1:] += np.diff(v) / 2

    def tensor(x):
        return torch.as_tensor(x, dtype=mean.dtype, device=mean.device)

    pdfs = norm_pdf(tensor(v), mean[..., None],
                    std[..., None].clamp(min=1e-12))
    return tensor(w) * pdfs


def gauss_legendre_nodes(mean: torch.Tensor, std: torch.Tensor,
                         n_nodes: int = 16
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nodes and weights for E[f(X)] over X ~ N(mean, std^2) restricted to
    +-2 sigma (the reference's continuous window, active_pmf.py:694-699).

    Returns (points, weights) with shape mean.shape + (n_nodes,); the
    integral estimate is sum(f(points) * weights, -1).
    """
    x, w = np.polynomial.legendre.leggauss(n_nodes)
    x = torch.as_tensor(x, dtype=mean.dtype, device=mean.device)
    w = torch.as_tensor(w, dtype=mean.dtype, device=mean.device)
    half = 2.0 * std[..., None]
    pts = mean[..., None] + half * x
    wts = w * half * norm_pdf(pts, mean[..., None], std[..., None])
    return pts, wts


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
