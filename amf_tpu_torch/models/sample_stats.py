"""Prediction statistics over factor draws, shared by the NUTS BPMF path
(mirrors ``amf_tpu/models/sample_stats.py``).

Reference analogues: predict / pred_variance / prob_ge_cutoff over sample
lists (bayes_pmf.py:433-542, stan-bpmf/bpmf.py:346-478). Draws are
streamed one at a time, so no (num_samps, n, m) tensor is formed. Every
function takes draws with leading lane dimensions, (..., S, rows, d), and a
mean rating per lane.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from amf_tpu_torch.models.bpmf_gibbs import PredStats
from amf_tpu_torch.utils.linalg import cholesky_or_nan


def _shift(mean_rating, subtract_mean: bool, like: torch.Tensor,
           lead: Tuple[int, ...]) -> torch.Tensor:
    """The per-lane offset added to every prediction, (..., 1, 1)."""
    if not subtract_mean:
        return torch.zeros(lead + (1, 1), dtype=like.dtype, device=like.device)
    mr = torch.as_tensor(mean_rating, dtype=like.dtype, device=like.device)
    return mr.expand(lead).reshape(lead + (1, 1))


def prediction_stats(
    U_samps: torch.Tensor,  # (..., S, n, d)
    V_samps: torch.Tensor,  # (..., S, m, d)
    mean_rating,
    subtract_mean: bool,
    cutoffs: Tuple[float, ...] = (),
    value_bounds: Optional[Tuple[float, ...]] = None,
) -> PredStats:
    """Mean, variance (ddof 0), P(pred >= cutoff) and the value-bin counts
    of the predicted matrix over the draws."""
    *lead, S, n, _ = U_samps.shape
    lead = tuple(lead)
    m = V_samps.shape[-2]
    dtype, device = U_samps.dtype, U_samps.device
    shift = _shift(mean_rating, subtract_mean, U_samps, lead)
    n_cut = len(cutoffs)
    cut = torch.as_tensor(cutoffs, dtype=dtype, device=device).reshape(
        n_cut, 1, 1)
    n_bins = 0
    if value_bounds is not None:
        edges = torch.as_tensor(np.asarray(value_bounds), dtype=dtype,
                                device=device)
        n_bins = edges.shape[0] - 1
        lo, hi = edges[:-1, None, None], edges[1:, None, None]

    s1 = torch.zeros(lead + (n, m), dtype=dtype, device=device)
    s2 = torch.zeros_like(s1)
    ge = torch.zeros(lead + (n_cut, n, m), dtype=dtype, device=device)
    bins = torch.zeros(lead + (n_bins, n, m), dtype=dtype, device=device)
    for s in range(S):
        pred = U_samps[..., s, :, :] @ V_samps[..., s, :, :].mT
        if subtract_mean:
            pred = pred + shift
        s1 += pred
        s2 += pred * pred
        if n_cut:
            ge += (pred[..., None, :, :] >= cut).to(dtype)
        if n_bins:
            p = pred[..., None, :, :]
            bins += ((p >= lo) & (p < hi)).to(dtype)
    mean = s1 / S
    var = torch.clamp(s2 / S - mean ** 2, min=0.0)
    return PredStats(mean=mean, var=var, prob_ge=ge / S,
                     bin_counts=bins if n_bins else None)


def _solve_with(chol: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    y = torch.linalg.solve_triangular(chol, x, upper=False)
    return torch.linalg.solve_triangular(chol.mT, y, upper=True)


def matrix_normal_mle_from_factors(
    U_samps: torch.Tensor,  # (..., S, n, d)
    V_samps: torch.Tensor,  # (..., S, m, d)
    mean_rating,
    subtract_mean: bool,
    eps: float = 1e-3,
    max_steps: int = 1000,
    jitter: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """MLE (mean, row covariance, column covariance) of a matrix normal over
    the prediction draws by Dutilleul's flip-flop iteration (reference:
    stan-bpmf/bpmf.matrix_normal_mle :86-172), per lane.

    Lanes iterate together; a lane whose updates fell below ``eps`` keeps
    its covariances while the others go on (the JAX package's vmapped
    while loop). The normalisations 1/(S m) and 1/(S n) are Dutilleul's,
    which the reference's loop omits (see the JAX package). A Cholesky
    factor is taken after a jitter of ``jitter`` times the mean diagonal;
    where it still fails it is NaN, and the lane stops.
    """
    *lead, S, n, _ = U_samps.shape
    lead = tuple(lead)
    m = V_samps.shape[-2]
    dtype, device = U_samps.dtype, U_samps.device
    shift = _shift(mean_rating, subtract_mean, U_samps, lead)

    def scan_preds(f, init):
        acc = init
        for s in range(S):
            pred = U_samps[..., s, :, :] @ V_samps[..., s, :, :].mT + shift
            acc = f(acc, pred)
        return acc

    mean = scan_preds(lambda c, p: c + p,
                      torch.zeros(lead + (n, m), dtype=dtype,
                                  device=device)) / S

    def safe_cho(a):
        k = a.shape[-1]
        tr = torch.diagonal(a, dim1=-2, dim2=-1).sum(-1)
        eye = torch.eye(k, dtype=dtype, device=device)
        return cholesky_or_nan(a + (jitter * tr / k)[..., None, None] * eye)

    def centred_outer(c, p):
        x = p - mean
        return c + x @ x.mT

    u = scan_preds(centred_outer, torch.zeros(lead + (n, n), dtype=dtype,
                                              device=device)) / (S * m)
    v = torch.eye(m, dtype=dtype, device=device).expand(lead + (m, m))
    active = torch.ones(lead, dtype=torch.bool, device=device)
    du = torch.full(lead, torch.inf, dtype=dtype, device=device)
    dv = du.clone()
    for _ in range(max_steps):
        active = active & ((du > eps) | (dv > eps))
        if not bool(active.any()):
            break
        u_ch = safe_cho(u)
        v_new = scan_preds(
            lambda c, p: c + (p - mean).mT @ _solve_with(u_ch, p - mean),
            torch.zeros(lead + (m, m), dtype=dtype, device=device)) / (S * n)
        v_ch = safe_cho(v_new)
        u_new = scan_preds(
            lambda c, p: c + (p - mean) @ _solve_with(v_ch, (p - mean).mT),
            torch.zeros(lead + (n, n), dtype=dtype, device=device)) / (S * m)
        keep = active[..., None, None]
        du = torch.where(active, torch.linalg.matrix_norm(u_new - u), du)
        dv = torch.where(active, torch.linalg.matrix_norm(v_new - v), dv)
        u = torch.where(keep, u_new, u)
        v = torch.where(keep, v_new, v)
    return mean, u, v


def entropy_est_from_factors(U_samps, V_samps, mean_rating, subtract_mean,
                             eps: float = 1e-3) -> torch.Tensor:
    """Matrix-normal entropy estimate of the prediction distribution, per
    lane (reference: stan-bpmf/bpmf.entropy_est :369-390, up to
    constants)."""
    n = U_samps.shape[-2]
    m = V_samps.shape[-2]
    _, u, v = matrix_normal_mle_from_factors(U_samps, V_samps, mean_rating,
                                             subtract_mean, eps=eps)
    logdet_u = torch.linalg.slogdet(u).logabsdet
    logdet_v = torch.linalg.slogdet(v).logabsdet
    return (m * logdet_u + n * logdet_v) / 2
