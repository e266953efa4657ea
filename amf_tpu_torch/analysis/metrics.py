"""Evaluation metrics (mirrors ``amf_tpu/analysis/metrics.py``).

Reference analogues: ``rmse``/``rmse_on`` (python-pmf/pmf.py:16-20),
``binary_misclassification`` (stan-bpmf/bpmf.py:53-54), hand-rolled ROC/AUC
(plot_results.py:57-86). The first three take tensors; the rest are the
JAX package's host-side numpy and scipy functions, carried as they are.
"""

from __future__ import annotations

import numpy as np
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


def auc_roc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Area under the ROC curve for binary labels.

    Host-side (numpy): equivalent to the reference's hand-rolled
    ``auc_roc`` (plot_results.py:57-86) but computed via the rank statistic.
    """
    scores = np.asarray(scores, dtype=np.float64).ravel()
    labels = np.asarray(labels).ravel().astype(bool)
    n_pos = labels.sum()
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    # average ranks for ties
    sorted_scores = scores[order]
    ranks[order] = np.arange(1, scores.size + 1)
    # tie correction: average rank within equal-score groups
    uniq, inv, counts = np.unique(
        sorted_scores, return_inverse=True, return_counts=True
    )
    if uniq.size != scores.size:
        start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        avg = start + (counts + 1) / 2.0
        ranks[order] = avg[inv]
    return float((ranks[labels].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def kendall_tau(a: np.ndarray, b: np.ndarray) -> float:
    """Kendall rank-correlation between two criterion maps (NaNs ignored).

    The reference uses this to check agreement between first-step criterion
    maps of independent implementations (compare_firsts.py:133-151) — the same
    methodology our parity tests use against numpy oracles.
    """
    from scipy import stats

    a = np.asarray(a, dtype=np.float64).ravel()
    b = np.asarray(b, dtype=np.float64).ravel()
    ok = np.isfinite(a) & np.isfinite(b)
    if ok.sum() < 2:
        return float("nan")
    # tuple form: .statistic only exists on scipy >= 1.9
    return float(stats.kendalltau(a[ok], b[ok])[0])


def area_under_curve(xs: np.ndarray, ys: np.ndarray) -> float:
    """Trapezoidal area under a learning curve (plot_aucs.py analogue)."""
    xs = np.asarray(xs, dtype=np.float64)
    ys = np.asarray(ys, dtype=np.float64)
    trap = getattr(np, "trapezoid", None) or np.trapz
    return float(trap(ys, xs))


def split_rhat(draws: np.ndarray) -> np.ndarray:
    """Split-chain potential scale reduction (Gelman-Rubin R-hat).

    draws: (n_chains, n_samples) or (n_chains, n_samples, dim) — each chain
    is split in half (catching within-chain nonstationarity, the Stan manual
    convention), then R-hat = sqrt(((n-1)/n * W + B/n) / W). Values near 1
    indicate mixing; > ~1.05 is suspect. Reference analogue: Stan printed
    these in its sampler output (captured but unparsed,
    rstan_interface.py:69-113); the rebuild makes them first-class.
    """
    x = np.asarray(draws, dtype=np.float64)
    if x.ndim == 1:
        x = x[None]
    scalar = x.ndim == 2
    if scalar:
        x = x[..., None]
    c, n, dim = x.shape
    half = n // 2
    x = np.concatenate([x[:, :half], x[:, half: 2 * half]], axis=0)
    c, n = 2 * c, half
    mean_c = x.mean(axis=1)  # (c, dim)
    var_c = x.var(axis=1, ddof=1)  # (c, dim)
    W = var_c.mean(axis=0)
    B = n * mean_c.var(axis=0, ddof=1)
    W = np.maximum(W, 1e-300)
    rhat = np.sqrt(((n - 1) / n * W + B / n) / W)
    return float(rhat[0]) if scalar else rhat


def ess(draws: np.ndarray) -> np.ndarray:
    """Effective sample size via Geyer's initial-monotone-positive-sequence
    autocorrelation truncation (the Stan estimator's core), pooled over
    chains.

    draws: (n_chains, n_samples) or (n_chains, n_samples, dim).
    """
    x = np.asarray(draws, dtype=np.float64)
    if x.ndim == 1:
        x = x[None]
    scalar = x.ndim == 2
    if scalar:
        x = x[..., None]
    c, n, dim = x.shape
    out = np.empty(dim)
    for k in range(dim):
        chains = x[:, :, k]
        chains = chains - chains.mean(axis=1, keepdims=True)
        # per-chain autocorrelation via FFT, averaged
        nfft = 1 << (2 * n - 1).bit_length()
        f = np.fft.rfft(chains, nfft, axis=1)
        acov = np.fft.irfft(f * np.conj(f), nfft, axis=1)[:, :n].real / n
        var0 = acov[:, 0].mean()
        if var0 <= 0:
            out[k] = c * n
            continue
        rho = acov.mean(axis=0) / var0
        # Geyer: sum consecutive pairs while positive and monotone
        tau = 1.0
        prev = np.inf
        for t in range(1, n - 1, 2):
            pair = rho[t] + rho[t + 1]
            if pair < 0:
                break
            pair = min(pair, prev)
            prev = pair
            tau += 2 * pair
        out[k] = c * n / max(tau, 1e-12)
    return float(out[0]) if scalar else out
