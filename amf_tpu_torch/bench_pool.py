"""The bench's pool baseline: one (candidate, value) lookahead lane of the
reference's Gibbs chain in numpy, a worker process a lane.

A copy of the lane functions of the JAX package's ``bench.py`` (``:47-108``),
kept here because that file is not part of a package. This module imports
numpy alone: the pool is started with ``spawn``, each worker imports the
module that holds its function and the main module, and the timed window
opens before the workers are up, so an import of ``torch`` there would be
timed as the pool's work.
"""

from __future__ import annotations

import numpy as np

# samples of a lane's chain (bench.py:34); ``_pool_init`` may give another
LA_SAMPS = 30

_G = {}


def _pool_init(U0, V0, rated, r_obs, beta, la_samps=None):
    _G.update(U0=U0, V0=V0, rated=rated, r_obs=r_obs, beta=beta,
              la_samps=LA_SAMPS if la_samps is None else la_samps)


def _np_sample_hyper(rng, F):
    """Reference sample_hyperparam (bayes_pmf.py:157-186) in numpy."""
    n, d = F.shape
    xb = F.mean(0)
    Sb = np.cov(F.T) if n > 1 else np.eye(d)
    wi = np.linalg.inv(np.eye(d) + n * Sb + (2.0 * n) / (2.0 + n)
                       * np.outer(-xb, -xb))
    wi = (wi + wi.T) / 2
    dof = d + n
    L = np.linalg.cholesky(wi)
    A = L @ rng.normal(size=(d, dof))
    alpha = A @ A.T
    mu = (n * xb) / (2.0 + n) + np.linalg.cholesky(
        np.linalg.inv((2.0 + n) * alpha)) @ rng.normal(size=d)
    return mu, alpha


def _np_sample_rows(rng, mask, r, other, mu, alpha, beta):
    """Reference sample_feature (bayes_pmf.py:189-216): one row at a time."""
    rows, d = mask.shape[0], other.shape[1]
    out = np.empty((rows, d))
    am = alpha @ mu
    for i in range(rows):
        idx = np.flatnonzero(mask[i])
        Vo = other[idx]
        S = alpha + beta * Vo.T @ Vo
        rhs = beta * (r[i, idx] @ Vo) + am
        L = np.linalg.cholesky(S)
        mean = np.linalg.solve(L.T, np.linalg.solve(L, rhs))
        out[i] = mean + np.linalg.solve(L.T, rng.normal(size=d))
    return out


def _pool_gibbs_lane(args):
    """One (candidate, value) lookahead lane: a fresh chain + total variance
    (the reference worker body, bayes_pmf.py:560-598)."""
    i, j, v, seed = args
    samps = _G["la_samps"]
    rng = np.random.default_rng(seed)
    rated = _G["rated"].copy()
    r = _G["r_obs"].copy()
    rated[i, j] = True
    r[i, j] = v
    U, V = _G["U0"].copy(), _G["V0"].copy()
    beta = _G["beta"]
    n, m = r.shape
    s1 = np.zeros((n, m))
    s2 = np.zeros((n, m))
    for _ in range(samps):
        mu_u, al_u = _np_sample_hyper(rng, U)
        mu_v, al_v = _np_sample_hyper(rng, V)
        for _ in range(2):  # num_gibbs
            U = _np_sample_rows(rng, rated, r, V, mu_u, al_u, beta)
            V = _np_sample_rows(rng, rated.T, r.T, U, mu_v, al_v, beta)
        pred = U @ V.T
        s1 += pred
        s2 += pred * pred
    var = s2 / samps - (s1 / samps) ** 2
    return float(var.sum())
