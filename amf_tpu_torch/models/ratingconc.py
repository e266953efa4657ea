"""Rating-concentration (maxent) matrix completion
(mirrors ``amf_tpu/models/ratingconc.py``).

Capability parity with the reference's ratingconcentration/ MATLAB+MEX suite
(ratingconcentration.m, maxentmulti.m, dual3.m, computep.m, setbounds.m,
sets_square5.m): the Huang-Jebara maxent model, per-cell multinomials over
the rating values whose per-row and per-column expected feature vectors
match the observed averages within McDiarmid-style concentration bounds,
fit through the box-constrained dual over Lagrange multipliers
(gamma+/-, lambda+/-).

As in the JAX package, the dual is a dense masked logsumexp over (row,
column, value), exactly max-shifted with no overflow clamps, and the
Fortran L-BFGS-B is ``ops.lbfgsb``. The gradient is the reference's closed
form (dual3.m:60-83): one softmax over (..., n, m, V) gives every cell's
expected features, whose row and column sums are the gradient, with no
autograd tape.

The lookahead refits one dual per (candidate, value) lane, in lockstep. A
lane differs from the base problem by its one added rating, which moves
row i's and column j's averages, counts and bounds, the global value prior,
and the lane's own cell in the query mask. So a lane carries its (n, k)
and (m, k) statistics and its prior, shares the base (n, m) query mask, and
drops its own cell from the masked sums.
"""

from __future__ import annotations

import dataclasses
from itertools import combinations
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from amf_tpu_torch.ops.lbfgsb import lbfgsb
from amf_tpu_torch.types import Problem


def feature_map(values: Tuple[float, ...]) -> np.ndarray:
    """Per-value feature vectors F (n_values, k).

    For 5 values this reproduces sets_square5.m:1-14 exactly: 5 indicators,
    10 pairwise-membership indicators, normalized linear and quadratic terms
    (17 features). The same construction generalizes to any value count
    (2 values -> the binary variant's role, sets_binary.m).
    """
    v = np.asarray(sorted(values), dtype=np.float64)
    nv = v.size
    pairs = list(combinations(range(nv), 2))
    k = nv + len(pairs) + 2
    F = np.zeros((nv, k))
    for r in range(nv):
        F[r, r] = 1.0
        for p, (a, b) in enumerate(pairs):
            if r == a or r == b:
                F[r, nv + p] = 1.0
        span = max(v[-1] - v[0], 1.0)
        F[r, -2] = (v[r] - v[0]) / span
        F[r, -1] = ((v[r] - v[0]) ** 2) / span**2
    return F


def set_bounds(c, d, C, D, delta: float):
    """Concentration bounds alpha (rows), beta (cols) from the query counts
    c, d and the observed counts C, D (reference: setbounds.m:1-28; the
    original clips beta by the alpha condition, this clips each by its own,
    as the JAX package does)."""
    eps = np.finfo(np.float64).eps
    c = torch.clamp(c, min=eps)
    d = torch.clamp(d, min=eps)
    C = torch.clamp(C, min=eps)
    D = torch.clamp(D, min=eps)
    if delta > 0:
        alpha = (2 - delta) * (torch.sqrt(1 / (2 * C))
                               + torch.sqrt((c + C) / (2 * C * c)))
        beta = (2 - delta) * (torch.sqrt(1 / (2 * D))
                              + torch.sqrt((d + D) / (2 * D * d)))
        alpha = torch.clamp(alpha, max=2.0)
        beta = torch.clamp(beta, max=2.0)
    else:
        alpha = torch.full_like(c, 2.0)
        beta = torch.full_like(d, 2.0)
    return alpha, beta


class RCConfig(NamedTuple):
    rating_values: Tuple[float, ...] = (1.0, 2.0, 3.0, 4.0, 5.0)
    delta: float = 1.5  # reference default (evaluate_active.m:5)
    upper: float = 1e4  # multiplier box upper bound (maxentmulti.m lbfgsb call)
    max_iters: int = 500
    pgtol: float = 1e-7


@dataclasses.dataclass(frozen=True)
class RCData:
    """Static-per-problem tensors for the dual. Every field but ``F`` and
    ``qmask`` may carry a leading lane dimension."""

    F: torch.Tensor  # (V, k) feature map
    prior: torch.Tensor  # (V,) empirical value distribution of observed ratings
    log_prior: torch.Tensor
    mu: torch.Tensor  # (n, k) per-row observed feature means
    nu: torch.Tensor  # (m, k) per-col observed feature means
    alpha: torch.Tensor  # (n, k) row bounds
    beta: torch.Tensor  # (m, k) col bounds
    c: torch.Tensor  # (n,) query counts per row
    d: torch.Tensor  # (m,) query counts per col
    qmask: torch.Tensor  # (n, m) query cells (the reference's `mask`)


class _Counts(NamedTuple):
    """The observed ratings counted by value: per row (n, V), per column
    (m, V), in all (V,)."""

    rows: torch.Tensor
    cols: torch.Tensor
    total: torch.Tensor


def _value_counts(problem: Problem, cfg: RCConfig, dtype) -> _Counts:
    vals = torch.as_tensor(sorted(cfg.rating_values), dtype=dtype,
                           device=problem.R_obs.device)
    r = problem.R_obs.to(dtype)
    idx = torch.argmin(torch.abs(r[..., None] - vals), dim=-1)  # (n, m)
    onehot = torch.nn.functional.one_hot(idx, vals.shape[0]).to(dtype)
    onehot = onehot * problem.rated.to(dtype)[..., None]
    return _Counts(rows=onehot.sum(1), cols=onehot.sum(0),
                   total=onehot.sum((0, 1)))


def _prior(counts: torch.Tensor) -> torch.Tensor:
    """Value prior from counts (..., V) (ratingconcentration.m:47-52)."""
    total = counts.sum(-1, keepdim=True)
    return torch.clamp(counts / torch.clamp(total, min=1), min=1e-12)


def prepare(problem: Problem, cfg: RCConfig, dtype=torch.float64) -> RCData:
    """Compute observed averages, prior, and bounds
    (reference: maxentmulti.m computeaverages/setbounds calls)."""
    device = problem.R_obs.device
    F = torch.as_tensor(feature_map(cfg.rating_values), dtype=dtype,
                        device=device)
    k = F.shape[1]
    counts = _value_counts(problem, cfg, dtype)
    ratedf = problem.rated.to(dtype)
    qf = problem.queryable.to(dtype)
    Cn, Dm = ratedf.sum(1), ratedf.sum(0)
    mu = (counts.rows @ F) / torch.clamp(Cn[:, None], min=1)
    nu = (counts.cols @ F) / torch.clamp(Dm[:, None], min=1)
    c, d = qf.sum(1), qf.sum(0)
    a, b = set_bounds(c, d, Cn, Dm, cfg.delta)
    prior = _prior(counts.total)
    return RCData(F=F, prior=prior, log_prior=torch.log(prior), mu=mu, nu=nu,
                  alpha=a[:, None].expand(-1, k), beta=b[:, None].expand(-1, k),
                  c=c, d=d, qmask=problem.queryable)


def _split(x, n, m, k):
    lead = x.shape[:-1]
    gp, gm, lp, lm = torch.split(x, [n * k, n * k, m * k, m * k], dim=-1)
    return (gp.reshape(lead + (n, k)), gm.reshape(lead + (n, k)),
            lp.reshape(lead + (m, k)), lm.reshape(lead + (m, k)))


class _Cells(NamedTuple):
    """Each lane's own cell, dropped from the shared query mask."""

    lane: torch.Tensor
    i: torch.Tensor
    j: torch.Tensor


def _logits(x, data: RCData):
    """(..., n, m, V) cell logits log_prior + F U_i + F V_j, and the
    clamped counts the multipliers were scaled by."""
    n, k = data.mu.shape[-2:]
    m = data.nu.shape[-2]
    gp, gm, lp, lm = _split(x, n, m, k)
    eps = torch.finfo(x.dtype).eps
    cc = torch.clamp(data.c, min=eps)[..., None]
    dd = torch.clamp(data.d, min=eps)[..., None]
    fu = data.log_prior[..., None, :] + ((gp - gm) / cc) @ data.F.T
    fv = ((lp - lm) / dd) @ data.F.T
    return fu[..., :, None, :] + fv[..., None, :, :], cc, dd


def _exp_shifted_(logits):
    """Exact max-shifted logsumexp over the last axis: logits becomes
    exp(logits - max) in place; returns (log Z, Z), (..., n, m). The shift
    is a constant to autograd (JAX's stop_gradient), so the value stays
    differentiable."""
    mx = logits.amax(-1, keepdim=True).detach()
    e = logits.sub_(mx).exp_()
    z = e.sum(-1)
    return torch.log(z) + mx[..., 0], z


def _linear_terms(x, data: RCData):
    n, k = data.mu.shape[-2:]
    m = data.nu.shape[-2]
    gp, gm, lp, lm = _split(x, n, m, k)

    def total(a):
        return a.sum((-2, -1))

    f = -total((gp - gm) * data.mu) - total((lp - lm) * data.nu)
    return f + total((gp + gm) * data.alpha) + total((lp + lm) * data.beta)


def _masked_probs_(e, z, data: RCData, cells: Optional[_Cells]):
    """exp-shifted logits -> the query cells' normalized multinomials, in
    place (zero off the mask and at each lane's own cell)."""
    P = e.div_(z[..., None]).masked_fill_(~data.qmask[..., None], 0.0)
    if cells is not None:
        P[cells.lane, cells.i, cells.j] = 0.0
    return P


def _dual(x, data: RCData, cells: Optional[_Cells], grad: bool):
    f = _linear_terms(x, data)
    e, cc, dd = _logits(x, data)
    log_z, z = _exp_shifted_(e)
    log_z = log_z.masked_fill_(~data.qmask, 0.0)
    if cells is not None:
        log_z[cells.lane, cells.i, cells.j] = 0.0
    f = f + log_z.sum((-2, -1))
    if not grad:
        return f
    P = _masked_probs_(e, z, data, cells)
    row = (P.sum(-2) @ data.F) / cc  # (..., n, k)
    col = (P.sum(-3) @ data.F) / dd  # (..., m, k)
    g = torch.cat([(-data.mu + data.alpha + row).flatten(-2),
                   (data.mu + data.alpha - row).flatten(-2),
                   (-data.nu + data.beta + col).flatten(-2),
                   (data.nu + data.beta - col).flatten(-2)], dim=-1)
    return f, g


def dual_objective(x: torch.Tensor, data: RCData) -> torch.Tensor:
    """The maxent dual (reference: dual3.m:1-58), dense and masked.

    f = -sum((g+ - g-) mu) - sum((l+ - l-) nu)
      + sum((g+ + g-) alpha) + sum((l+ + l-) beta)
      + sum_{ij in qmask} log Z_ij,
    Z_ij = sum_s prior_s exp(F_s U_i + F_s V_j),
    U_i = (g+ - g-)_i / c_i, V_j = (l+ - l-)_j / d_j.
    """
    return _dual(x, data, None, grad=False)


def dual_value_and_grad(x: torch.Tensor, data: RCData
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dual and its closed-form gradient (dual3.m:60-83):
    d/dg+ = -mu + alpha + rowsum(P F) / c, d/dg- = mu + alpha - rowsum / c,
    and the same over columns with nu, beta, d."""
    return _dual(x, data, None, grad=True)


def cell_probs(x: torch.Tensor, data: RCData,
               cells_mask: torch.Tensor) -> torch.Tensor:
    """(n, m, V) normalized per-cell multinomials over ``cells_mask``
    (reference: computep.m normalized, ratingconcentration.m:60-77)."""
    e, _, _ = _logits(x, data)
    _, z = _exp_shifted_(e)
    return e.div_(z[..., None]).masked_fill_(~cells_mask[..., None], 0.0)


def _solve(data: RCData, cfg: RCConfig, x0: torch.Tensor,
           cells: Optional[_Cells] = None):
    def fun(x):
        return _dual(x, data, cells, grad=True)

    def value(x):
        return _dual(x, data, cells, grad=False)

    return lbfgsb(fun, x0, 0.0, cfg.upper, max_iters=cfg.max_iters,
                  pgtol=cfg.pgtol, value_fn=value)


def fit(
    problem: Problem,
    cfg: RCConfig,
    warmstart: Optional[torch.Tensor] = None,
    dtype=torch.float64,
) -> Tuple[torch.Tensor, RCData, torch.Tensor]:
    """Fit the multipliers; returns (x, data, n_iters)
    (reference: ratingconcentration.m -> maxentmulti.m)."""
    data = prepare(problem, cfg, dtype)
    n, k = data.mu.shape
    m = data.nu.shape[0]
    dim = 2 * (n + m) * k
    x0 = (warmstart.to(dtype) if warmstart is not None
          else torch.zeros(dim, dtype=dtype, device=data.mu.device))
    res = _solve(data, cfg, x0[None])
    return res.x[0], data, res.n_iters[0]


def predictions(
    x: torch.Tensor, data: RCData, problem: Problem, cfg: RCConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(E, P): expected ratings and per-cell multinomials over query+observed
    cells (reference: ratingconcentration.m:55-77)."""
    P = cell_probs(x, data, data.qmask | problem.rated)
    vals = torch.as_tensor(sorted(cfg.rating_values), dtype=x.dtype,
                           device=x.device)
    return P @ vals, P


RC_KEYS = {
    "ge-1": ("Prob >= 1", 1.0),
    "ge-4": ("Prob >= 4", 4.0),
    "entropy": ("Entropy Lookahead", None),
    "random": ("Random", None),
}


def _lane_data(problem: Problem, cfg: RCConfig, base: RCData,
               counts: _Counts, i: torch.Tensor, j: torch.Tensor,
               v_idx: torch.Tensor) -> RCData:
    """Every lane's RCData: the base with rating value ``v_idx`` added at
    the lane's queryable cell (i, j): row i's and column j's averages,
    counts and bounds and the value prior move; F and the (n, m) query
    mask are shared (the lane's cell is dropped where the mask is read)."""
    L = i.shape[0]
    dtype = base.mu.dtype
    lane = torch.arange(L, device=i.device)
    onehot = torch.nn.functional.one_hot(v_idx, base.F.shape[0]).to(dtype)
    ratedf = problem.rated.to(dtype)
    Cn_i = ratedf.sum(1)[i] + 1
    Dm_j = ratedf.sum(0)[j] + 1
    c_i, d_j = base.c[i] - 1, base.d[j] - 1
    a_i, b_j = set_bounds(c_i, d_j, Cn_i, Dm_j, cfg.delta)

    def lanes(t):
        return t.expand((L,) + t.shape).clone()

    mu, nu, alpha, beta = (lanes(base.mu), lanes(base.nu),
                           lanes(base.alpha), lanes(base.beta))
    c, d = lanes(base.c), lanes(base.d)
    mu[lane, i] = ((counts.rows[i] + onehot) @ base.F) / torch.clamp(
        Cn_i[:, None], min=1)
    nu[lane, j] = ((counts.cols[j] + onehot) @ base.F) / torch.clamp(
        Dm_j[:, None], min=1)
    alpha[lane, i] = a_i[:, None]
    beta[lane, j] = b_j[:, None]
    c[lane, i] = c_i
    d[lane, j] = d_j
    prior = _prior(counts.total + onehot)
    return RCData(F=base.F, prior=prior, log_prior=torch.log(prior), mu=mu,
                  nu=nu, alpha=alpha, beta=beta, c=c, d=d, qmask=base.qmask)


def entropy_lookahead_scores(
    x: torch.Tensor,
    data: RCData,
    problem: Problem,
    cfg: RCConfig,
    lookahead_iters: int = 60,
    cand: Optional[torch.Tensor] = None,
    dtype=torch.float64,
    candidate_tile: int = 0,
) -> torch.Tensor:
    """select_1step_lowest_entropy.m:1-41: for each candidate cell and value,
    refit the maxent model (warm-started from ``x``, ``lookahead_iters``
    iterations) and compute the entropy of the remaining query cells'
    multinomials; expectation under the current cell multinomial.

    The (candidate, value) lanes of ``candidate_tile`` candidates at a
    time (0: all at once) refit in lockstep; the tile bounds the memory,
    an (L, n, m, V) buffer, and not the scores. Returns flat scores (C,),
    NaN off the queryable pool (those candidates are not refit)."""
    n, m = problem.shape
    device = x.device
    if cand is None:
        cand = torch.arange(n * m, device=device)
    cand = torch.as_tensor(cand, device=device).long()
    x = x.to(dtype)
    vals = torch.as_tensor(sorted(cfg.rating_values), dtype=dtype,
                           device=device)
    V = vals.shape[0]
    P_now = cell_probs(x, data, data.qmask)
    counts = _value_counts(problem, cfg, dtype)
    lcfg = cfg._replace(max_iters=lookahead_iters)

    scores = torch.full(cand.shape, torch.nan, dtype=dtype, device=device)
    pool = torch.nonzero(problem.queryable.flatten()[cand])[:, 0]
    C = pool.shape[0]
    tile = candidate_tile if candidate_tile and candidate_tile < C else C
    for t0 in range(0, C, max(tile, 1)):
        sel = pool[t0:t0 + tile]
        ii = torch.repeat_interleave(cand[sel] // m, V)
        jj = torch.repeat_interleave(cand[sel] % m, V)
        v_idx = torch.arange(V, device=device).repeat(sel.shape[0])
        lane_data = _lane_data(problem, cfg, data, counts, ii, jj, v_idx)
        cells = _Cells(torch.arange(ii.shape[0], device=device), ii, jj)
        res = _solve(lane_data, lcfg, x.expand(ii.shape[0], -1).clone(),
                     cells)
        e, _, _ = _logits(res.x, lane_data)
        _, z = _exp_shifted_(e)
        P2 = _masked_probs_(e, z, lane_data, cells)
        ents = -torch.xlogy(P2, P2).sum((-3, -2, -1)).reshape(-1, V)
        del e, P2
        w = P_now[cand[sel] // m, cand[sel] % m]  # (C_t, V)
        scores[sel] = (w * ents).sum(-1)
    return scores
