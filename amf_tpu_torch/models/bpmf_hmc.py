"""Bayesian PMF sampled with NUTS, the Stan-path replacement
(mirrors ``amf_tpu/models/bpmf_hmc.py``).

Capability parity with the reference's ``BPMF`` class and Stan models
(stan-bpmf/bpmf.py:176-478, bpmf_w0identity.stan): the Wishart-
reparameterized hierarchical prior (chi-squared diagonal and standard-
normal lower triangle building a Wishart(nu_0, I) factor A; latent-factor
covariance L L^T with L = A^{-1}), multi-normal-Cholesky priors on U and V,
a normal likelihood, sampled-mode warm starts, and the sample-based
lookahead criteria.

Layout: a parameter vector is flat, and every function takes a leading
lane axis, q (L, dim). Chains (``samples(chains=...)``) and lookahead
lanes are lanes of one lockstep NUTS run (``mcmc/nuts.py``). A lookahead
lane is the base problem plus its one hypothesised cell
(``types.LaneCells``) with its own mean rating; the lanes share the base
ratings and mask, and the lane's cell enters the data term as a
correction.

Replicated Stan quirk: the standardized means have sd = 1/beta_0
(``mu_u_stdized ~ normal(0, one_over_beta_0)``, bpmf_w0identity.stan:107),
as the JAX package has it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from amf_tpu_torch.mcmc import nuts
from amf_tpu_torch.models import sample_stats
from amf_tpu_torch.parallel.sharding import sharded_chain_map
from amf_tpu_torch.types import LaneCells, Problem
from amf_tpu_torch.utils.rng import fold_in, generator, lane_generators


class HMCConfig(NamedTuple):
    """Hyperparameters (reference defaults: stan-bpmf/bpmf.py:187-193)."""

    latent_d: int = 5
    subtract_mean: bool = True
    rating_std: float = 0.5
    beta_0: float = 2.0
    # nu_0 = latent_d, mu_0 = 0, w_0 = I (the w0identity model)
    max_depth: int = 8
    # density variant (reference --model-filename, stan-bpmf/bpmf.py:739-742):
    # 'w0identity' (bpmf_w0identity.stan), 'bpmf' (bpmf.stan with w_0 = I
    # as data) or 'straightforward' (bpmf_straightforward.stan)
    model: str = "w0identity"


class ParamShapes(NamedTuple):
    n: int
    m: int
    d: int

    @property
    def n_tri(self) -> int:
        return max(self.d * (self.d - 1) // 2, 1)

    @property
    def dim(self) -> int:
        return (self.n + self.m) * self.d + 2 * self.d + 2 * (self.d + self.n_tri)


def unpack(q: torch.Tensor, s: ParamShapes) -> Dict[str, torch.Tensor]:
    """Split flat vectors q (..., dim) into named parameter blocks."""
    lead = q.shape[:-1]
    sizes = [s.n * s.d, s.m * s.d, s.d, s.d, s.d, s.n_tri, s.d, s.n_tri]
    U, V, mu_u, mu_v, lc_u, z_u, lc_v, z_v = torch.split(q, sizes, dim=-1)
    return {
        "U": U.reshape(lead + (s.n, s.d)),
        "V": V.reshape(lead + (s.m, s.d)),
        "mu_u_std": mu_u, "mu_v_std": mu_v,
        "log_c_u": lc_u, "z_u": z_u,
        "log_c_v": lc_v, "z_v": z_v,
    }


def pack(params: Dict[str, torch.Tensor]) -> torch.Tensor:
    lead = params["mu_u_std"].shape[:-1]
    return torch.cat([
        params["U"].reshape(lead + (-1,)), params["V"].reshape(lead + (-1,)),
        params["mu_u_std"], params["mu_v_std"],
        params["log_c_u"], params["z_u"],
        params["log_c_v"], params["z_v"],
    ], dim=-1)


def init_params(s: ParamShapes, dtype, U: Optional[torch.Tensor] = None,
                V: Optional[torch.Tensor] = None, device=None
                ) -> Dict[str, torch.Tensor]:
    """Identity-covariance init; factors at the MAP estimate if given (the
    reference's --model-init PMF warm start, stan-bpmf/bpmf.py:827-865)."""
    if U is not None:
        device = U.device

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "U": z(s.n, s.d) if U is None else U.to(dtype),
        "V": z(s.m, s.d) if V is None else V.to(dtype),
        "mu_u_std": z(s.d), "mu_v_std": z(s.d),
        "log_c_u": z(s.d), "z_u": z(s.n_tri),
        "log_c_v": z(s.d), "z_v": z(s.n_tri),
    }


@functools.lru_cache(maxsize=None)
def _strict_lower(d: int, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """Row and column indices of the strict lower triangle in Stan's
    column-major fill order, kept on ``device`` (built once: a copy from
    the host would wait for the card at every leapfrog)."""
    order = [(i, j) for j in range(d) for i in range(j + 1, d)]
    return (torch.as_tensor([o[0] for o in order], device=device),
            torch.as_tensor([o[1] for o in order], device=device))


def _tri_from(z: torch.Tensor, sqrt_c: torch.Tensor, d: int) -> torch.Tensor:
    """Lower-triangular Bartlett factors A (..., d, d): diagonal sqrt(c),
    strict lower part z in Stan's column-major fill order
    (bpmf_w0identity.stan:83-102)."""
    a = torch.diag_embed(sqrt_c)
    if d > 1:
        ii, jj = _strict_lower(d, z.device)
        strict = z.new_zeros(z.shape[:-1] + (d, d))
        strict[..., ii, jj] = z[..., :ii.shape[0]]
        a = a + strict
    return a


def _solve_lower(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^{-1} b for lower-triangular a (..., d, d) and vectors b (..., d)."""
    return torch.linalg.solve_triangular(a, b[..., None], upper=False)[..., 0]


def _prior_logp_half(
    feats: torch.Tensor,  # (..., rows, d)
    mu_std: torch.Tensor,  # (..., d)
    log_c: torch.Tensor,
    z: torch.Tensor,
    cfg: HMCConfig,
    d: int,
    w0_chol: Optional[torch.Tensor] = None,  # chol(w_0); None = identity
    mu_0: Optional[torch.Tensor] = None,  # None = zeros
    nu_0: Optional[float] = None,  # None = d (the reference default)
) -> torch.Tensor:
    """Log prior of one side (U or V), per lane: the chi2/normal Wishart-
    factor prior, the standardized mean and the multi_normal_cholesky
    factor prior. The defaults give bpmf_w0identity.stan; w0_chol / mu_0 /
    nu_0 give the general model (bpmf.stan:66-127), cov_L =
    A^{-1} chol(w_0)^{-1}."""
    dtype = feats.dtype
    c = torch.exp(log_c)
    nu = float(d if nu_0 is None else nu_0)
    k = nu - torch.arange(d, dtype=dtype, device=feats.device)

    # c_i ~ chi2(k_i), plus log|dc/dlog_c| = sum(log_c)
    lp = torch.sum((k / 2 - 1) * log_c - c / 2, -1) + torch.sum(log_c, -1)
    lp = lp - 0.5 * torch.sum(z * z, -1)
    # mu_std ~ N(0, (1/beta_0)^2)  [Stan sd = 1/beta_0: module docstring]
    lp = lp - 0.5 * torch.sum((mu_std * cfg.beta_0) ** 2, -1)

    a = _tri_from(z, torch.sqrt(c), d)
    rows = feats.shape[-2]
    if w0_chol is None:
        # L = A^{-1}; mu = L mu_std; x_i ~ MVN(mu, L L^T); the quadratic
        # form through A (x - mu)
        mu = _solve_lower(a, mu_std)
        resid = (feats - mu[..., None, :]) @ a.mT
        lp = (lp + rows * 0.5 * torch.sum(log_c, -1)
              - 0.5 * torch.sum(resid * resid, (-2, -1)))
    else:
        w0_chol = w0_chol.to(dtype)
        mu = _solve_lower(a, _solve_lower(w0_chol.expand(a.shape), mu_std))
        if mu_0 is not None:
            mu = mu_0.to(dtype) + mu
        resid = (feats - mu[..., None, :]) @ (w0_chol @ a).mT
        lp = (lp
              + rows * (0.5 * torch.sum(log_c, -1)
                        + torch.sum(torch.log(torch.diagonal(w0_chol))))
              - 0.5 * torch.sum(resid * resid, (-2, -1)))
    return lp


def _prior_logp_half_straightforward(
    feats: torch.Tensor,  # (..., rows, d)
    mu: torch.Tensor,  # (..., d): the factor mean directly
    log_diag: torch.Tensor,  # (..., d) log diagonal of chol(cov)
    z: torch.Tensor,  # strict lower part of chol(cov)
    cfg: HMCConfig,
    d: int,
    w0_chol: Optional[torch.Tensor] = None,
    mu_0: Optional[torch.Tensor] = None,
    nu_0: Optional[float] = None,
) -> torch.Tensor:
    """One side of bpmf_straightforward.stan:41-58, the centred
    parameterization: cov ~ inv_wishart(nu_0, w_0) on a Cholesky factor
    with log diagonal (Jacobian sum_i (d - i + 2) log L_ii), mu ~
    multi_normal(mu_0, cov / beta_0), rows ~ multi_normal(mu, cov). The
    beta_0 scaling differs from the other two variants as in the reference
    (the JAX package says more)."""
    dtype = feats.dtype
    nu = float(d if nu_0 is None else nu_0)
    rows = feats.shape[-2]
    L = _tri_from(z, torch.exp(log_diag), d)
    logdet_cov = 2.0 * torch.sum(log_diag, -1)
    eye = torch.eye(d, dtype=dtype, device=feats.device)

    # inv_wishart(nu_0, w_0): -(nu+d+1)/2 log|S| - tr(w_0 S^{-1})/2
    rhs = eye if w0_chol is None else w0_chol.to(dtype)
    Li = torch.linalg.solve_triangular(L, rhs.expand(L.shape), upper=False)
    tr_term = torch.sum(Li * Li, (-2, -1))
    lp = -(nu + d + 1) / 2 * logdet_cov - 0.5 * tr_term
    # cov_matrix Cholesky-log-diag Jacobian (constants dropped)
    lp = lp + torch.sum(
        (d - torch.arange(d, dtype=dtype, device=feats.device) + 1)
        * log_diag, -1)

    mu_c = mu if mu_0 is None else mu - mu_0.to(dtype)
    wmu = _solve_lower(L, mu_c)
    lp = lp - 0.5 * logdet_cov - 0.5 * cfg.beta_0 * torch.sum(wmu * wmu, -1)

    resid = torch.linalg.solve_triangular(
        L, (feats - mu[..., None, :]).mT, upper=False)
    lp = (lp - 0.5 * rows * logdet_cov
          - 0.5 * torch.sum(resid * resid, (-2, -1)))
    return lp


def _data_term(U, V, problem: Problem, center, cfg: HMCConfig,
               cells: Optional[LaneCells]) -> torch.Tensor:
    """-0.5 sum of squared residuals over the rated cells / rating_std^2,
    per lane; with ``cells`` each lane adds (or overwrites) its own cell."""
    pred = U @ V.mT  # (L, n, m)
    c = center[:, None, None]
    err = torch.where(problem.rated, problem.R_obs - c - pred, 0.0)
    sq = torch.sum(err * err, (-2, -1))
    if cells is not None:
        lane = torch.arange(len(cells), device=U.device)
        p_cell = pred[lane, cells.i, cells.j]
        was = problem.rated[cells.i, cells.j]
        new = cells.v.to(U.dtype) - center - p_cell
        old = torch.where(was, problem.R_obs[cells.i, cells.j] - center
                          - p_cell, 0.0)
        sq = sq + new * new - old * old
    return -0.5 * sq / cfg.rating_std ** 2


def log_posterior(
    q: torch.Tensor,
    problem: Problem,
    mean_rating,
    cfg: HMCConfig,
    shapes: ParamShapes,
    w0_chol: Optional[torch.Tensor] = None,
    mu_0: Optional[torch.Tensor] = None,
    nu_0: Optional[float] = None,
    cells: Optional[LaneCells] = None,
) -> torch.Tensor:
    """Log posterior (up to constants) of q (L, dim) or (dim,), per lane.

    ``mean_rating`` is a number or (L,); ``cells`` puts lane l on the base
    problem plus its cell (types.LaneCells)."""
    single = q.dim() == 1
    if single:
        q = q[None]
    L = q.shape[0]
    if w0_chol is None and cfg.model == "bpmf":
        # general-model path with the reference's w_0 = I data
        w0_chol = torch.eye(shapes.d, dtype=q.dtype, device=q.device)
    p = unpack(q, shapes)
    half = (_prior_logp_half_straightforward if cfg.model == "straightforward"
            else _prior_logp_half)
    kw = dict(w0_chol=w0_chol, mu_0=mu_0, nu_0=nu_0)
    lp = half(p["U"], p["mu_u_std"], p["log_c_u"], p["z_u"], cfg, shapes.d,
              **kw)
    lp = lp + half(p["V"], p["mu_v_std"], p["log_c_v"], p["z_v"], cfg,
                   shapes.d, **kw)
    if cfg.subtract_mean:
        center = torch.as_tensor(mean_rating, dtype=q.dtype,
                                 device=q.device).expand(L)
    else:
        center = q.new_zeros(L)
    lp = lp + _data_term(p["U"], p["V"], problem, center, cfg, cells)
    return lp[0] if single else lp


@dataclasses.dataclass(frozen=True)
class BPMFState:
    """The sampled-mode warm start (stan-bpmf/bpmf.py:218-220).

    adapt_eps / adapt_inv_mass optionally carry the NUTS adaptation (eps
    anchor and diagonal inverse mass) between active steps; they are set
    only by ``samples(..., carry_adapt=True)``, and a zero-size
    adapt_inv_mass means "no carried adaptation"."""

    mode_q: torch.Tensor  # (dim,) best-lp parameter vector seen so far
    mode_lp: torch.Tensor  # ()
    mean_rating: torch.Tensor  # ()
    adapt_eps: torch.Tensor  # ()
    adapt_inv_mass: torch.Tensor  # (dim,) or (0,)


def init_state(problem: Problem, cfg: HMCConfig,
               U: Optional[torch.Tensor] = None,
               V: Optional[torch.Tensor] = None,
               dtype=torch.float32) -> BPMFState:
    """The state at the identity-covariance init (factors at U, V if
    given), on the problem's device."""
    n, m = problem.shape
    device = problem.R_obs.device
    s = ParamShapes(n, m, cfg.latent_d)
    q0 = pack(init_params(s, dtype, U=U, V=V, device=device))

    def scalar(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    return BPMFState(
        mode_q=q0, mode_lp=scalar(-torch.inf),
        mean_rating=problem.mean_rating().to(dtype), adapt_eps=scalar(0.0),
        adapt_inv_mass=torch.zeros((0,), dtype=dtype, device=device))


def invalidate_mode(state: BPMFState, problem: Problem) -> BPMFState:
    """After new ratings the stored lp is stale (stan-bpmf/bpmf.py:270-272)."""
    return dataclasses.replace(
        state, mode_lp=torch.full_like(state.mode_lp, -torch.inf),
        mean_rating=problem.mean_rating().to(state.mean_rating.dtype))


def samples(
    seed: int,
    state: BPMFState,
    problem: Problem,
    cfg: HMCConfig,
    num_samps: int,
    warmup: Optional[int] = None,
    chains: int = 1,
    chain_mesh=None,
    carry_adapt: bool = False,
    warm_warmup: Optional[int] = None,
    noise: Optional[nuts.NUTSNoise] = None,
) -> Tuple[BPMFState, Dict[str, torch.Tensor]]:
    """Run NUTS for num_samps draws after warmup (default num_samps // 2,
    stan-bpmf/bpmf.py:310-311) from the sampled mode; update the mode from
    the best-lp draw. Returns (state, {'U', 'V', 'lp__'}) and, per draw,
    the sampler's 'accept_prob', 'num_leaves' and 'diverging' (Stan's
    sampler parameters).

    chains > 1 runs independent chains as lanes of one lockstep run
    (num_samps draws each, pooled chain-major): the replacement for the
    reference's process-parallel Stan chains (stan-bpmf/bpmf.py:314).
    Chain c draws from a generator seeded fold_in(seed, c); ``noise`` (one
    lane a chain) replaces those draws.

    If the state carries adaptation (a non-empty adapt_inv_mass, stored by
    an earlier carry_adapt=True call), every chain warm-starts from that
    metric and eps anchor, skipping the reasonable-eps search, and warmup
    drops to ``warm_warmup`` (if given). carry_adapt stores this run's
    final adaptation, the mean over chains, on the returned state.

    chain_mesh (``parallel.mesh.CandidateMesh``) splits the chains over its
    ranks (``parallel.sharding.sharded_chain_map``; ``chains`` a multiple of
    its size): each rank runs its share as lanes, and the draws, sampler
    info and adaptation are gathered chain-major, so the mode and the
    carried adaptation are taken over every chain, as unsharded. It takes
    no ``noise``.
    """
    if chain_mesh is not None and noise is not None:
        raise ValueError("samples takes noise or a chain_mesh, not both")
    if warmup is None:
        warmup = num_samps // 2
    n, m = problem.shape
    shapes = ParamShapes(n, m, cfg.latent_d)
    dtype, device = state.mode_q.dtype, state.mode_q.device

    warm = state.adapt_inv_mass.numel() > 0
    if warm and warm_warmup is not None:
        warmup = warm_warmup

    def logp(q):
        return log_posterior(q, problem, state.mean_rating, cfg, shapes)

    def run_chains(ids):
        lane_noise = noise if noise is not None else nuts.GeneratorNoise(
            [generator(fold_in(seed, c), device) for c in ids],
            shapes.dim, cfg.max_depth, dtype, device)
        return nuts.run_nuts(
            lane_noise, state.mode_q.expand(len(ids), shapes.dim), logp,
            num_samps, warmup, cfg=nuts.NUTSConfig(max_depth=cfg.max_depth),
            eps_anchor=state.adapt_eps if warm else None,
            init_inv_mass=state.adapt_inv_mass if warm else None,
            return_adaptation=True)

    qs, info, adapt = sharded_chain_map(run_chains, chains, chain_mesh)
    qs = qs.reshape(chains * num_samps, shapes.dim)
    lps = info.logprob.reshape(-1)
    best = torch.argmax(lps)
    better = lps[best] > state.mode_lp
    new_state = dataclasses.replace(
        state,
        mode_q=torch.where(better, qs[best], state.mode_q),
        mode_lp=torch.where(better, lps[best], state.mode_lp))
    if carry_adapt:
        new_state = dataclasses.replace(
            new_state, adapt_eps=adapt["eps"].mean().to(dtype),
            adapt_inv_mass=adapt["inv_mass"].mean(0).to(dtype))
    p = unpack(qs, shapes)
    return new_state, {"U": p["U"], "V": p["V"], "lp__": lps,
                       "accept_prob": info.accept_prob.reshape(-1),
                       "num_leaves": info.num_leaves.reshape(-1),
                       "diverging": info.diverging.reshape(-1)}


# ---------------------------------------------------------------------------
# Lookahead criteria (reference: stan-bpmf/bpmf.py:392-418, 483-521)


def _lane_evals(noise: nuts.NUTSNoise, state: BPMFState, problem: Problem,
                cfg: HMCConfig, cells: LaneCells, stat: str, num_samps: int,
                warmup: int) -> torch.Tensor:
    """(L,) statistic of each lane's fresh chain: the base mode, the lane's
    problem and mean rating, a cold adaptation."""
    n, m = problem.shape
    shapes = ParamShapes(n, m, cfg.latent_d)
    L = len(cells)
    mean_rating = cells.mean_rating(problem).to(state.mode_q.dtype)

    def logp(q):
        return log_posterior(q, problem, mean_rating, cfg, shapes,
                             cells=cells)

    qs, _ = nuts.run_nuts(noise, state.mode_q.expand(L, shapes.dim), logp,
                          num_samps, warmup,
                          cfg=nuts.NUTSConfig(max_depth=cfg.max_depth))
    p = unpack(qs, shapes)
    if stat == "entropy-est":
        return sample_stats.entropy_est_from_factors(
            p["U"], p["V"], mean_rating, cfg.subtract_mean)
    stats = sample_stats.prediction_stats(p["U"], p["V"], mean_rating,
                                          cfg.subtract_mean)
    return stats.var.sum((-2, -1))


def lookahead_scores(
    seed: int,
    state: BPMFState,
    problem: Problem,
    cfg: HMCConfig,
    base_stats,
    rating_values: Tuple[float, ...],
    stat: str = "total-variance",  # or 'entropy-est'
    num_samps: int = 30,
    warmup: int = 15,
    cand=None,
    dirichlet_alpha: float = 0.1,
    n_base_samples: int = 128,
    candidate_tile: int = 0,
    num_integration_pts: int = 50,
    lane_noise: Optional[Callable[[torch.Tensor, int], nuts.NUTSNoise]] = None,
) -> torch.Tensor:
    """exp-variance / exp-entropy-est: per (candidate, value) lane a fresh
    short NUTS run from the sampled mode, the statistic integrated under
    the per-cell marginals: Dirichlet-smoothed histograms for discrete
    rating values (stan-bpmf/bpmf.py:436-443), or a fitted normal on the
    standard-normal quantile grid with trapezoid weights for continuous
    data (:450-453, :505-510).

    ``candidate_tile`` > 0 runs that many candidates (x values) as one
    lockstep batch of lanes at a time (bounds memory; the scores do not
    change). Lane streams are keyed by the global candidate index
    (``utils/rng.lane_generators`` from ``seed``); ``lane_noise(cand,
    n_vals)`` replaces them. Lanes adapt cold even when the state carries
    adaptation (the JAX package measured the base chain's anchor mistuning
    the short lane chains). Returns flat scores (C,), NaN off the
    queryable pool.
    """
    n, m = problem.shape
    device = problem.R_obs.device
    dtype = state.mode_q.dtype
    if cand is None:
        cand = torch.arange(n * m, device=device)
    cand = torch.as_tensor(cand, device=device).long()
    ii, jj = cand // m, cand % m

    if rating_values and base_stats.bin_counts is None:
        raise ValueError(
            "rating_values given but base_stats has no bin_counts — compute "
            "the base stats with value_bounds for the discrete lookahead")
    if rating_values:
        values = torch.as_tensor(sorted(rating_values), dtype=dtype,
                                 device=device)
        n_vals = values.shape[0]
        denom = n_base_samples + dirichlet_alpha * n_vals
        w_c = ((base_stats.bin_counts[:, ii, jj] + dirichlet_alpha) / denom).T
        vals_c = values.expand(cand.shape[0], n_vals)
    else:
        from amf_tpu_torch.ops.quadrature import normal_trapezoid_grid

        z, w = normal_trapezoid_grid(num_integration_pts)
        n_vals = num_integration_pts
        mean_c = base_stats.mean[ii, jj]
        std_c = torch.sqrt(torch.clamp(base_stats.var[ii, jj], min=1e-12))
        vals_c = mean_c[:, None] + std_c[:, None] * torch.as_tensor(
            z, dtype=dtype, device=device)
        w_c = torch.as_tensor(w, dtype=dtype, device=device).expand(
            vals_c.shape)

    dim = ParamShapes(n, m, cfg.latent_d).dim
    C = cand.shape[0]
    tile = candidate_tile if candidate_tile and candidate_tile < C else C
    evals = torch.empty(vals_c.shape, dtype=dtype, device=device)
    for t0 in range(0, C, tile):
        sl = slice(t0, t0 + tile)
        c_t = cand[sl]
        cells = LaneCells(i=torch.repeat_interleave(ii[sl], n_vals),
                          j=torch.repeat_interleave(jj[sl], n_vals),
                          v=vals_c[sl].reshape(-1))
        if lane_noise is not None:
            noise = lane_noise(c_t, n_vals)
        else:
            noise = nuts.GeneratorNoise(
                lane_generators(seed, c_t.tolist(), n_vals, device), dim,
                cfg.max_depth, dtype, device)
        evals[sl] = _lane_evals(noise, state, problem, cfg, cells, stat,
                                num_samps, warmup).reshape(-1, n_vals)
    scores = (evals * w_c).sum(-1)
    return torch.where(problem.queryable[ii, jj], scores, torch.nan)
