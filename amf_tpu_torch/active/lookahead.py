"""The one-step lookahead of the variational-PMF models
(mirrors ``amf_tpu/active/lookahead.py``).

The reference evaluates E[f(model + hypothesized R_ij)] by, for every
unobserved cell and every rating value, deep-copying the model, adding the
rating, optionally refitting the MAP estimate, refitting the normal
approximation and evaluating a statistic, fanned out over a process pool
(active_pmf.py:635-704, 739-770). The JAX package vmaps one lane function
over the (candidate x value) grid.

Here a tile of candidates is one batch of lanes, one lane a (candidate,
value) pair, described by ``types.LaneCells`` over the shared base problem.
The lanes' MAP refits run on the shared problem (``pmf.fit(lanes=...)``);
the approximations, whose KL reads the whole masked problem, take each
lane's own (n, m) masks (``LaneCells.problems``: the cell rated and no
longer queryable). All lanes of a tile descend in lockstep, and tiles are
dispatched from the host, ``candidate_tile`` candidates at a time.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from amf_tpu_torch.active.criteria import Criterion
from amf_tpu_torch.models import mnormal, pmf, vnormal
from amf_tpu_torch.ops import quadrature
from amf_tpu_torch.types import LaneCells, Problem, rating_bounds
from amf_tpu_torch.utils.rng import lane_generators, lane_normals


class LookaheadConfig(NamedTuple):
    rating_values: Tuple[float, ...]  # () = continuous integration
    refit_lookahead: bool = False  # reference --refit-lookahead flag
    discretize: str = "sum"  # 'sum' | 'simps' | 'continuous'
    n_integration_nodes: int = 16  # continuous mode nodes
    pmf_refit_steps: int = 300  # budget for in-lookahead MAP refits
    approx_refit_steps: int = 300  # budget for in-lookahead KL refits
    # candidates a tile of lanes; each lane carries its own approximation
    # state and masks, so this bounds peak memory (0 = all at once)
    candidate_tile: int = 0
    # the exact quartic line search for the in-lookahead MAP refits
    poly_ls: bool = True


class ModelAdapter(NamedTuple):
    """Polymorphism point between the full-covariance (vnormal) and
    Kronecker (mnormal) approximation layers; every callable takes lanes."""

    init_approx: Callable  # (pst, noise) -> approx
    fit_approx: Callable  # (approx, pst, problem, max_steps) -> approx
    pred_mean_var: Callable  # (approx, problem) -> (mean, var) (..., n, m)
    entropy: Callable  # (approx, problem) -> (...,)
    pred_covs: Optional[Callable]  # (approx, problem) -> (..., nm, nm)
    # (n, m) -> k of the (k, k) standard normals init_approx takes a lane,
    # or None where it draws none
    noise_size: Optional[Callable] = None


def vn_adapter(vcfg: vnormal.VNConfig) -> ModelAdapter:
    return ModelAdapter(
        init_approx=lambda pst, noise: vnormal.initialize_approx(
            pst, vcfg, noise=noise),
        fit_approx=lambda a, pst, prob, max_steps: vnormal.fit_normal(
            a, pst, prob, vcfg, max_steps=max_steps)[0],
        pred_mean_var=lambda a, prob: vnormal.approx_pred_means_vars(
            a, prob, vcfg),
        entropy=lambda a, prob: vnormal.approx_entropy(a),
        pred_covs=lambda a, prob: vnormal.approx_pred_covs(a, prob, vcfg),
        noise_size=lambda n, m: (n + m) * vcfg.latent_d,
    )


def mn_adapter(mcfg: mnormal.MNConfig) -> ModelAdapter:
    return ModelAdapter(
        init_approx=lambda pst, noise: mnormal.initialize_approx(pst, mcfg),
        fit_approx=lambda a, pst, prob, max_steps: mnormal.fit_normal(
            a, pst, prob, mcfg, max_steps=max_steps)[0],
        pred_mean_var=lambda a, prob: mnormal.approx_pred_means_vars(a, prob),
        entropy=lambda a, prob: mnormal.approx_entropy(a, *prob.shape),
        pred_covs=None,  # not supported (reference: mn_active_pmf.py:332+)
    )


def _stat_fn(crit: Criterion, adapter: ModelAdapter):
    """Statistic of the refit state for a hypothesized rating, one value a
    lane. Reference analogues: _total_variance (active_pmf.py:605-606),
    _approx_entropy (:526-530), _pred_entropy_bound (:559-574),
    _last_step_lookahead_helper (:492-500)."""
    stat = crit.stat

    def fn(pst, ast, prob, v):
        if stat == "total-variance":
            # the reference sums Var[R_ij] over *all* cells, rated included
            return adapter.pred_mean_var(ast, prob)[1].sum(dim=(-2, -1))
        if stat == "uv-entropy":
            return adapter.entropy(ast, prob)
        if stat == "pred-entropy-bound":
            sign, logdet = torch.linalg.slogdet(adapter.pred_covs(ast, prob))
            # reference numerical-error fallback (active_pmf.py:566-571)
            fallback = torch.where((sign == -1) & (logdet < -50), -1000.0,
                                   torch.nan)
            return torch.where(sign == 1, logdet, fallback)
        if stat == "1step-ge":
            utility = (v >= crit.cutoff).to(v.dtype)
            mean, var = adapter.pred_mean_var(ast, prob)
            # sf with scale=variance — reference quirk (active_pmf.py:499)
            probs = quadrature.norm_sf(crit.cutoff, mean, var.clamp(min=1e-30))
            best = torch.where(prob.queryable, probs, -torch.inf).amax(
                dim=(-2, -1))
            return utility + best
        raise ValueError(f"unknown lookahead stat {stat}")

    return fn


def _expand(state, L: int):
    """Every field of an approximation state repeated for L lanes."""
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).expand(
            (L,) + getattr(state, f.name).shape).contiguous()
        for f in dataclasses.fields(state)})


def lookahead_scores(
    crit: Criterion,
    pmf_state: pmf.PMFState,
    approx_state,
    problem: Problem,
    seed: int,
    pcfg: pmf.PMFConfig,
    adapter: ModelAdapter,
    lcfg: LookaheadConfig,
    cand: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Scores for flat candidate cell indices ``cand`` (default: all cells).

    Returns a (len(cand),) vector of integrated lookahead values; cells not
    in ``problem.queryable`` get NaN. With ``refit_lookahead`` every lane
    starts a fresh approximation from standard normals: ``noise``
    (len(cand), values, k, k) where given (the tests hand in the JAX
    package's lane noise), else drawn from each lane's generator, keyed by
    the lane's global candidate index and value (``utils.rng.lane_seeds``),
    so the scores do not depend on the tiling.
    """
    n, m = problem.shape
    dev = problem.R_obs.device
    if cand is None:
        cand = torch.arange(n * m, device=dev)
    cand = torch.as_tensor(cand, device=dev).long()

    # --- predictive distribution for R_ij used to weight the values
    if crit.use_map:
        # the reference's np.dot(users[i], items[j]) (ActivePMF pins
        # subtract_mean=False, active_pmf.py:110-112, 658); the config is
        # honoured for generality
        mean_mat = pmf.predicted_matrix(pmf_state, pcfg)
        var_mat = pmf_state.sigma_sq.expand(mean_mat.shape)
    else:
        mean_mat, var_mat = adapter.pred_mean_var(approx_state, problem)
    std_mat = torch.sqrt(var_mat.clamp(min=1e-30))
    ii, jj = cand // m, cand % m
    mean_c, std_c = mean_mat[ii, jj], std_mat[ii, jj]

    # the reference forces discretization for the 1-step active-search
    # criteria regardless of discrete_expectations (active_pmf.py:469-474)
    discretize = lcfg.discretize
    if crit.stat == "1step-ge" and lcfg.rating_values:
        discretize = "sum"
    if discretize == "continuous" or not lcfg.rating_values:
        vals_c, w_c = quadrature.gauss_legendre_nodes(
            mean_c, std_c, lcfg.n_integration_nodes)  # (C, V)
    else:
        values = np.asarray(sorted(lcfg.rating_values), dtype=np.float64)
        if discretize == "simps":
            w_c = quadrature.simpson_weights(mean_c, std_c, values)
        else:
            w_c = quadrature.discrete_weights(
                mean_c, std_c, rating_bounds(tuple(values)))
        vals_c = torch.as_tensor(values, dtype=mean_c.dtype,
                                 device=dev).expand(len(cand), values.size)

    stat = _stat_fn(crit, adapter)
    n_vals = vals_c.shape[1]

    def eval_tile(s: slice) -> torch.Tensor:
        """(candidates, values) statistics of the lanes of cand[s]."""
        c = cand[s]
        lanes = LaneCells(i=ii[s].repeat_interleave(n_vals),
                          j=jj[s].repeat_interleave(n_vals),
                          v=vals_c[s].reshape(-1))
        L = len(lanes)
        pst = dataclasses.replace(
            pmf_state, U=pmf_state.U.expand(L, *pmf_state.U.shape),
            V=pmf_state.V.expand(L, *pmf_state.V.shape),
            mean_rating=pmf_state.mean_rating.expand(L))
        ast = _expand(approx_state, L)
        if lcfg.refit_lookahead:
            # the reference's do_fit() then initialize_approx() with a fresh
            # random covariance (active_pmf.py:671-673)
            pst, _ = pmf.fit(pst, problem, pcfg, max_steps=lcfg.pmf_refit_steps,
                             poly_ls=lcfg.poly_ls, lanes=lanes)
            lane_noise = None
            if adapter.noise_size is not None:
                k = adapter.noise_size(n, m)
                if noise is not None:
                    lane_noise = noise[s].reshape(L, k, k).to(
                        device=dev, dtype=mean_c.dtype)
                else:
                    gens = lane_generators(seed, c.tolist(), n_vals, dev)
                    lane_noise = lane_normals(gens, k * k, mean_c.dtype,
                                              dev).reshape(L, k, k)
            ast = adapter.init_approx(pst, lane_noise)
        probs = lanes.problems(problem)
        ast = adapter.fit_approx(ast, pst, probs, lcfg.approx_refit_steps)
        return stat(pst, ast, probs, lanes.v).reshape(len(c), n_vals)

    tile = lcfg.candidate_tile or max(len(cand), 1)
    evals = torch.cat([eval_tile(slice(t, t + tile))
                       for t in range(0, len(cand), tile)]
                      or [w_c.new_zeros((0, n_vals))])
    scores = (evals * w_c).sum(-1)
    return torch.where(problem.queryable[ii, jj], scores, torch.nan)
