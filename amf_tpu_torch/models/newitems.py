"""Cold-start ("new items") BPMF variant (mirrors
``amf_tpu/models/newitems.py``).

Capability parity with the reference's ``NewItemsBPMF``
(stan-bpmf/bpmf_newitems.py:12-138 + bpmf_newitems_w0identity.stan): a
two-phase scheme —
  phase 1: full BPMF fit on the old-item submatrix; posterior-mean factors
           Ubar (users) and Vbar_fixed (old items) become data;
  phase 2: only the new-item columns' factors V_new (plus the item
           hyperprior) are sampled, with V_fixed informing the hyperprior and
           the likelihood restricted to observed new-item cells; the active
           loop queries new-item cells only.

The phase-2 problem is the dense (n, m_new) submatrix with masks, as in the
JAX package. Every density takes a leading lane axis, q (L, dim): the
lookahead's (candidate, value) lanes are lanes of one lockstep NUTS run
(``mcmc/nuts.py``, the potential one CUDA graph a call on the card), each
the base problem plus its one cell (``types.LaneCells``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from amf_tpu_torch.mcmc import nuts
from amf_tpu_torch.models import bpmf_hmc, sample_stats
from amf_tpu_torch.models.bpmf_hmc import HMCConfig, _data_term, \
    _prior_logp_half
from amf_tpu_torch.types import LaneCells, Problem
from amf_tpu_torch.utils.rng import fold_in, generator, lane_generators


class NewItemsShapes(NamedTuple):
    n: int
    m_new: int
    d: int

    @property
    def n_tri(self) -> int:
        return max(self.d * (self.d - 1) // 2, 1)

    @property
    def dim(self) -> int:
        return self.m_new * self.d + self.d + self.d + self.n_tri


def unpack(q: torch.Tensor, s: NewItemsShapes) -> Dict[str, torch.Tensor]:
    """Split flat vectors q (..., dim) into named parameter blocks."""
    lead = q.shape[:-1]
    V_new, mu, lc, z = torch.split(
        q, [s.m_new * s.d, s.d, s.d, s.n_tri], dim=-1)
    return {"V_new": V_new.reshape(lead + (s.m_new, s.d)),
            "mu_v_std": mu, "log_c_v": lc, "z_v": z}


def log_posterior(
    q: torch.Tensor,
    problem_new: Problem,  # (n, m_new) masked problem over new columns
    U_fixed: torch.Tensor,  # (n, d) posterior-mean users from phase 1
    V_fixed: torch.Tensor,  # (m_old, d) posterior-mean old items
    mean_rating,
    cfg: HMCConfig,
    s: NewItemsShapes,
    cells: Optional[LaneCells] = None,
) -> torch.Tensor:
    """bpmf_newitems_w0identity.stan: V_fixed and V_new share the sampled
    item hyperprior; likelihood over observed new-item cells only.
    cfg.model == 'bpmf' uses the general bpmf_newitems.stan construction
    (w_0 = I data, the only w_0 the reference passes). q (L, dim) or
    (dim,); ``cells`` puts lane l on the base problem plus its cell."""
    if cfg.model == "straightforward":
        raise ValueError(
            "the newitems model has no straightforward-parameterization "
            "variant (reference ships only bpmf_newitems[_w0identity].stan)"
        )
    single = q.dim() == 1
    if single:
        q = q[None]
    L = q.shape[0]
    p = unpack(q, s)
    V_fixed = V_fixed.to(q.dtype)
    feats = torch.cat([V_fixed.expand((L,) + V_fixed.shape), p["V_new"]],
                      dim=-2)
    w0_chol = (torch.eye(s.d, dtype=q.dtype, device=q.device)
               if cfg.model == "bpmf" else None)
    lp = _prior_logp_half(feats, p["mu_v_std"], p["log_c_v"], p["z_v"], cfg,
                          s.d, w0_chol=w0_chol)
    if cfg.subtract_mean:
        center = torch.as_tensor(mean_rating, dtype=q.dtype,
                                 device=q.device).expand(L)
    else:
        center = q.new_zeros(L)
    lp = lp + _data_term(U_fixed.to(q.dtype), p["V_new"], problem_new,
                         center, cfg, cells)
    return lp[0] if single else lp


@dataclasses.dataclass(frozen=True)
class NewItemsState:
    mode_q: torch.Tensor  # (dim,) best-lp parameter vector seen so far
    mode_lp: torch.Tensor  # ()
    mean_rating: torch.Tensor  # () phase 1's mean rating, kept throughout
    U_fixed: torch.Tensor  # (n, d)
    V_fixed: torch.Tensor  # (m_old, d)


def init_state(
    problem_new: Problem,
    U_fixed: torch.Tensor,
    V_fixed: torch.Tensor,
    cfg: HMCConfig,
    mean_rating,
    dtype=torch.float64,
) -> NewItemsState:
    """The state at q = 0, on U_fixed's device."""
    m_new = problem_new.shape[1]
    s = NewItemsShapes(U_fixed.shape[0], m_new, cfg.latent_d)
    device = U_fixed.device

    def scalar(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    return NewItemsState(
        mode_q=torch.zeros(s.dim, dtype=dtype, device=device),
        mode_lp=scalar(-torch.inf), mean_rating=scalar(mean_rating),
        U_fixed=U_fixed.to(dtype), V_fixed=V_fixed.to(dtype))


def invalidate_mode(state: NewItemsState) -> NewItemsState:
    """After new ratings the stored lp is stale."""
    return dataclasses.replace(
        state, mode_lp=torch.full_like(state.mode_lp, -torch.inf))


def samples(
    seed: int,
    state: NewItemsState,
    problem_new: Problem,
    cfg: HMCConfig,
    num_samps: int,
    warmup: Optional[int] = None,
    noise: Optional[nuts.NUTSNoise] = None,
) -> Tuple[NewItemsState, Dict[str, torch.Tensor]]:
    """NUTS over the phase-2 posterior (one chain, drawing from a generator
    seeded fold_in(seed, 0), or from ``noise``); returns V_new draws and
    updates the mode from the best-lp draw.

    The returned dict carries 'U' broadcast to the sample axis so the shared
    sample_stats helpers apply unchanged, and, per draw, 'lp__' and the
    sampler's 'accept_prob', 'num_leaves' and 'diverging'."""
    if warmup is None:
        warmup = num_samps // 2
    n, m_new = problem_new.shape
    s = NewItemsShapes(n, m_new, cfg.latent_d)
    dtype, device = state.mode_q.dtype, state.mode_q.device
    if noise is None:
        noise = nuts.GeneratorNoise([generator(fold_in(seed, 0), device)],
                                    s.dim, cfg.max_depth, dtype, device)

    def logp(q):
        return log_posterior(q, problem_new, state.U_fixed, state.V_fixed,
                             state.mean_rating, cfg, s)

    qs, info = nuts.run_nuts(noise, state.mode_q[None], logp, num_samps,
                             warmup, cfg=nuts.NUTSConfig(max_depth=cfg.max_depth))
    qs, lps = qs[0], info.logprob[0]
    best = torch.argmax(lps)
    better = lps[best] > state.mode_lp
    state = dataclasses.replace(
        state, mode_q=torch.where(better, qs[best], state.mode_q),
        mode_lp=torch.where(better, lps[best], state.mode_lp))
    U_b = state.U_fixed.expand((num_samps,) + state.U_fixed.shape)
    return state, {"U": U_b, "V": unpack(qs, s)["V_new"], "lp__": lps,
                   "accept_prob": info.accept_prob[0],
                   "num_leaves": info.num_leaves[0],
                   "diverging": info.diverging[0]}


def _columns(problem: Problem, cols: np.ndarray) -> Problem:
    cols = torch.as_tensor(cols, device=problem.R_obs.device)
    return Problem(R_obs=problem.R_obs[:, cols], rated=problem.rated[:, cols],
                   queryable=problem.queryable[:, cols],
                   test=problem.test[:, cols])


def new_item_problem(problem: Problem, is_new_item: np.ndarray) -> Problem:
    """The (n, m_new) phase-2 problem over the new-item columns."""
    return _columns(problem, np.nonzero(np.asarray(is_new_item, bool))[0])


def initial_full_fit(
    seed: int,
    problem: Problem,
    is_new_item: np.ndarray,
    cfg: HMCConfig,
    num_samps: int = 200,
    warmup: Optional[int] = None,
    dtype=torch.float64,
    noise: Optional[nuts.NUTSNoise] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Phase 1 (reference: do_initial_fit, bpmf_newitems.py:58-64): full BPMF
    on the old-item columns; returns (U_mean, V_fixed_mean, mean_rating).
    Cacheable by the caller (the reference's --initial-fit-file). ``noise``
    replaces the chain's draws (``bpmf_hmc.samples``)."""
    prob_old = _columns(problem,
                        np.nonzero(~np.asarray(is_new_item, bool))[0])
    st = bpmf_hmc.init_state(prob_old, cfg, dtype=dtype)
    st, samps = bpmf_hmc.samples(seed, st, prob_old, cfg, num_samps, warmup,
                                 noise=noise)
    return samps["U"].mean(0), samps["V"].mean(0), st.mean_rating


def lookahead_scores(
    seed: int,
    state: NewItemsState,
    problem_new: Problem,
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
    lane_noise: Optional[Callable[[torch.Tensor, int], nuts.NUTSNoise]] = None,
) -> torch.Tensor:
    """exp-variance / exp-entropy-est over the NEW-ITEM submatrix.

    The reference's cold-start MainProgram inherits the full lookahead KEYS
    registry (stan-bpmf/bpmf_newitems.py:48 reusing bpmf.py:544-556): per
    (candidate, value) lane a fresh short phase-2 NUTS run from the mode,
    the statistic integrated under the base chain's Dirichlet-smoothed
    per-cell marginals (bpmf.py:436-443, 483-521). The lanes keep phase 1's
    mean rating, as the JAX package's do.

    ``candidate_tile`` > 0 runs that many candidates (x values) as one
    lockstep batch of lanes at a time (bounds memory; the scores do not
    change). Lane streams are keyed by the global candidate index
    (``utils/rng.lane_generators`` from ``seed``); ``lane_noise(cand,
    n_vals)`` replaces them. Returns flat scores (C,), NaN off the
    queryable pool.
    """
    n, m_new = problem_new.shape
    s = NewItemsShapes(n, m_new, cfg.latent_d)
    device = problem_new.R_obs.device
    dtype = state.mode_q.dtype
    if cand is None:
        cand = torch.arange(n * m_new, device=device)
    cand = torch.as_tensor(cand, device=device).long()
    ii, jj = cand // m_new, cand % m_new
    values = torch.as_tensor(sorted(rating_values), dtype=dtype,
                             device=device)
    n_vals = values.shape[0]
    denom = n_base_samples + dirichlet_alpha * n_vals
    w_c = ((base_stats.bin_counts[:, ii, jj] + dirichlet_alpha) / denom).T

    def logp_of(cells):
        def logp(q):
            return log_posterior(q, problem_new, state.U_fixed,
                                 state.V_fixed, state.mean_rating, cfg, s,
                                 cells=cells)
        return logp

    C = cand.shape[0]
    tile = candidate_tile if candidate_tile and candidate_tile < C else C
    evals = torch.empty((C, n_vals), dtype=dtype, device=device)
    for t0 in range(0, C, tile):
        sl = slice(t0, t0 + tile)
        c_t = cand[sl]
        cells = LaneCells(i=torch.repeat_interleave(ii[sl], n_vals),
                          j=torch.repeat_interleave(jj[sl], n_vals),
                          v=values.repeat(c_t.shape[0]))
        L = len(cells)
        if lane_noise is not None:
            noise = lane_noise(c_t, n_vals)
        else:
            noise = nuts.GeneratorNoise(
                lane_generators(seed, c_t.tolist(), n_vals, device), s.dim,
                cfg.max_depth, dtype, device)
        qs, _ = nuts.run_nuts(noise, state.mode_q.expand(L, s.dim),
                              logp_of(cells), num_samps, warmup,
                              cfg=nuts.NUTSConfig(max_depth=cfg.max_depth))
        V = unpack(qs, s)["V_new"]  # (L, S, m_new, d)
        U = state.U_fixed.expand((L, num_samps) + state.U_fixed.shape)
        mr = state.mean_rating.expand(L)
        if stat == "entropy-est":
            ev = sample_stats.entropy_est_from_factors(U, V, mr,
                                                       cfg.subtract_mean)
        else:
            ev = sample_stats.prediction_stats(
                U, V, mr, cfg.subtract_mean).var.sum((-2, -1))
        evals[sl] = ev.reshape(-1, n_vals)
    scores = (evals * w_c).sum(-1)
    return torch.where(problem_new.queryable[ii, jj], scores, torch.nan)
