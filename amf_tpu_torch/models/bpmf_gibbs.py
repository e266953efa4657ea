"""Bayesian PMF by Gibbs sampling (mirrors ``amf_tpu/models/bpmf_gibbs.py``).

Salakhutdinov-Mnih BPMF with Gaussian-Wishart hyperpriors, per-row
conditional Gaussian draws, streamed prediction statistics, and the
``exp_variance`` one-step lookahead (reference: python-pmf/bayes_pmf.py
:72-598): for every (candidate cell, rating value) lane, add the rating,
refit the MAP, run a fresh short chain, and sum the predictive variance.

Layout on the card:
  * a chain carries a leading lane dimension: U (L, n, d), V (L, m, d),
    ``mean_rating`` (L,). One chain is the case L = 1;
  * lanes share the base problem's mask and ratings; each lane carries its
    one hypothesised cell (``types.LaneCells``). The masked Gram of every
    row, S_i = sum_j mask_ij v_j v_j^T, is one matrix product of the shared
    mask against each lane's packed lower triangle of v_j v_j^T, plus a
    one-cell correction for the lane's cell; the same holds for the
    right-hand side;
  * each row draw goes through the Cholesky solve-and-sample kernel
    (ops/chol_kernel.py), which reads those products as they are left and
    assembles S and the right-hand side itself;
  * each lane draws the noise of a whole Gibbs round in one call on its own
    generator (utils/rng.py), so launches grow with lanes x rounds and the
    scores do not depend on how candidates are tiled.

Deliberate fix kept from the JAX package: the Gaussian-Wishart posterior
scale uses the outer product of (mu0 - x_bar), where the reference's
``np.dot`` on a 1-D vector gives an inner product (bayes_pmf.py:176).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from amf_tpu_torch.models import pmf
from amf_tpu_torch.ops.chol_kernel import chol_gram_solve_sample, tril_pairs
from amf_tpu_torch.types import LaneCells, Problem
from amf_tpu_torch.utils.rng import lane_gammas, lane_generators, lane_normals


class GibbsConfig(NamedTuple):
    """Static knobs (reference defaults: bayes_pmf.py:73-109)."""

    latent_d: int = 5
    subtract_mean: bool = True
    beta: float = 2.0  # observation noise precision
    b0: float = 2.0  # scale on the Gaussian's precision
    # Wishart scale = I, dof = latent_d, mu0 = 0 (bayes_pmf.py:97-109)
    num_gibbs: int = 2  # factor sweeps per hyperparameter update


@dataclasses.dataclass(frozen=True)
class ChainState:
    U: torch.Tensor  # (n, d) or (L, n, d) current factor sample
    V: torch.Tensor  # (m, d) or (L, m, d)
    mean_rating: torch.Tensor  # () or (L,)


def init_chain(pmf_state: pmf.PMFState) -> ChainState:
    """Start the chain at the MAP estimate (bayes_pmf.py:261-263)."""
    return ChainState(U=pmf_state.U, V=pmf_state.V,
                      mean_rating=pmf_state.mean_rating)


# ---------------------------------------------------------------------------
# Wishart / Gaussian-Wishart sampling


def _nan_where_failed(out: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    """``out`` (..., d, d) of a ``torch.linalg.*_ex`` call, NaN where its
    ``info`` reports a failed factorisation. ``jnp.linalg.cholesky`` gives
    NaN there, and NaN is what reaches the scores and the finite-score
    fallback of ``active/driver.py``; the ``_ex`` calls alone return
    unchecked values.
    Decided on the device: the host does not wait for ``info``."""
    return torch.where((info > 0)[..., None, None], torch.nan, out)


def _cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of A (..., d, d); NaN where A is not positive
    definite."""
    return _nan_where_failed(*torch.linalg.cholesky_ex(A))


def _inverse(A: torch.Tensor) -> torch.Tensor:
    """Inverse of A (..., d, d); NaN where A is singular."""
    return _nan_where_failed(*torch.linalg.inv_ex(A))


def _dof_shape(d: int, dof, like: torch.Tensor) -> torch.Tensor:
    """Gamma shape parameters (dof - k) / 2, k < d, of the Bartlett chi^2s."""
    return (dof - torch.arange(d, dtype=like.dtype, device=like.device)) / 2.0


def sample_wishart(
    sigma: torch.Tensor, dof, *,
    generator: Optional[torch.Generator] = None,
    gamma: Optional[torch.Tensor] = None,
    normal: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Wishart(dof, sigma) draw via the Bartlett decomposition.

    sigma (..., d, d). ``gamma`` (..., d) are standard Gamma draws with
    shapes (dof - k) / 2 and ``normal`` (..., d, d) standard normals (only
    the strictly lower part is used); either is drawn from ``generator``
    when not given.
    """
    d = sigma.shape[-1]
    if gamma is None:
        shape = _dof_shape(d, dof, sigma).expand(sigma.shape[:-1])
        gamma = torch._standard_gamma(shape.contiguous(), generator=generator)
    if normal is None:
        normal = torch.randn(sigma.shape, generator=generator,
                             dtype=sigma.dtype, device=sigma.device)
    chol = _cholesky(sigma)
    a = torch.diag_embed(torch.sqrt(2.0 * gamma)) + torch.tril(normal, -1)
    X = chol @ a
    return X @ X.mT


def sample_hyperparam(
    feats: torch.Tensor, cfg: GibbsConfig, *,
    generator: Optional[torch.Generator] = None,
    gamma: Optional[torch.Tensor] = None,
    normal_w: Optional[torch.Tensor] = None,
    normal_mu: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gaussian-Wishart posterior draw of (mu, alpha) given factors
    feats (..., N, d) (reference: bayes_pmf.sample_hyperparam :157-186, with
    the outer-product fix). ``gamma``/``normal_w`` feed the Wishart draw,
    ``normal_mu`` (..., d) the mean draw."""
    N, d = feats.shape[-2:]
    x_bar = feats.mean(dim=-2)
    centered = feats - x_bar[..., None, :]
    S_bar = centered.mT @ centered / (N - 1)  # np.cov ddof=1 (bayes_pmf.py:169)

    eye = torch.eye(d, dtype=feats.dtype, device=feats.device)
    # mu0 = 0, so mu0 - x_bar = -x_bar and its outer product is x_bar x_bar^T
    WI_post = _inverse(
        eye + N * S_bar
        + (cfg.b0 * N) / (cfg.b0 + N) * (x_bar[..., :, None] * x_bar[..., None, :])
    )
    WI_post = (WI_post + WI_post.mT) / 2

    alpha = sample_wishart(WI_post, d + N, generator=generator, gamma=gamma,
                           normal=normal_w)
    mu_temp = (N * x_bar) / (cfg.b0 + N)
    lam = _cholesky(_inverse((cfg.b0 + N) * alpha))
    if normal_mu is None:
        normal_mu = torch.randn(x_bar.shape, generator=generator,
                                dtype=feats.dtype, device=feats.device)
    mu = (lam @ normal_mu[..., None])[..., 0] + mu_temp
    return mu, alpha


# ---------------------------------------------------------------------------
# Batched conditional factor draws


def _gram_products(
    mask: torch.Tensor, masked_r: torch.Tensor, other: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every lane's masked Gram and right-hand-side products, rows minor,
    as the solve-and-sample kernel reads them.

    mask, masked_r (r, c) shared by all lanes, other (L, c, d). With
    p = d (d + 1) / 2: Gt (L, p + d, r) holds, for every row i, the packed
    lower triangle of sum_j mask_ij o_j o_j^T and then sum_j mask_ij o_j;
    mrt (L, d, r) holds sum_j masked_r_ij o_j. Two matrix products; only
    the p distinct products o_a o_b are formed.
    """
    L, c, d = other.shape
    r = mask.shape[0]
    a, b = tril_pairs(d, other.device)
    p = a.shape[0]
    ot = other.mT
    Xt = other.new_empty((L, p + d, c))
    torch.mul(ot[:, a], ot[:, b], out=Xt[:, :p])
    Xt[:, p:] = ot
    Gt = (Xt.view(L * (p + d), c) @ mask.T).view(L, p + d, r)
    mrt = torch.bmm(Xt[:, p:], masked_r.T.expand(L, c, r))
    return Gt, mrt


def _sample_rows(
    mask: torch.Tensor,
    masked_r: torch.Tensor,
    other: torch.Tensor,
    mu: torch.Tensor,
    alpha: torch.Tensor,
    beta: float,
    z: torch.Tensor,
    *,
    center: Optional[torch.Tensor] = None,
    cells: Optional[Tuple[torch.Tensor, ...]] = None,
    chol_kernel: bool = True,
) -> torch.Tensor:
    """Draw all rows of one factor, for L lanes, from their conditionals.

    Per lane l and row i: precision S_i = alpha + beta sum_j m_ij v_j v_j^T,
    mean S_i^{-1} (beta sum_j m_ij (r_ij - c) v_j + alpha mu)
    (reference: bayes_pmf.sample_feature :189-216, one row at a time).

    mask (r, c) 0/1 and masked_r = mask * ratings (r, c) are shared by all
    lanes; other (L, c, d), mu (L, d), alpha (L, d, d), z (L, r, d) standard
    normals; ``center`` (L,) is subtracted from every rating (the chain's
    mean rating). ``cells`` = (row, col, dm, dr), each (L,), adds lane l's
    one hypothesised cell: the mask rises by dm and mask * ratings by dr at
    (row, col). The draw itself, with the assembly of S and the right-hand
    side, is ``ops/chol_kernel.chol_gram_solve_sample``: ``chol_kernel``
    picks its CUDA kernel or its plain version for CUDA tensors.
    """
    Gt, mrt = _gram_products(mask, masked_r, other)
    return chol_gram_solve_sample(Gt, mrt, z, alpha, mu, beta, center, cells,
                                  other, kernel=chol_kernel)


class RoundNoise(NamedTuple):
    """All random draws of one Gibbs round, for L lanes."""

    gamma_u: torch.Tensor  # (L, d) Wishart Gamma draws, U side
    normal_wu: torch.Tensor  # (L, d, d) Wishart normals, U side
    normal_mu_u: torch.Tensor  # (L, d)
    gamma_v: torch.Tensor
    normal_wv: torch.Tensor
    normal_mu_v: torch.Tensor
    z_u: torch.Tensor  # (num_gibbs, L, n, d) row-draw normals
    z_v: torch.Tensor  # (num_gibbs, L, m, d)


def draw_round_noise(generators: Sequence[torch.Generator], n: int, m: int,
                     cfg: GibbsConfig, dtype, device) -> RoundNoise:
    """One round's draws: one normal and one Gamma call per lane."""
    d, g = cfg.latent_d, cfg.num_gibbs
    L = len(generators)
    sizes = [d * d, d, d * d, d, g * n * d, g * m * d]
    flat = lane_normals(generators, sum(sizes), dtype, device)
    wu, mu_u, wv, mu_v, zu, zv = torch.split(flat, sizes, dim=1)
    like = flat[:1, :1]
    shape = torch.cat([_dof_shape(d, d + n, like), _dof_shape(d, d + m, like)])
    gam = lane_gammas(generators, shape)
    return RoundNoise(
        gamma_u=gam[:, :d], normal_wu=wu.reshape(L, d, d), normal_mu_u=mu_u,
        gamma_v=gam[:, d:], normal_wv=wv.reshape(L, d, d), normal_mu_v=mu_v,
        z_u=zu.reshape(L, g, n, d).transpose(0, 1),
        z_v=zv.reshape(L, g, m, d).transpose(0, 1),
    )


class _Base(NamedTuple):
    """The shared problem as the row draws read it, both orientations."""

    mask: torch.Tensor  # (n, m) 0/1 float
    masked_r: torch.Tensor  # (n, m) rated * R_obs
    mask_t: torch.Tensor  # (m, n)
    masked_r_t: torch.Tensor


def _base(problem: Problem, dtype) -> _Base:
    mask = problem.rated.to(dtype)
    masked_r = torch.where(problem.rated, problem.R_obs, 0.0).to(dtype)
    return _Base(mask, masked_r, mask.t().contiguous(),
                 masked_r.t().contiguous())


def _gibbs_round(chain: ChainState, base: _Base, cfg: GibbsConfig,
                 noise: RoundNoise, cells: Optional[LaneCells],
                 deltas, chol_kernel: bool) -> ChainState:
    mu_u, alpha_u = sample_hyperparam(
        chain.U, cfg, gamma=noise.gamma_u, normal_w=noise.normal_wu,
        normal_mu=noise.normal_mu_u)
    mu_v, alpha_v = sample_hyperparam(
        chain.V, cfg, gamma=noise.gamma_v, normal_w=noise.normal_wv,
        normal_mu=noise.normal_mu_v)
    center = chain.mean_rating if cfg.subtract_mean else None
    cells_u = cells_v = None
    if cells is not None:
        cells_u = (cells.i, cells.j) + deltas
        cells_v = (cells.j, cells.i) + deltas
    U, V = chain.U, chain.V
    for s in range(cfg.num_gibbs):
        U = _sample_rows(base.mask, base.masked_r, V, mu_u, alpha_u, cfg.beta,
                         noise.z_u[s], center=center, cells=cells_u,
                         chol_kernel=chol_kernel)
        V = _sample_rows(base.mask_t, base.masked_r_t, U, mu_v, alpha_v,
                         cfg.beta, noise.z_v[s], center=center, cells=cells_v,
                         chol_kernel=chol_kernel)
    return ChainState(U=U, V=V, mean_rating=chain.mean_rating)


def gibbs_round(chain: ChainState, problem: Problem, cfg: GibbsConfig,
                noise: RoundNoise, cells: Optional[LaneCells] = None,
                chol_kernel: bool = True) -> ChainState:
    """One hyperparameter draw + num_gibbs factor sweeps for a lane-batched
    chain (reference: bayes_pmf.samples :277-302)."""
    deltas = cells.deltas(problem) if cells is not None else None
    return _gibbs_round(chain, _base(problem, chain.U.dtype), cfg, noise,
                        cells, deltas, chol_kernel)


# ---------------------------------------------------------------------------
# Chains with streamed prediction statistics


class PredStats(NamedTuple):
    """Streamed statistics of the predicted matrix over a sample chain."""

    mean: torch.Tensor  # (..., n, m) E[R_ij]
    var: torch.Tensor  # (..., n, m) Var[R_ij]
    prob_ge: torch.Tensor  # (..., n_cutoffs, n, m) P(R_ij >= cutoff)
    bin_counts: Optional[torch.Tensor]  # (..., n_bins, n, m) value histogram


def run_chain(
    chain: ChainState,
    problem: Problem,
    cfg: GibbsConfig,
    num_samps: int,
    *,
    generator: Optional[torch.Generator] = None,
    generators: Optional[List[torch.Generator]] = None,
    cutoffs: Tuple[float, ...] = (),
    value_bounds: Optional[Tuple[float, ...]] = None,
    keep_samples: bool = False,
    cells: Optional[LaneCells] = None,
    chol_kernel: bool = True,
) -> Tuple[ChainState, PredStats, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Run ``num_samps`` Gibbs rounds, streaming prediction statistics.

    One chain (U (n, d)) draws from ``generator``. A lane-batched chain
    (U (L, n, d)) draws lane l's noise from ``generators[l]`` and, with
    ``cells``, runs on the base problem plus each lane's cell.
    value_bounds: rating-bin edges (types.rating_bounds) for the per-bin
    counts of the discrete lookahead (reference: bayes_pmf._distribute
    :489-501). No (num_samps, n, m) tensor is formed: the sums of pred and
    pred^2 are accumulated in place.
    """
    single = chain.U.dim() == 2
    if single:
        chain = ChainState(chain.U[None], chain.V[None],
                           chain.mean_rating.reshape(1))
        generators = [generator]
    n, m = problem.shape
    L = chain.U.shape[0]
    dtype, device = chain.U.dtype, chain.U.device
    base = _base(problem, dtype)
    deltas = cells.deltas(problem) if cells is not None else None
    n_cut = len(cutoffs)
    cut = torch.as_tensor(cutoffs, dtype=dtype, device=device).reshape(
        n_cut, 1, 1)
    n_bins = 0
    if value_bounds is not None:
        edges = torch.as_tensor(np.asarray(value_bounds), dtype=dtype,
                                device=device)
        n_bins = edges.shape[0] - 1
        lo, hi = edges[:-1, None, None], edges[1:, None, None]

    s1 = torch.zeros((L, n, m), dtype=dtype, device=device)
    s2 = torch.zeros_like(s1)
    ge = torch.zeros((L, n_cut, n, m), dtype=dtype, device=device)
    bins = torch.zeros((L, n_bins, n, m), dtype=dtype, device=device)
    samples = []
    for _ in range(num_samps):
        noise = draw_round_noise(generators, n, m, cfg, dtype, device)
        chain = _gibbs_round(chain, base, cfg, noise, cells, deltas,
                             chol_kernel)
        pred = chain.U @ chain.V.mT
        if cfg.subtract_mean:
            pred.add_(chain.mean_rating[:, None, None])
        s1 += pred
        s2.addcmul_(pred, pred)
        if n_cut:
            ge += (pred[:, None] >= cut).to(dtype)
        if n_bins:
            p = pred[:, None]
            bins += ((p >= lo) & (p < hi)).to(dtype)
        if keep_samples:
            samples.append((chain.U, chain.V))
        del pred

    mean = s1.div_(num_samps)
    var = s2.div_(num_samps).sub_(mean * mean).clamp_(min=0.0)  # ddof=0
    stats = PredStats(mean=mean, var=var, prob_ge=ge / num_samps,
                      bin_counts=bins if n_bins else None)
    out = None
    if keep_samples:
        out = (torch.stack([u for u, _ in samples], dim=1),
               torch.stack([v for _, v in samples], dim=1))
    if single:
        chain = ChainState(chain.U[0], chain.V[0], chain.mean_rating[0])
        stats = PredStats(*(None if x is None else x[0] for x in stats))
        out = None if out is None else (out[0][0], out[1][0])
    return chain, stats, out


# ---------------------------------------------------------------------------
# exp-variance lookahead (reference: bayes_pmf.exp_variance :457-468,
# _integrate_lookahead :560-598)


def _lane_total_variance(
    seed: int, pmf_state: pmf.PMFState, problem: Problem,
    pcfg: pmf.PMFConfig, cfg: GibbsConfig, cand: torch.Tensor,
    vals: torch.Tensor, num_samps: int, fit_first: bool, fit_budget: int,
    poly_ls: bool, chol_kernel: bool,
) -> torch.Tensor:
    """(C, V) total predictive variance after adding value vals[c, v] at
    candidate cand[c]: one lane per (candidate, value), all in lockstep."""
    n, m = problem.shape
    C, n_vals = vals.shape
    L = C * n_vals
    cells = LaneCells(i=torch.repeat_interleave(cand // m, n_vals),
                      j=torch.repeat_interleave(cand % m, n_vals),
                      v=vals.reshape(L))
    pst = dataclasses.replace(
        pmf_state,
        U=pmf_state.U.expand(L, n, pcfg.latent_d),
        V=pmf_state.V.expand(L, m, pcfg.latent_d),
        mean_rating=pmf_state.mean_rating.expand(L))
    if fit_first:
        pst = pmf.refresh_mean_rating(pst, problem, cells)
        pst, _ = pmf.fit(pst, problem, pcfg, max_steps=fit_budget,
                         poly_ls=poly_ls, lanes=cells)
    gens = lane_generators(seed, cand.tolist(), n_vals, problem.R_obs.device)
    _, stats, _ = run_chain(init_chain(pst), problem, cfg, num_samps,
                            generators=gens, cells=cells,
                            chol_kernel=chol_kernel)
    # total variance over ALL cells: the reference's lookahead calls
    # total_variance with which=Ellipsis (bayes_pmf.py:565-569)
    return stats.var.sum(dim=(-2, -1)).reshape(C, n_vals)


def exp_variance_scores(
    seed: int,
    pmf_state: pmf.PMFState,
    problem: Problem,
    pcfg: pmf.PMFConfig,
    cfg: GibbsConfig,
    base_stats: PredStats,
    rating_values: Tuple[float, ...],
    num_samps: int = 30,
    fit_first: bool = True,
    fit_budget: int = 200,
    cand=None,
    dirichlet_alpha: float = 0.1,
    n_base_samples: int = 128,
    candidate_tile: int = 0,
    num_integration_pts: int = 50,
    poly_ls: bool = True,
    chol_kernel: bool = True,
) -> torch.Tensor:
    """E[total Var[R]] after hypothetically observing each candidate cell.

    Weights: the Dirichlet-smoothed histogram of the base chain's
    predictions per cell (reference: bayes_pmf.py:489-501); with no
    ``rating_values``, a fitted normal integrated by trapezoid over ppf
    points (:446-453). Each (candidate, value) lane refits the MAP
    (``fit_first``) and runs a fresh ``num_samps`` chain. ``cand`` are flat
    cell indices (default: every cell); ``candidate_tile`` > 0 runs that
    many candidates at a time (bounds memory; the scores do not change).
    ``seed`` roots the lane streams. Returns flat scores (C,), NaN off the
    queryable pool.
    """
    n, m = problem.shape
    device = problem.R_obs.device
    dtype = pmf_state.U.dtype
    if cand is None:
        cand = torch.arange(n * m, device=device)
    cand = torch.as_tensor(cand, device=device).long()
    ii, jj = cand // m, cand % m

    if rating_values and base_stats.bin_counts is None:
        raise ValueError(
            "rating_values given but base_stats has no bin_counts — run the "
            "base chain with value_bounds for the discrete lookahead")
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
        z = torch.as_tensor(z, dtype=dtype, device=device)
        mean_c = base_stats.mean[ii, jj]
        std_c = torch.sqrt(base_stats.var[ii, jj].clamp(min=1e-12))
        vals_c = mean_c[:, None] + std_c[:, None] * z
        w_c = torch.as_tensor(w, dtype=dtype, device=device).expand(
            vals_c.shape)

    C = cand.shape[0]
    tile = candidate_tile if candidate_tile and candidate_tile < C else C
    evals = torch.empty(vals_c.shape, dtype=dtype, device=device)
    for t0 in range(0, C, tile):
        sl = slice(t0, t0 + tile)
        evals[sl] = _lane_total_variance(
            seed, pmf_state, problem, pcfg, cfg, cand[sl], vals_c[sl],
            num_samps, fit_first, fit_budget, poly_ls, chol_kernel)

    scores = (evals * w_c).sum(dim=-1)
    return torch.where(problem.queryable[ii, jj], scores, float("nan"))
