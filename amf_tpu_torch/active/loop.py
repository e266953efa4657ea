"""The active-learning loop for the variational-PMF models
(mirrors ``amf_tpu/active/loop.py``).

Capability parity with the reference drivers ``full_test`` /
``_full_test_threaded`` / ``compare`` (python-pmf/active_pmf.py:796-1092,
mn_active_pmf.py): per criterion, loop {score every queryable cell, query the
best, refit} and record ``(num_rated, rmse, (i, j), evals_matrix)`` tuples in
the reference results schema (plot_results.py:160-166), on the shared
driver (``active.driver.drive_active``). Criteria run one after another
from the same initial state; states are never modified in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from amf_tpu_torch.active import criteria as criteria_mod
from amf_tpu_torch.active import lookahead as lookahead_mod
from amf_tpu_torch.active.driver import Family, drive_active
from amf_tpu_torch.analysis import metrics
from amf_tpu_torch.models import mnormal, pmf, vnormal
from amf_tpu_torch.parallel.mesh import is_lead
from amf_tpu_torch.parallel.sharding import sharded_candidate_scores
from amf_tpu_torch.types import Problem, ratings_array
from amf_tpu_torch.utils.checkpoint import LoopCheckpointer
from amf_tpu_torch.utils.platform import resolve_device
from amf_tpu_torch.utils.rng import fold_in_name, generator

# proposal budget of the loop's own KL fits (the JAX package's 10_000)
APPROX_FIT_STEPS = 10_000


def _cast(state, dtype, device):
    """A state's tensors on ``device``, floats in ``dtype``."""
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).to(
            device=device,
            dtype=dtype if getattr(state, f.name).is_floating_point() else None)
        for f in dataclasses.fields(state)})


def active_pmf_family(
    problem: Problem,
    real: np.ndarray,
    key_names: Sequence[str],
    latent_d: int = 5,
    rating_values: Tuple[float, ...] = (),
    discrete_exp=False,
    refit_lookahead: bool = False,
    fit_sigmas: bool = False,
    seed: int = 0,
    model: str = "vn",  # 'vn' (ActivePMF) | 'mn' (MNActivePMF)
    pcfg: Optional[pmf.PMFConfig] = None,
    lookahead_budget: int = 300,
    lookahead_tile: int = 0,
    cov_param: str = "psd-project",  # vn only: 'chol' = eigh-free descent
    dtype=torch.float64,
    device=None,
    initial_state=None,
    mesh=None,
) -> Tuple[Problem, Family, tuple]:
    """The variational family's callables and its initial state: (the
    problem on ``device`` in ``dtype``, the :class:`Family`, (PMF state,
    approximation or None)), the approximation fitted when a criterion of
    ``key_names`` needs it. Shared by the host loop and the scan sweep
    (``active/scan_loop``); the arguments are :func:`run_active_pmf`'s.
    ``mesh`` shards the lookahead criteria's candidates over its ranks."""
    registry = (criteria_mod.KEY_FUNCS if model == "vn"
                else criteria_mod.MN_KEY_FUNCS)
    for k in key_names:
        if k not in registry:
            raise ValueError(f"unknown criterion {k!r} for model {model!r}")
    device = resolve_device(device)
    n, m = problem.shape
    problem = problem.to(device=device, dtype=dtype)
    pcfg = pcfg or pmf.PMFConfig(latent_d=latent_d)

    if model == "vn":
        adapter = lookahead_mod.vn_adapter(
            vnormal.VNConfig(latent_d=latent_d, cov_param=cov_param))
    else:
        adapter = lookahead_mod.mn_adapter(mnormal.MNConfig(latent_d=latent_d))
    discretize = (discrete_exp if isinstance(discrete_exp, str)
                  else ("sum" if discrete_exp else "continuous"))
    lcfg = lookahead_mod.LookaheadConfig(
        rating_values=tuple(rating_values or ()),
        refit_lookahead=refit_lookahead, discretize=discretize,
        pmf_refit_steps=lookahead_budget, approx_refit_steps=lookahead_budget,
        candidate_tile=lookahead_tile)
    needs_approx = any(registry[k].needs_approx for k in key_names)

    def init_approx(pst, seed_):
        """A fresh approximation at ``pst``, its noise from ``seed_``."""
        noise = None
        if adapter.noise_size is not None:
            k = adapter.noise_size(n, m)
            noise = torch.randn((k, k), generator=generator(seed_, device),
                                dtype=dtype, device=device)
        return adapter.init_approx(pst, noise)

    def fit_pmf(pst, prob):
        if fit_sigmas:
            return pmf.fit_with_sigmas(pst, prob, pcfg)
        return pmf.fit(pst, prob, pcfg)[0]

    # ---- initial fit, shared by all criteria (reference: :1043-1055)
    kapprox = fold_in_name(seed, "approx")
    if initial_state is not None:
        pst, ast = initial_state
        pst = _cast(pst, dtype, device)
        if tuple(pst.U.shape) != (n, pcfg.latent_d):
            raise ValueError(f"loaded model shape {tuple(pst.U.shape)} does "
                             f"not match problem ({n}, {pcfg.latent_d})")
        if ast is not None:
            ast = _cast(ast, dtype, device)
    else:
        pst = pmf.init_state(generator(fold_in_name(seed, "init"), device),
                             n, m, pcfg, problem, dtype=dtype, device=device)
        pst, ast = fit_pmf(pst, problem), None
    if needs_approx and ast is None:
        ast = adapter.fit_approx(init_approx(pst, kapprox), pst, problem,
                                 APPROX_FIT_STEPS)

    real_t = torch.as_tensor(np.asarray(real, dtype=np.float64),
                             device=device).to(dtype)

    def refit(st, prob, k):
        pst, ast = st
        pst = fit_pmf(pmf.refresh_mean_rating(pst, prob), prob)
        if needs_approx:
            if refit_lookahead:
                ast = init_approx(pst, k)
            ast = adapter.fit_approx(ast, pst, prob, APPROX_FIT_STEPS)
        return pst, ast

    def score(kname, st, prob, k):
        crit = registry[kname]
        pst, ast = st
        if crit.kind == "direct":
            amv = adapter.pred_mean_var(ast, prob) if crit.needs_approx else None
            ev = criteria_mod.direct_scores(
                crit, pmf.predicted_matrix(pst, pcfg), amv,
                generator(k, device))
            return torch.where(prob.queryable, ev, torch.nan), crit.maximize
        cand = torch.nonzero(prob.queryable.flatten())[:, 0]
        if not len(cand):  # a scan sweep scores after the pool is exhausted
            return (torch.full((n, m), torch.nan, dtype=dtype, device=device),
                    crit.maximize)

        def score_flat(c, kk):
            return lookahead_mod.lookahead_scores(
                crit, pst, ast, prob, kk, pcfg, adapter, lcfg, cand=c)

        ev = sharded_candidate_scores(score_flat, n * m, mesh, cand)(k)
        return ev.reshape(n, m), crit.maximize

    family = Family(
        nice_name=lambda kname: registry[kname].nice_name,
        score=score,
        refit=refit,
        err=lambda st, prob: metrics.rmse_on(
            pmf.predicted_matrix(st[0], pcfg), real_t, prob.test),
    )
    return problem, family, (pst, ast)


def run_active_pmf(
    problem: Problem,
    real: np.ndarray,
    key_names: Sequence[str],
    latent_d: int = 5,
    rating_values: Tuple[float, ...] = (),
    discrete_exp=False,
    refit_lookahead: bool = False,
    fit_sigmas: bool = False,
    steps: Optional[int] = None,
    seed: int = 0,
    model: str = "vn",  # 'vn' (ActivePMF) | 'mn' (MNActivePMF)
    pcfg: Optional[pmf.PMFConfig] = None,
    lookahead_budget: int = 300,
    lookahead_tile: int = 0,
    cov_param: str = "psd-project",  # vn only: 'chol' = eigh-free descent
    dtype=torch.float64,
    device=None,
    verbose: bool = False,
    initial_state=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 20,
    mesh=None,
) -> Dict[str, object]:
    """Run the multi-criterion comparison (reference: compare(),
    active_pmf.py:1013-1092). Returns the reference results schema.

    Lookahead criteria score the queryable cells ``lookahead_tile``
    candidates a tile (0: the whole pool in one tile), each tile one batch
    of lanes dispatched from the host. ``initial_state`` =
    (pmf state, approximation or None) is reused instead of the initial fit
    (reference: --load-model, active_pmf.py:1131, :1214-1215); the results
    keep the initial state under ``_initial_state``.

    device: the card by default; without one that raises
    (``utils.platform.resolve_device``). The CPU runs only when named.

    checkpoint_path: a partial-results pickle written every
    ``checkpoint_every`` steps and at each criterion's end; a run given an
    existing one resumes from its recorded picks (``active/driver.py``).

    mesh (``parallel.mesh.CandidateMesh``): every rank runs the loop on the
    same state and scores its shard of a lookahead criterion's candidates;
    one gather gives every rank every score (``parallel/sharding``). Only
    rank 0 prints and writes the checkpoint.
    """
    problem, family, state0 = active_pmf_family(
        problem, real, key_names, latent_d=latent_d,
        rating_values=rating_values, discrete_exp=discrete_exp,
        refit_lookahead=refit_lookahead, fit_sigmas=fit_sigmas, seed=seed,
        model=model, pcfg=pcfg, lookahead_budget=lookahead_budget,
        lookahead_tile=lookahead_tile, cov_param=cov_param, dtype=dtype,
        device=device, initial_state=initial_state, mesh=mesh)
    results: Dict[str, object] = {
        "_real": np.asarray(real),
        "_ratings": ratings_array(problem),
        "_rating_vals": tuple(rating_values) if rating_values else None,
        "_initial_state": state0,
    }
    ckpt = LoopCheckpointer.for_problem(checkpoint_path, problem, real,
                                        every=checkpoint_every,
                                        write=is_lead(mesh))
    results.update(drive_active(problem, real, key_names, family, state0,
                                seed, steps=steps, ckpt=ckpt,
                                verbose=verbose and is_lead(mesh), mesh=mesh))
    return results
