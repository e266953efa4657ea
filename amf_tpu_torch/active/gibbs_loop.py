"""Active-learning loop for the Gibbs BPMF model
(mirrors ``amf_tpu/active/gibbs_loop.py``).

Capability parity with the reference's ``bayes_pmf.full_test`` /
``compare_active`` (python-pmf/bayes_pmf.py:657-825): criterion registry
KEYS, query/test-set splitting, per-step MAP refit + fresh sample chain,
results in the reference schema.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from amf_tpu_torch.active.driver import Family, drive_active
from amf_tpu_torch.analysis import metrics
from amf_tpu_torch.models import bpmf_gibbs, pmf
from amf_tpu_torch.parallel.mesh import is_lead
from amf_tpu_torch.parallel.sharding import sharded_candidate_scores
from amf_tpu_torch.types import Problem, rating_bounds, ratings_array
from amf_tpu_torch.utils.checkpoint import LoopCheckpointer
from amf_tpu_torch.utils.platform import resolve_device
from amf_tpu_torch.utils.profiling import span
from amf_tpu_torch.utils.rng import fold_in, fold_in_name, generator


class GibbsKey(NamedTuple):
    nice_name: str
    kind: str  # 'random' | 'pred-variance' | 'exp-variance' | 'pred' | 'prob-ge'
    choose_max: bool
    cutoff: Optional[float] = None


# reference: bayes_pmf.KEYS :660-670
KEYS = {
    "random": GibbsKey("Random", "random", True),
    "pred-variance": GibbsKey("Var[R_ij]", "pred-variance", True),
    "exp-variance": GibbsKey("E[Var[R]]", "exp-variance", False),
    "pred": GibbsKey("Pred", "pred", True),
    "prob-ge-3.5": GibbsKey("Prob >= 3.5", "prob-ge", True, 3.5),
    "prob-ge-.5": GibbsKey("Prob >= .5", "prob-ge", True, 0.5),
    "prob-ge-0": GibbsKey("Prob >= 0", "prob-ge", True, 0.0),
}

_CUTOFFS = (3.5, 0.5, 0.0)


def split_query_test(
    real: np.ndarray,
    ratings: np.ndarray,
    test_set: str = "all",
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(query_on, test_on) masks (reference: compare_active :739-772).

    test_set: 'all' (test on every knowable cell, query on all unrated
    knowable); a float fraction; or an integer count of test cells.
    """
    rng = rng or np.random.default_rng(0)
    knowable = np.isfinite(real) & (real != 0)
    pickable = knowable.copy()
    pickable[ratings[:, 0].astype(int), ratings[:, 1].astype(int)] = False

    if test_set == "all":
        return pickable, knowable
    t = float(test_set)
    if t % 1 == 0 and t != 1:
        avail = np.transpose(pickable.nonzero())
        picked = avail[rng.choice(len(avail), size=int(t), replace=False)]
        picker = np.zeros(pickable.shape, bool)
        picker[tuple(picked.T)] = True
    else:
        picker = rng.binomial(1, t, size=pickable.shape).astype(bool)
    test_on = picker & pickable
    query_on = ~picker & pickable
    return query_on, test_on


def gibbs_family(
    problem: Problem,
    real: np.ndarray,
    latent_d: int = 5,
    rating_values: Tuple[float, ...] = (),
    subtract_mean: bool = True,
    num_samps: int = 128,
    lookahead_samps: int = 30,
    lookahead_tile: int = 0,
    seed: int = 0,
    fit_type: tuple = ("batch",),
    pcfg: Optional[pmf.PMFConfig] = None,
    dtype=torch.float64,
    device="cuda",
    binary_acc: bool = False,
    mesh=None,
) -> Tuple[Problem, Family, tuple]:
    """The Gibbs family's callables and its initial state: (the problem on
    ``device`` in ``dtype``, the :class:`Family`, (PMF state, statistics)
    of the initial fit and chain under ``fold_in_name(seed, "init")``).
    Shared by the host loop and the scan sweep (``active/scan_loop``).
    ``mesh`` shards the ``exp-variance`` candidates over its ranks."""
    device = resolve_device(device)
    n, m = problem.shape
    problem = problem.to(device=device, dtype=dtype)
    pcfg = pcfg or pmf.PMFConfig(latent_d=latent_d, subtract_mean=subtract_mean)
    gcfg = bpmf_gibbs.GibbsConfig(latent_d=latent_d, subtract_mean=subtract_mean)

    vals = tuple(sorted(rating_values)) if rating_values else ()
    bounds = tuple(rating_bounds(vals)) if vals else None
    real_t = torch.as_tensor(np.asarray(real, dtype=np.float64),
                             device=device).to(dtype)

    def sample(pst, prob, k):
        _, stats, _ = bpmf_gibbs.run_chain(
            bpmf_gibbs.init_chain(pst), prob, gcfg, num_samps,
            generator=generator(k, device), cutoffs=_CUTOFFS,
            value_bounds=bounds)
        return stats

    def fit_and_sample(prob, k):
        pst = pmf.init_state(generator(fold_in(k, 1), device), n, m, pcfg,
                             prob, dtype=dtype, device=device)
        # 'mini-valid' draws its permutations and validation cells from
        # the step's seed, as the JAX package's draw from its key
        pst = pmf.do_fit(pst, prob, pcfg, fit_type=fit_type,
                         generator=generator(k, device))
        return pst, sample(pst, prob, fold_in(k, 2))

    def refit_and_sample(pst, prob, k):
        pst = pmf.refresh_mean_rating(pst, prob)
        pst, _ = pmf.fit(pst, prob, pcfg)
        return pst, sample(pst, prob, k)

    def lookahead(k, pst, prob, stats):
        # vals = () takes the continuous path (normal fit + trapezoid over
        # ppf points, bayes_pmf.py:446-453 semantics)
        cand = torch.nonzero(prob.queryable.flatten())[:, 0]
        if not len(cand):  # a scan sweep scores after the pool is exhausted
            return torch.full((n, m), torch.nan, dtype=dtype, device=device)

        def score_flat(c, kk):
            return bpmf_gibbs.exp_variance_scores(
                kk, pst, prob, pcfg, gcfg, stats, vals,
                num_samps=lookahead_samps, n_base_samples=num_samps,
                cand=c, candidate_tile=lookahead_tile)

        return sharded_candidate_scores(score_flat, n * m, mesh,
                                        cand)(k).reshape(n, m)

    def evals_for(kname: str, pst, stats, prob, k):
        spec = KEYS[kname]
        if spec.kind == "random":
            ev = torch.rand((n, m), generator=generator(k, device),
                            dtype=dtype, device=device)
        elif spec.kind == "pred-variance":
            ev = stats.var
        elif spec.kind == "pred":
            ev = stats.mean
        elif spec.kind == "prob-ge":
            ev = stats.prob_ge[_CUTOFFS.index(spec.cutoff)]
        elif spec.kind == "exp-variance":
            ev = lookahead(k, pst, prob, stats)
        else:
            raise ValueError(spec.kind)
        return torch.where(prob.queryable, ev, float("nan"))

    # the family's callables are the spans active.score, active.refit and
    # active.err
    def score(kname, st, prob, k):
        with span("active.score"):
            return (evals_for(kname, st[0], st[1], prob, k),
                    KEYS[kname].choose_max)

    def refit(st, prob, k):
        with span("active.refit"):
            return refit_and_sample(st[0], prob, k)

    def err(st, prob):
        with span("active.err"):
            if binary_acc:
                return metrics.binary_misclassification(st[1].mean, real_t,
                                                        prob.test)
            return metrics.rmse_on(st[1].mean, real_t, prob.test)

    family = Family(nice_name=lambda kname: KEYS[kname].nice_name,
                    score=score, refit=refit, err=err)
    return problem, family, fit_and_sample(problem, fold_in_name(seed, "init"))


def run_active_gibbs(
    problem: Problem,
    real: np.ndarray,
    key_names: Sequence[str],
    latent_d: int = 5,
    rating_values: Tuple[float, ...] = (),
    subtract_mean: bool = True,
    num_samps: int = 128,
    lookahead_samps: int = 30,
    lookahead_tile: int = 0,
    lookahead_host_tiles: bool = False,
    steps: Optional[int] = None,
    seed: int = 0,
    fit_type: tuple = ("batch",),
    pcfg: Optional[pmf.PMFConfig] = None,
    mesh=None,
    dtype=torch.float64,
    device="cuda",
    verbose: bool = False,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 20,
    binary_acc: bool = False,
    replay: Optional[Dict[str, list]] = None,
) -> Dict[str, object]:
    """Multi-criterion Gibbs active loop (reference: compare_active :733-825).

    The lookahead scores the queryable cells ``lookahead_tile`` candidates
    (x values) at a time, each tile one batch of lanes dispatched from the
    host; ``lookahead_host_tiles`` is accepted for the JAX package's CLI and
    means the same. ``lookahead_tile=0`` scores the whole pool in one tile.

    binary_acc: record binary misclassification instead of RMSE (the
    reference's DrugBank metric, stan-bpmf/bpmf.py:53-54).

    device: ``cuda`` by default; without a card that raises
    (``utils.platform.resolve_device``). The CPU runs only when named.

    checkpoint_path: a partial-results pickle written every
    ``checkpoint_every`` steps and at each criterion's end; a run given an
    existing one resumes from its recorded picks (``active/driver.py``).
    ``replay`` re-runs recorded pick lists.

    mesh (``parallel.mesh.CandidateMesh``): every rank runs the loop on the
    same state and scores its shard of the ``exp-variance`` candidates; one
    gather gives every rank every score (``parallel/sharding``). Only rank
    0 prints and writes the checkpoint.
    """
    del lookahead_host_tiles  # see the docstring
    for k in key_names:
        if k not in KEYS:
            raise ValueError(f"unknown Gibbs criterion {k!r}")
    problem, family, state0 = gibbs_family(
        problem, real, latent_d=latent_d, rating_values=rating_values,
        subtract_mean=subtract_mean, num_samps=num_samps,
        lookahead_samps=lookahead_samps, lookahead_tile=lookahead_tile,
        seed=seed, fit_type=fit_type, pcfg=pcfg, dtype=dtype, device=device,
        binary_acc=binary_acc, mesh=mesh)
    results: Dict[str, object] = {
        "_real": np.asarray(real),
        "_ratings": ratings_array(problem),
        "_rating_vals": tuple(sorted(rating_values)) or None,
    }
    ckpt = LoopCheckpointer.for_problem(checkpoint_path, problem, real,
                                        every=checkpoint_every,
                                        write=is_lead(mesh))
    results.update(
        drive_active(problem, real, key_names, family, state0, seed,
                     steps=steps, ckpt=ckpt, verbose=verbose and is_lead(mesh),
                     replay=replay, mesh=mesh))
    return results
