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

from amf_tpu_torch.active.driver import Family, _not_ported, drive_active
from amf_tpu_torch.analysis import metrics
from amf_tpu_torch.models import bpmf_gibbs, pmf
from amf_tpu_torch.types import Problem, rating_bounds, ratings_array
from amf_tpu_torch.utils.platform import resolve_device
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

    Not ported yet (raise if given): ``mesh`` (candidate sharding),
    ``checkpoint_path`` and ``replay``.
    """
    del lookahead_host_tiles  # see the docstring
    for k in key_names:
        if k not in KEYS:
            raise ValueError(f"unknown Gibbs criterion {k!r}")
    if mesh is not None:
        raise _not_ported("candidate sharding over a device mesh")
    if checkpoint_path is not None:
        raise _not_ported("checkpoint/resume")
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
        pst = pmf.do_fit(pst, prob, pcfg, fit_type=fit_type)
        return pst, sample(pst, prob, fold_in(k, 2))

    def refit_and_sample(pst, prob, k):
        pst = pmf.refresh_mean_rating(pst, prob)
        pst, _ = pmf.fit(pst, prob, pcfg)
        return pst, sample(pst, prob, k)

    def lookahead(k, pst, prob, stats):
        # vals = () takes the continuous path (normal fit + trapezoid over
        # ppf points, bayes_pmf.py:446-453 semantics)
        cand = torch.nonzero(prob.queryable.flatten())[:, 0]
        scores = bpmf_gibbs.exp_variance_scores(
            k, pst, prob, pcfg, gcfg, stats, vals,
            num_samps=lookahead_samps, n_base_samples=num_samps, cand=cand,
            candidate_tile=lookahead_tile)
        out = torch.full((n * m,), float("nan"), dtype=dtype, device=device)
        out[cand] = scores
        return out.reshape(n, m)

    pst0, stats0 = fit_and_sample(problem, fold_in_name(seed, "init"))

    results: Dict[str, object] = {
        "_real": np.asarray(real),
        "_ratings": ratings_array(problem),
        "_rating_vals": vals or None,
    }

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

    def err(st, prob):
        if binary_acc:
            return metrics.binary_misclassification(st[1].mean, real_t, prob.test)
        return metrics.rmse_on(st[1].mean, real_t, prob.test)

    family = Family(
        nice_name=lambda kname: KEYS[kname].nice_name,
        score=lambda kname, st, prob, k: (
            evals_for(kname, st[0], st[1], prob, k), KEYS[kname].choose_max),
        refit=lambda st, prob, k: refit_and_sample(st[0], prob, k),
        err=err,
    )
    results.update(
        drive_active(problem, real, key_names, family, (pst0, stats0), seed,
                     steps=steps, verbose=verbose, replay=replay))
    return results
