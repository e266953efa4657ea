"""Active-learning loop for the NUTS BPMF model, the Stan-path equivalent
(mirrors ``amf_tpu/active/stan_loop.py``).

Capability parity with the reference's ``stan-bpmf/bpmf.py`` KEYS registry
(:545-556) and ``MainProgram`` / ``full_test`` drivers (:559-1056):
sample-based criteria including the matrix-normal ``exp-entropy-est``,
sampled-mode warm starts between active steps, and the binary
misclassification metric for binary data, on the shared driver
(``active/driver.drive_active``) with checkpoint/resume.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from amf_tpu_torch.active.driver import Family, drive_active
from amf_tpu_torch.analysis import metrics
from amf_tpu_torch.mcmc.nuts import SAMPLER_ERA
from amf_tpu_torch.models import bpmf_hmc, pmf, sample_stats
from amf_tpu_torch.parallel.mesh import is_lead
from amf_tpu_torch.parallel.sharding import sharded_candidate_scores
from amf_tpu_torch.types import Problem, rating_bounds, ratings_array
from amf_tpu_torch.utils.checkpoint import LoopCheckpointer
from amf_tpu_torch.utils.platform import resolve_device
from amf_tpu_torch.utils.rng import fold_in_name, generator


class StanKey(NamedTuple):
    nice_name: str
    kind: str
    choose_max: bool
    cutoff: Optional[float] = None


# reference: stan-bpmf/bpmf.KEYS :545-556
KEYS = {
    "random": StanKey("Random", "random", True),
    "pred-variance": StanKey("Var[R_ij]", "pred-variance", True),
    "exp-variance": StanKey("E[Var[R]]", "exp-variance", False),
    "exp-entropy-est": StanKey("E[H[R]]", "exp-entropy-est", False),
    "pred": StanKey("Pred", "pred", True),
    "prob-ge-3.5": StanKey("Prob >= 3.5", "prob-ge", True, 3.5),
    "prob-ge-.5": StanKey("Prob >= .5", "prob-ge", True, 0.5),
    "prob-ge-0": StanKey("Prob >= 0", "prob-ge", True, 0.0),
}

_CUTOFFS = (3.5, 0.5, 0.0)


def stan_family(
    problem: Problem,
    real: np.ndarray,
    latent_d: int = 5,
    rating_values: Tuple[float, ...] = (),
    subtract_mean: bool = True,
    num_samps: int = 100,
    warmup: Optional[int] = None,
    chains: int = 1,
    lookahead_samps: int = 30,
    lookahead_warmup: int = 15,
    lookahead_tile: int = 0,
    seed: int = 0,
    model_init_map: bool = True,
    binary_acc: bool = False,
    warm_adapt: bool = False,
    warm_warmup: Optional[int] = None,
    cfg: Optional[bpmf_hmc.HMCConfig] = None,
    dtype=torch.float64,
    device=None,
    verbose: bool = False,
    mesh=None,
) -> Tuple[Problem, Family, tuple]:
    """The NUTS family's callables and its initial state: (the problem on
    ``device`` in ``dtype``, the :class:`Family`, (sampler state,
    statistics) of the initial chain under ``fold_in_name(seed, "chain")``).
    Shared by the host loop and the scan sweep (``active/scan_loop``); the
    arguments are :func:`run_active_stan`'s."""
    device = resolve_device(device)
    n, m = problem.shape
    problem = problem.to(device=device, dtype=dtype)
    cfg = cfg or bpmf_hmc.HMCConfig(latent_d=latent_d,
                                    subtract_mean=subtract_mean)
    warmup = num_samps // 2 if warmup is None else warmup

    vals = tuple(sorted(rating_values)) if rating_values else ()
    bounds = tuple(rating_bounds(vals)) if vals else None
    real_t = torch.as_tensor(np.asarray(real, dtype=np.float64),
                             device=device).to(dtype)

    # optional PMF MAP warm start (reference: initialize_bpmf :827-865)
    U0 = V0 = None
    if model_init_map:
        pcfg = pmf.PMFConfig(latent_d=latent_d, subtract_mean=subtract_mean)
        pst = pmf.init_state(generator(fold_in_name(seed, "init"), device),
                             n, m, pcfg, problem, dtype=dtype, device=device)
        pst, _ = pmf.fit(pst, problem, pcfg)
        U0, V0 = pst.U, pst.V

    if warm_adapt and warm_warmup is None:
        warm_warmup = max(warmup // 4, 20)

    # the candidate mesh doubles as the chain mesh when the chains divide
    # over it (the reference's process-parallel Stan chains)
    chain_mesh = (mesh if mesh is not None and chains > 1
                  and chains % mesh.size == 0 else None)

    def sample(k, st, prob):
        return bpmf_hmc.samples(k, st, prob, cfg, num_samps, warmup,
                                chains=chains, chain_mesh=chain_mesh,
                                carry_adapt=warm_adapt,
                                warm_warmup=warm_warmup)

    def stats_of(samps, mr):
        return sample_stats.prediction_stats(
            samps["U"], samps["V"], mr, cfg.subtract_mean, cutoffs=_CUTOFFS,
            value_bounds=bounds)

    def err_of(stats, prob):
        if binary_acc:
            return metrics.binary_misclassification(stats.mean, real_t,
                                                    prob.test)
        return metrics.rmse_on(stats.mean, real_t, prob.test)

    st0 = bpmf_hmc.init_state(problem, cfg, U=U0, V=V0, dtype=dtype)
    st0, samps0 = sample(fold_in_name(seed, "chain"), st0, problem)
    stats0 = stats_of(samps0, st0.mean_rating)

    def lookahead(stat, k, st, prob, stats):
        cand = torch.nonzero(prob.queryable.flatten())[:, 0]
        if not len(cand):  # a scan sweep scores after the pool is exhausted
            return torch.full((n, m), torch.nan, dtype=dtype, device=device)

        def score_flat(c, kk):
            return bpmf_hmc.lookahead_scores(
                kk, st, prob, cfg, stats, vals, stat=stat,
                num_samps=lookahead_samps, warmup=lookahead_warmup,
                n_base_samples=num_samps, cand=c,
                candidate_tile=lookahead_tile)

        return sharded_candidate_scores(score_flat, n * m, mesh,
                                        cand)(k).reshape(n, m)

    def evals_for(kname, st, stats, prob, k):
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
        elif spec.kind in ("exp-variance", "exp-entropy-est"):
            stat = ("total-variance" if spec.kind == "exp-variance"
                    else "entropy-est")
            ev = lookahead(stat, k, st, prob, stats)
        else:
            raise ValueError(spec.kind)
        return torch.where(prob.queryable, ev, torch.nan)

    def refit(st_pair, prob, k):
        st, _ = st_pair
        st = bpmf_hmc.invalidate_mode(st, prob)
        st, samps = sample(k, st, prob)
        if verbose and is_lead(mesh):
            # sampler diagnostics on the joint log density trace (what
            # Stan's own console reported; SURVEY.md §5.1)
            lp = samps["lp__"].cpu().numpy().reshape(chains, -1)
            print(f"    [nuts] lp__ split-Rhat {metrics.split_rhat(lp):.3f}, "
                  f"ESS {metrics.ess(lp):.0f}/{lp.size}")
        return st, stats_of(samps, st.mean_rating)

    family = Family(
        nice_name=lambda kname: KEYS[kname].nice_name,
        score=lambda kname, st, prob, k: (
            evals_for(kname, st[0], st[1], prob, k), KEYS[kname].choose_max),
        refit=refit,
        err=lambda st, prob: err_of(st[1], prob),
    )
    return problem, family, (st0, stats0)


def run_active_stan(
    problem: Problem,
    real: np.ndarray,
    key_names: Sequence[str],
    latent_d: int = 5,
    rating_values: Tuple[float, ...] = (),
    subtract_mean: bool = True,
    num_samps: int = 100,
    warmup: Optional[int] = None,
    chains: int = 1,
    lookahead_samps: int = 30,
    lookahead_warmup: int = 15,
    lookahead_tile: int = 0,
    steps: Optional[int] = None,
    seed: int = 0,
    model_init_map: bool = True,
    binary_acc: bool = False,
    warm_adapt: bool = False,
    warm_warmup: Optional[int] = None,
    cfg: Optional[bpmf_hmc.HMCConfig] = None,
    mesh=None,
    dtype=torch.float64,
    device=None,
    verbose: bool = False,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 20,
) -> Dict[str, object]:
    """Multi-criterion NUTS-BPMF active loop (reference: do_work :946-1025).

    binary_acc: record binary misclassification instead of RMSE (the
    reference's DrugBank metric, stan-bpmf/bpmf.py:53-54).

    warm_adapt: carry the NUTS adaptation (eps anchor and diagonal inverse
    mass) between active steps; refits after the first drop to
    ``warm_warmup`` warmup transitions (default warmup // 4, min 20).
    Lookahead lanes adapt cold. An extension over the reference's full
    warmup per step (PARITY.md).

    Lookahead criteria score the queryable cells ``lookahead_tile``
    candidates (x values) a lockstep batch of lanes (0: all in one).
    checkpoint_path: a partial-results pickle stamped with the sampler era,
    written every ``checkpoint_every`` steps and at each criterion's end; a
    run given an existing one resumes from its recorded picks.
    device: the card by default; without one that raises.

    mesh (``parallel.mesh.CandidateMesh``): every rank runs the loop on the
    same state and scores its shard of a lookahead criterion's candidates
    (``parallel/sharding``); when ``chains`` > 1 is a multiple of its size
    it also splits the chains (``bpmf_hmc.samples(chain_mesh=...)``). Only
    rank 0 prints and writes the checkpoint.
    """
    for k in key_names:
        if k not in KEYS:
            raise ValueError(f"unknown stan criterion {k!r}")
    problem, family, state0 = stan_family(
        problem, real, latent_d=latent_d, rating_values=rating_values,
        subtract_mean=subtract_mean, num_samps=num_samps, warmup=warmup,
        chains=chains, lookahead_samps=lookahead_samps,
        lookahead_warmup=lookahead_warmup, lookahead_tile=lookahead_tile,
        seed=seed, model_init_map=model_init_map, binary_acc=binary_acc,
        warm_adapt=warm_adapt, warm_warmup=warm_warmup, cfg=cfg, dtype=dtype,
        device=device, verbose=verbose, mesh=mesh)
    results: Dict[str, object] = {
        "_real": np.asarray(real),
        "_ratings": ratings_array(problem),
        "_rating_vals": tuple(sorted(rating_values)) or None,
    }
    ckpt = LoopCheckpointer.for_problem(checkpoint_path, problem, real,
                                        every=checkpoint_every,
                                        era=SAMPLER_ERA, write=is_lead(mesh))
    results.update(
        drive_active(problem, real, key_names, family, state0, seed,
                     steps=steps, ckpt=ckpt, verbose=verbose and is_lead(mesh),
                     mesh=mesh))
    return results
