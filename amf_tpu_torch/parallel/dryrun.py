"""The sharded dry run (mirrors ``amf_tpu/parallel/dryrun.py``).

Runs every sharded path of the port once on tiny shapes, on the ranks of
a :class:`~amf_tpu_torch.parallel.mesh.CandidateMesh`:

  1. a full variational-normal active step: ``total-variance`` lookahead
     scores sharded over the ranks, the pick (``best_candidate``), the
     masked add-rating, the PMF MAP and KL refits;
  2. the Gibbs ``exp-variance`` lookahead (B1's Gram-fed entry on every
     rank's lane chains on the card);
  3. the NUTS ``exp-variance`` lookahead, and the cold-start one;
  4. the RatingConcentration 1-step entropy lookahead;
  5. NUTS chains split over the ranks (``samples(chain_mesh=...)``);
  6. two steps of ``run_active_pmf`` with the mesh.

:func:`dryrun_step` with no mesh computes the same unsharded, so a caller
holds one against the other (the tests, ``chip_smoke.py``).
:func:`run_dryrun` launches the ranks and checks what the JAX package's dry
run checks. :func:`gibbs_tile_on_ranks` runs one Gibbs lookahead tile at
any shape sharded over the ranks and reports each rank's time, gather and
Cholesky-kernel launches (``chip_smoke.py`` phase 35).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from amf_tpu_torch.parallel.mesh import CandidateMesh, is_lead, launch
from amf_tpu_torch.parallel.sharding import (best_candidate,
                                             sharded_candidate_scores)

N_USERS, N_ITEMS, LATENT_D = 6, 6, 2


def _problem(dtype, device):
    from amf_tpu_torch import types
    from amf_tpu_torch.data.synthetic import make_fake_data

    real, known, vals = make_fake_data(
        num_users=N_USERS, num_items=N_ITEMS, rank=LATENT_D, data_type=5,
        mask_type="diag", rng=np.random.default_rng(0))
    prob = types.problem_from_dense(real, known, dtype=dtype, device=device)
    return real, prob, tuple(float(v) for v in vals)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def dryrun_step(mesh: Optional[CandidateMesh], chains: int = 4,
                dtype=torch.float64, device=None) -> Dict[str, object]:
    """Every sharded path once; returns numpy results keyed by path.

    ``mesh`` None runs each path unsharded in this process on ``device``
    (with a mesh, the mesh's device). ``chains`` must be a multiple of the
    mesh size.
    """
    from amf_tpu_torch.active import criteria as criteria_mod
    from amf_tpu_torch.active import lookahead as lookahead_mod
    from amf_tpu_torch.active.loop import run_active_pmf
    from amf_tpu_torch.models import (bpmf_gibbs, bpmf_hmc, newitems, pmf,
                                      ratingconc as rc, sample_stats, vnormal)
    from amf_tpu_torch.types import rating_bounds
    from amf_tpu_torch.utils.platform import resolve_device
    from amf_tpu_torch.utils.rng import fold_in, generator

    device = mesh.device if mesh is not None else resolve_device(device)
    real, prob, vals = _problem(dtype, device)
    n, m = prob.shape
    queryable = prob.queryable.flatten()
    cand = torch.nonzero(queryable)[:, 0]
    bounds = tuple(rating_bounds(vals))
    out: Dict[str, object] = {"queryable": _np(queryable)}

    def sharded(score_flat, seed):
        return sharded_candidate_scores(score_flat, n * m, mesh, cand)(seed)

    # ---- 1. the variational-normal step
    pcfg = pmf.PMFConfig(latent_d=LATENT_D, max_fit_steps=40)
    vcfg = vnormal.VNConfig(latent_d=LATENT_D, max_fit_steps=30)
    adapter = lookahead_mod.vn_adapter(vcfg)
    lcfg = lookahead_mod.LookaheadConfig(
        rating_values=vals, discretize="sum", pmf_refit_steps=15,
        approx_refit_steps=15)
    crit = criteria_mod.KEY_FUNCS["total-variance"]
    pst = pmf.init_state(generator(0, device), n, m, pcfg, prob, dtype=dtype,
                         device=device)
    pst, _ = pmf.fit(pst, prob, pcfg)
    k = adapter.noise_size(n, m)
    noise = torch.randn((k, k), generator=generator(1, device), dtype=dtype,
                        device=device)
    ast = adapter.fit_approx(adapter.init_approx(pst, noise), pst, prob, 30)
    scores = sharded(lambda c, s: lookahead_mod.lookahead_scores(
        crit, pst, ast, prob, s, pcfg, adapter, lcfg, cand=c), 2)
    flat = int(best_candidate(scores, queryable, crit.maximize))
    prob2 = prob.add_rating(flat // m, flat % m, 3.0)
    pst2, _ = pmf.fit(pst, prob2, pcfg, max_steps=15)
    ast2 = adapter.fit_approx(ast, pst2, prob2, 15)
    out["vn"] = {"scores": _np(scores), "pick": flat,
                 "pred": _np(pmf.predicted_matrix(pst2, pcfg)),
                 "approx_mean": _np(ast2.mean)}

    # ---- 2. Gibbs exp-variance
    gcfg = bpmf_gibbs.GibbsConfig(latent_d=LATENT_D)
    _, gstats, _ = bpmf_gibbs.run_chain(
        bpmf_gibbs.init_chain(pst), prob, gcfg, 8,
        generator=generator(3, device), value_bounds=bounds)
    out["gibbs"] = {"scores": _np(sharded(
        lambda c, s: bpmf_gibbs.exp_variance_scores(
            s, pst, prob, pcfg, gcfg, gstats, vals, num_samps=4,
            fit_budget=10, cand=c, n_base_samples=8), 4))}

    # ---- 3. NUTS exp-variance, and cold start
    # trees of at most 2**4 leaves keep the dry run short
    hcfg = bpmf_hmc.HMCConfig(latent_d=LATENT_D, subtract_mean=True,
                              max_depth=4)
    hst = bpmf_hmc.init_state(prob, hcfg, dtype=dtype)
    hst, hsamps = bpmf_hmc.samples(5, hst, prob, hcfg, 8, 4)
    hbase = sample_stats.prediction_stats(
        hsamps["U"], hsamps["V"], hst.mean_rating, hcfg.subtract_mean,
        value_bounds=bounds)
    out["nuts"] = {"scores": _np(sharded(
        lambda c, s: bpmf_hmc.lookahead_scores(
            s, hst, prob, hcfg, hbase, vals, num_samps=3, warmup=2,
            n_base_samples=8, cand=c), 6))}

    is_new = np.zeros(m, bool)
    is_new[-2:] = True
    U_mean, V_fixed, mr = newitems.initial_full_fit(
        7, prob, is_new, hcfg, num_samps=8, dtype=dtype)
    prob_new = newitems.new_item_problem(prob, is_new)
    nst = newitems.init_state(prob_new, U_mean, V_fixed, hcfg, mr,
                              dtype=dtype)
    nst, nsamps = newitems.samples(8, nst, prob_new, hcfg, 8, 4)
    nbase = sample_stats.prediction_stats(
        nsamps["U"], nsamps["V"], mr, hcfg.subtract_mean, value_bounds=bounds)
    n_cand = torch.nonzero(prob_new.queryable.flatten())[:, 0]
    out["newitems"] = {"scores": _np(sharded_candidate_scores(
        lambda c, s: newitems.lookahead_scores(
            s, nst, prob_new, hcfg, nbase, vals, num_samps=3, warmup=2,
            n_base_samples=8, cand=c),
        n * int(is_new.sum()), mesh, n_cand)(9)),
        "queryable": _np(prob_new.queryable.flatten())}

    # ---- 4. RatingConcentration entropy
    rcfg = rc.RCConfig(rating_values=vals, max_iters=25)
    x0, rdata, _ = rc.fit(prob, rcfg, dtype=dtype)
    out["rc"] = {"scores": _np(sharded(
        lambda c, _s: rc.entropy_lookahead_scores(
            x0, rdata, prob, rcfg, lookahead_iters=8, dtype=dtype, cand=c),
        0))}

    # ---- 5. NUTS chains over the ranks
    cst, csamps = bpmf_hmc.samples(
        fold_in(10, 0), bpmf_hmc.init_state(prob, hcfg, dtype=dtype), prob,
        hcfg, 6, 6, chains=chains, chain_mesh=mesh, carry_adapt=True)
    out["chains"] = {"U": _np(csamps["U"]), "lp__": _np(csamps["lp__"]),
                     "mode_q": _np(cst.mode_q), "mode_lp": _np(cst.mode_lp),
                     "adapt_eps": _np(cst.adapt_eps),
                     "adapt_inv_mass": _np(cst.adapt_inv_mass)}

    # ---- 6. the ActivePMF loop
    res = run_active_pmf(prob, real, ["total-variance"], latent_d=LATENT_D,
                         rating_values=vals, discrete_exp=True, steps=3,
                         lookahead_budget=15, dtype=dtype, device=device,
                         mesh=mesh)
    out["loop"] = [(r[0], r[1], r[2]) for r in res["total-variance"]]
    return out


def check_dryrun(out: Dict[str, object]) -> None:
    """What the JAX package's dry run asserts, on :func:`dryrun_step`'s
    result: a queryable pick; finite scores on the pool and NaN off it; a
    finite refit."""
    q = out["queryable"]
    vn = out["vn"]
    if not (0 <= vn["pick"] < q.size and q[vn["pick"]]):
        raise AssertionError(f"the pick {vn['pick']} is off the pool")
    for name in ("vn", "gibbs", "nuts", "rc"):
        s = out[name]["scores"]
        if not (np.isfinite(s[q]).all() and np.isnan(s[~q]).all()):
            raise AssertionError(f"{name}: scores not finite on the pool "
                                 "and NaN off it")
    nq = out["newitems"]["queryable"]
    if not np.isfinite(out["newitems"]["scores"][nq]).all():
        raise AssertionError("newitems: scores not finite on the pool")
    if not np.isfinite(vn["pred"]).all():
        raise AssertionError("the refit prediction is not finite")


def _dryrun_rank(mesh: CandidateMesh, chains: int, dtype):
    out = dryrun_step(mesh, chains=chains, dtype=dtype)
    check_dryrun(out)
    out["setup_s"] = mesh.stats.get("setup_s")
    if is_lead(mesh):
        pick = out["vn"]["pick"]
        print(f"dryrun_multichip ok: {mesh.size} ranks ({mesh.backend}, "
              f"{mesh.device.type}), sharded families: vn total-variance "
              f"full step, Gibbs exp-variance, NUTS exp-variance, cold-start "
              f"exp-variance, RC 1-step entropy, {chains} NUTS chains; picked "
              f"cell ({pick // N_ITEMS}, {pick % N_ITEMS})", flush=True)
    return out


def _to(tree, device):
    """A state's tensors (a tensor, dataclass, NamedTuple or None) on
    ``device``."""
    if tree is None or isinstance(tree, torch.Tensor):
        return None if tree is None else tree.to(device)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _to(getattr(tree, f.name), device)
            for f in dataclasses.fields(tree)})
    return type(tree)(*(_to(x, device) for x in tree))


def gibbs_tile_on_ranks(mesh: CandidateMesh, seed: int, pst, prob, pcfg,
                        gcfg, stats, vals, cand, kw: dict
                        ) -> Dict[str, object]:
    """One Gibbs ``exp-variance`` lookahead over ``cand``, sharded over the
    mesh's ranks (``kw`` go to ``bpmf_gibbs.exp_variance_scores``), run
    twice: a first run that warms the rank's process, then the one that
    is read. The inputs may lie on any device and are moved to the rank's.
    Returns the scores of ``cand`` on the CPU and, rank by rank, the
    seconds of its shard (first and read run), the read run's gather ms,
    the seconds from launch to the first collective, and the read run's
    launches of the Cholesky kernel's two entry points and calls of their
    plain version, counted from 0 just before it. The seconds are the
    spans ``parallel.score`` and ``parallel.gather``, recorded under
    ``utils.profiling.tracing``."""
    from amf_tpu_torch.models import bpmf_gibbs
    from amf_tpu_torch.ops import chol_kernel as ck
    from amf_tpu_torch.utils import profiling

    dev = mesh.device
    pst, prob, stats = _to(pst, dev), prob.to(device=dev), _to(stats, dev)
    cand = torch.as_tensor(cand, device=dev)
    n, m = prob.shape
    run = sharded_candidate_scores(
        lambda c, s: bpmf_gibbs.exp_variance_scores(
            s, pst, prob, pcfg, gcfg, stats, vals, cand=c, **kw),
        n * m, mesh, cand)

    def last_s(name):
        return [s.host_s for s in profiling.spans() if s.name == name][-1]

    with profiling.tracing():
        run(seed)
        first_s = last_s("parallel.score")
        ck.chol_gram_solve_sample_cuda.launches = 0
        ck.chol_solve_sample_batch_minor.launches = 0
        ck.chol_solve_sample_reference.calls = 0
        scores = run(seed)[cand]
    counts = ck.launch_counts()
    mine = torch.tensor([first_s, last_s("parallel.score"),
                         last_s("parallel.gather") * 1e3,
                         mesh.stats.get("setup_s", float("nan")),
                         counts["gram_fed"], counts["s_given"],
                         counts["plain"]], dtype=torch.float64, device=dev)
    ranks = torch.stack(mesh.all_gather(mine)).cpu().tolist()
    keys = ("first_shard_s", "shard_s", "gather_ms", "setup_s", "gram_fed",
            "s_given", "plain")
    return {"scores": _np(scores),
            "ranks": [dict(zip(keys, r)) for r in ranks]}


def run_dryrun(n_devices: int, device=None, backend: Optional[str] = None,
               dtype=torch.float64) -> Dict[str, object]:
    """Launch ``n_devices`` ranks (``parallel.mesh.launch``) that run
    :func:`dryrun_step` with ``2 * n_devices`` chains and check it; returns
    rank 0's result (add ``"setup_s"``, its seconds to the first
    collective)."""
    return launch(_dryrun_rank, n_devices, device, backend, 2 * n_devices,
                  dtype)
