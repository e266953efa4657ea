"""RatingConcentration active-learning loop (mirrors
``amf_tpu/active/rc_loop.py``).

Capability parity with the reference's MATLAB driver
(ratingconcentration/evaluate_active.m:1-83) and Python bridge (active_rc.py):
fit, per-selector query loop with warm-started multiplier refits, RMSE of
expected ratings (or argmax-P in pred_mode) against the full matrix, on the
shared driver (``active/driver.drive_active``) with checkpoint/resume.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from amf_tpu_torch.active.driver import Family, drive_active
from amf_tpu_torch.models import ratingconc as rc
from amf_tpu_torch.parallel.mesh import is_lead
from amf_tpu_torch.parallel.sharding import sharded_candidate_scores
from amf_tpu_torch.types import Problem
from amf_tpu_torch.utils.checkpoint import LoopCheckpointer
from amf_tpu_torch.utils.platform import resolve_device
from amf_tpu_torch.utils.rng import generator


def run_active_rc(
    problem: Problem,
    real: np.ndarray,
    key_names: Sequence[str],
    delta: float = 1.5,
    rating_values=None,
    steps: Optional[int] = None,
    seed: int = 0,
    pred_mode: bool = False,
    lookahead_iters: int = 60,
    lookahead_tile: int = 0,
    max_iters: int = 500,
    mesh=None,
    dtype=torch.float64,
    device=None,
    verbose: bool = False,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 20,
) -> Dict[str, object]:
    """Multi-criterion maxent active loop; returns the results dict
    (``_real``, ``_rating_vals`` and one record list per criterion).

    Every refit is warm-started from the state's multipliers. The
    ``entropy`` lookahead refits ``lookahead_tile`` candidates (x values)
    as one lockstep batch of lanes at a time (0: all at once); ``random``
    draws from a generator seeded by the step's seed. ``device``: the card
    by default; without one that raises.

    mesh (``parallel.mesh.CandidateMesh``): every rank runs the loop on the
    same state and refits its shard of the ``entropy`` candidates; one
    gather gives every rank every score (``parallel/sharding``). Only rank
    0 prints and writes the checkpoint.
    """
    for k in key_names:
        if k not in rc.RC_KEYS:
            raise ValueError(f"unknown RC selector {k!r}")
    device = resolve_device(device)
    n, m = problem.shape
    problem = problem.to(device=device, dtype=dtype)
    real = np.asarray(real)
    if rating_values is None:
        vals = sorted(set(real[real != 0].ravel()))
    else:
        vals = sorted(rating_values)
    cfg = rc.RCConfig(rating_values=tuple(float(v) for v in vals),
                      delta=delta, max_iters=max_iters)
    vals_t = torch.as_tensor(vals, dtype=dtype, device=device)
    real_t = torch.as_tensor(real, dtype=dtype, device=device)
    knowable = torch.as_tensor(np.isfinite(real) & (real != 0), device=device)

    def fit_fn(prob, warm):
        return rc.fit(prob, cfg, warmstart=warm, dtype=dtype)

    def rmse_of(x, data, prob):
        E, P = rc.predictions(x, data, prob, cfg)
        pred = vals_t[torch.argmax(P, dim=-1)] if pred_mode else E
        # reference: rmse over every cell of X (evaluate_active.m:12-18);
        # restricted to knowable cells (X is assumed 0-free there)
        d2 = torch.where(knowable, (real_t - pred) ** 2, 0.0)
        return torch.sqrt(d2.sum() / torch.clamp(knowable.sum(), min=1))

    x0, data0, _ = fit_fn(problem, None)

    results: Dict[str, object] = {
        "_real": real,
        "_rating_vals": tuple(float(v) for v in vals),
    }

    def score(kname, st, prob, k):
        x, data = st
        _, cutoff = rc.RC_KEYS[kname]
        if kname == "random":
            ev = torch.rand((n, m), generator=generator(k, device),
                            dtype=dtype, device=device)
            choose_max = True
        elif kname == "entropy":
            # deterministic: the scorer takes no seed
            def score_flat(c, _k):
                return rc.entropy_lookahead_scores(
                    x, data, prob, cfg, lookahead_iters=lookahead_iters,
                    dtype=dtype, cand=c, candidate_tile=lookahead_tile)

            cand = torch.nonzero(prob.queryable.flatten())[:, 0]
            ev = sharded_candidate_scores(score_flat, n * m, mesh,
                                          cand)(k).reshape(n, m)
            choose_max = False
        else:  # ge-cutoff (select_ge_cutoff.m)
            P = rc.cell_probs(x, data, data.qmask)
            ev = (P * (vals_t >= cutoff)).sum(-1)
            choose_max = True
        return torch.where(prob.queryable, ev, torch.nan), choose_max

    # reference analogue: the MATLAB loops keep partial results and
    # warm-started multipliers across steps (evaluate_active.m:71-72)
    ckpt = LoopCheckpointer.for_problem(checkpoint_path, problem, real,
                                        every=checkpoint_every,
                                        write=is_lead(mesh))
    family = Family(
        nice_name=lambda kname: rc.RC_KEYS[kname][0],
        score=score,
        refit=lambda st, prob, k: fit_fn(prob, st[0])[:2],  # warm-started
        err=lambda st, prob: rmse_of(st[0], st[1], prob),
    )
    results.update(
        drive_active(problem, real, key_names, family, (x0, data0), seed,
                     steps=steps, ckpt=ckpt, verbose=verbose and is_lead(mesh),
                     mesh=mesh))
    return results
