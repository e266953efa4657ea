"""The shared active-learning host loop (mirrors ``amf_tpu/active/driver.py``).

Per criterion: score every queryable cell, query the best, refit, record
(reference: bayes_pmf.compare_active :733-825 and its four siblings). One
driver is parameterized by a :class:`Family` of callables so the random
streams and the results record schema (plot_results.py:160-166) are uniform
across model families.

Random streams: each criterion owns a name-derived seed; each step folds the
step index in, and the step's scoring and refit streams are its children,
so a resume at step k draws the seeds the uninterrupted run would have
drawn from step k on. Checkpoint/resume (``utils/checkpoint``) replays the
recorded picks and refits once under its own seed; ``replay`` re-runs a
recorded pick list with the step-indexed refit seeds.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from amf_tpu_torch.utils.checkpoint import LoopCheckpointer
from amf_tpu_torch.utils.profiling import span
from amf_tpu_torch.utils.rng import fold_in, fold_in_name


class Family(NamedTuple):
    """Per-model-family plumbing for :func:`drive_active`.

    The driver never inspects a state beyond passing it around.
    """

    # criterion key -> human name for verbose output
    nice_name: Callable[[str], str]
    # (kname, state, problem, seed) -> ((n, m) evals with NaN off-pool,
    # choose_max). Called once per step while >1 candidate is left.
    score: Callable
    # (state, problem, seed) -> state, after the queried cell was added
    refit: Callable
    # (state, problem) -> float error metric for the records
    err: Callable
    # optional (state,) -> tuple appended to every record
    extra: Optional[Callable] = None


def drive_active(
    problem,
    real: np.ndarray,
    key_names: Sequence[str],
    family: Family,
    state0,
    seed: int,
    steps: Optional[int] = None,
    ckpt: Optional[LoopCheckpointer] = None,
    verbose: bool = False,
    replay: Optional[Dict[str, List]] = None,
    mesh=None,
) -> Dict[str, List[tuple]]:
    """Run the per-criterion sweeps; returns {criterion: records}.

    Each record is ``(n_rated, err, (i, j), evals)``; the first has no pick
    and no evals. Every criterion starts from the same ``state0``.

    ``ckpt`` resumes a criterion from its recorded picks: the problem is
    replayed and the state refit once under the seed
    ``fold_in(kloop, 2**20 + len(records))`` (skipped when the criterion
    has finished); the steps after it draw their step-indexed seeds. The
    refit draws a fresh chain or fit from ``state0``, as the JAX package's
    does, so the picks after a resume equal the uninterrupted run's where
    they follow from the seeds alone (``random``) and may differ where they
    follow from the refit state.

    ``replay`` maps criterion -> the pick list of a previous run (record
    field 2, None first): scoring is skipped and the recorded cells are
    queried in order, with the step-indexed refit seeds the original run
    used, so the model trajectory is reproduced and the err trace can be
    re-scored under another metric.

    ``mesh`` (``parallel.mesh.CandidateMesh``): every rank runs this loop on
    the same state and takes the same pick from the gathered scores; each
    pick is gathered and a rank that differs fails the run.

    Each step is the span ``active.step``.
    """
    n, m = problem.shape
    ckpt = ckpt or LoopCheckpointer(None)
    out: Dict[str, List[tuple]] = {}

    for kname in key_names:
        nice = family.nice_name(kname)
        prob_k, state = problem, state0
        kloop = fold_in_name(seed, kname)
        max_steps = steps if steps is not None else n * m

        prob_k, records, will_run = ckpt.resume(kname, prob_k, real, max_steps)
        if records:
            if will_run:  # skip the refit when the criterion already finished
                state = family.refit(state, prob_k,
                                     fold_in(kloop, 2**20 + len(records)))
            if verbose:
                print(f"{nice}: resumed at step {len(records) - 1}")
        else:
            rec = (int(prob_k.n_rated), float(family.err(state, prob_k)),
                   None, None)
            if family.extra is not None:
                rec = rec + tuple(family.extra(state))
            records = [rec]
        t0 = time.time()

        replay_picks = (replay or {}).get(kname)
        if replay_picks is not None:
            max_steps = min(max_steps, len(replay_picks))

        while bool(prob_k.queryable.any()) and len(records) < max_steps:
            with span("active.step"):
                t_step = time.time()
                kstep = fold_in(kloop, len(records))
                kscore, krefit = fold_in(kstep, 0), fold_in(kstep, 1)
                if replay_picks is not None:
                    i, j = (int(x) for x in replay_picks[len(records)])
                    flat = i * m + j
                    evals = None
                elif int(prob_k.queryable.sum()) == 1:
                    flat = int(torch.nonzero(prob_k.queryable.flatten())[0, 0])
                    evals = None
                else:
                    ev, choose_max = family.score(kname, state, prob_k, kscore)
                    fill = -torch.inf if choose_max else torch.inf
                    masked = torch.where(prob_k.queryable & torch.isfinite(ev),
                                         ev, fill)
                    flat = int(torch.argmax(masked) if choose_max
                               else torch.argmin(masked))
                    if not bool(torch.isfinite(masked.flatten()[flat])):
                        # no queryable cell has a finite score: the reference
                        # still picks a QUERYABLE cell
                        flat = int(torch.argmax(
                            prob_k.queryable.flatten().to(torch.int32)))
                    evals = ev.cpu().numpy()
                if mesh is not None:
                    mesh.check_same(flat, f"the pick of {kname} step "
                                          f"{len(records)}")
                i, j = flat // m, flat % m
                t_score = time.time() - t_step

                prob_k = prob_k.add_rating(i, j, float(real[i, j]))
                state = family.refit(state, prob_k, krefit)
                err = float(family.err(state, prob_k))
                rec = (int(prob_k.n_rated), err, (i, j), evals)
                if family.extra is not None:
                    rec = rec + tuple(family.extra(state))
                records.append(rec)
                ckpt.update(kname, records)
                if verbose:
                    t_refit = time.time() - t_step - t_score
                    print(f"{nice:<36} step {len(records) - 1}: "
                          f"picked ({i},{j}), err {err:.5f} (score "
                          f"{t_score:.2f}s, refit {t_refit:.2f}s)")

        ckpt.update(kname, records, force=True)
        out[kname] = records
        if verbose:
            print(f"{nice}: {len(records) - 1} steps in "
                  f"{time.time() - t0:.1f}s")

    return out
