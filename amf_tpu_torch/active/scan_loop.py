"""The active-learning sweep with its step logic on the device
(mirrors ``amf_tpu/active/scan_loop.py``).

In the JAX package the whole sweep, {score, pick, query, refit} x steps, is
one ``lax.scan``: one XLA program with no host synchronization a step. The
port's analogue keeps each step's own logic on the device, with no host
read: the pool-exhausted guard, the argmin/argmax over the pool, the
fallback to a queryable cell when no pool score is finite, the rating's
entry into the problem at tensor indices, and the step's outputs, which
stay on the device and come to the host in one copy at the end. The
families' own score and refit code may still read the host (a PMF fit's
stopping test, a NUTS transition's tree doublings, a lookahead's candidate
list); those reads are theirs, not the sweep's.

Random streams: step s of a criterion's sweep draws the seed
``fold_in(fold_in_name(seed, kname), s + 1)`` and scores and refits under
its children ``fold_in(., 0)`` and ``fold_in(., 1)``, as ``active/driver``
derives them, and the families' sweeps start from the host loop's initial
state (``gibbs_family``, ``active_pmf_family``, ``stan_family``). A scan
sweep therefore draws the same seeds as the host loop and records the same
picks and errors wherever the pool has a finite score; where a score on
the pool is NaN the sweep falls back to the first queryable cell, as
JAX's argmax over NaN makes its scan do, while the host loop skips NaN.

As in JAX, a sweep runs all ``steps``: after the pool is exhausted the
problem stays as it is, the refit still runs, and the step's ``valid`` is
False (``result_to_records`` drops it).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from amf_tpu_torch.types import Problem
from amf_tpu_torch.utils.rng import fold_in, fold_in_name


class SweepResult(NamedTuple):
    """A sweep's per-step traces, on the host."""

    n_rated: torch.Tensor  # (steps,) int64
    rmse: torch.Tensor  # (steps,) the family's error after each step
    picks_i: torch.Tensor  # (steps,) int64
    picks_j: torch.Tensor  # (steps,) int64
    valid: torch.Tensor  # (steps,) bool, False once the pool is exhausted
    rmse0: torch.Tensor  # scalar: the error of the initial state
    evals: Optional[torch.Tensor] = None  # (steps, n, m) criterion maps
    # (NaN off-pool), present when run_scan(record_evals=True)


def sweep_steps(
    problem: Problem,
    real,
    state0,
    score: Callable,  # (state, prob, seed) -> (n, m) evals
    refit: Callable,  # (state, prob, seed) -> state
    err: Callable,  # (state, prob) -> scalar tensor
    steps: int,
    seed: int,
    maximize: bool,
    record_evals: bool = False,
) -> Tuple[torch.Tensor, object]:
    """The sweep's steps, all on the device: {score, pick, query, refit}
    ``steps`` times from ``state0``. ``seed`` is the criterion's stream
    (``fold_in_name(seed, kname)``).

    Returns (trace, final state): ``trace`` is one float64 device tensor
    of (steps, 4) rows (rated cells, error, flat pick, pool left), the
    initial error, and, with ``record_evals``, each step's criterion map,
    NaN off the then-queryable pool (steps x n x m). The steps read nothing
    from the device; only the families' callables may."""
    n, m = problem.shape
    device, dtype = problem.R_obs.device, problem.R_obs.dtype
    if not torch.is_tensor(real):
        real = torch.as_tensor(np.asarray(real, dtype=np.float64))
    real = real.to(device=device, dtype=dtype)
    cells = torch.arange(n * m, device=device)
    fill = -torch.inf if maximize else torch.inf

    prob, state = problem, state0
    err0 = torch.as_tensor(err(state0, problem))
    outs, evals = [], []
    for s in range(steps):
        kstep = fold_in(seed, s + 1)
        ev = score(state, prob, fold_in(kstep, 0))
        if record_evals:
            evals.append(torch.where(prob.queryable, ev, torch.nan))
        q = prob.queryable.flatten()
        any_left = q.any()
        masked = torch.where(q, ev.flatten(), fill)
        # argmax and argmin take the first NaN as the extreme, as JAX's do
        flat = masked.argmax() if maximize else masked.argmin()
        # no finite score on the pool (e.g. all-masked *-pos margins):
        # still pick a queryable cell, as the reference's selectors do
        ok = (torch.isfinite(ev.flatten().gather(0, flat[None]))
              & q.gather(0, flat[None]))[0]
        flat = torch.where(ok, flat, q.to(torch.uint8).argmax())
        hit = ((cells == flat) & any_left).view(n, m)
        prob = dataclasses.replace(
            prob, R_obs=torch.where(hit, real, prob.R_obs),
            rated=prob.rated | hit, queryable=prob.queryable & ~hit)
        state = refit(state, prob, fold_in(kstep, 1))
        outs.append(torch.stack([
            prob.n_rated.to(torch.float64),
            torch.as_tensor(err(state, prob)).to(torch.float64),
            flat.to(torch.float64), any_left.to(torch.float64)]))

    parts = [torch.stack(outs).flatten() if outs
             else torch.zeros(0, dtype=torch.float64, device=device),
             err0.to(device=device, dtype=torch.float64).reshape(1)]
    if record_evals and evals:
        parts.append(torch.stack(evals).to(torch.float64).flatten())
    return torch.cat(parts), state


def run_scan(
    problem: Problem,
    real,
    state0,
    score: Callable,
    refit: Callable,
    err: Callable,
    steps: int,
    seed: int,
    maximize: bool,
    record_evals: bool = False,
) -> Tuple[SweepResult, object]:
    """The whole {score, pick, query, refit} sweep of one criterion
    (:func:`sweep_steps`), its traces copied to the host in one copy at
    the end. Returns (traces, final state)."""
    n, m = problem.shape
    dtype = problem.R_obs.dtype
    trace, state = sweep_steps(problem, real, state0, score, refit, err,
                               steps, seed, maximize, record_evals)
    host = trace.cpu()
    tr = host[:4 * steps].reshape(steps, 4)
    flat = tr[:, 2].to(torch.int64)
    ev = None
    if record_evals:
        ev = host[4 * steps + 1:].reshape(steps, n, m).to(dtype)
    return SweepResult(
        n_rated=tr[:, 0].to(torch.int64), rmse=tr[:, 1].to(dtype),
        picks_i=flat // m, picks_j=flat % m, valid=tr[:, 3].to(torch.bool),
        rmse0=host[4 * steps].to(dtype), evals=ev), state


def _family_scan(problem, real, kname, steps, seed, record_evals, family,
                 state0, maximize):
    """A criterion's sweep on a family of the host loops."""
    return run_scan(
        problem, real, state0,
        score=lambda st, prob, k: family.score(kname, st, prob, k)[0],
        refit=family.refit, err=family.err, steps=steps,
        seed=fold_in_name(seed, kname), maximize=maximize,
        record_evals=record_evals)


def run_active_scan(problem: Problem, real, kname: str, steps: int,
                    seed: int = 0, model: str = "vn",
                    record_evals: bool = False, **loop_kw
                    ) -> Tuple[SweepResult, object]:
    """Variational-family sweep of criterion ``kname`` (vn or mn, direct or
    lookahead). ``loop_kw`` are ``active/loop.run_active_pmf``'s keyword
    arguments; the sweep starts from that loop's initial state. Returns
    the traces and the final PMF state."""
    from amf_tpu_torch.active import criteria as criteria_mod
    from amf_tpu_torch.active.loop import active_pmf_family

    registry = (criteria_mod.KEY_FUNCS if model == "vn"
                else criteria_mod.MN_KEY_FUNCS)
    problem, family, state0 = active_pmf_family(
        problem, real, [kname], seed=seed, model=model, **loop_kw)
    res, (pst, _) = _family_scan(problem, real, kname, steps, seed,
                                 record_evals, family, state0,
                                 registry[kname].maximize)
    return res, pst


def run_gibbs_scan(problem: Problem, real, kname: str, steps: int,
                   seed: int = 0, record_evals: bool = False, **loop_kw
                   ) -> Tuple[SweepResult, object]:
    """Gibbs-BPMF sweep of criterion ``kname`` (every KEYS criterion, the
    ``exp-variance`` lookahead through the Cholesky kernel on the card).
    ``loop_kw`` are ``active/gibbs_loop.run_active_gibbs``'s keyword
    arguments; the sweep starts from that loop's initial state. Returns the
    traces and the final (PMF state, statistics)."""
    from amf_tpu_torch.active.gibbs_loop import KEYS, gibbs_family

    if kname not in KEYS:
        raise ValueError(f"unknown Gibbs criterion {kname!r}")
    problem, family, state0 = gibbs_family(problem, real, seed=seed,
                                           **loop_kw)
    return _family_scan(problem, real, kname, steps, seed, record_evals,
                        family, state0, KEYS[kname].choose_max)


def run_stan_scan(problem: Problem, real, kname: str, steps: int,
                  seed: int = 0, record_evals: bool = False, **loop_kw
                  ) -> Tuple[SweepResult, object]:
    """NUTS-BPMF sweep of criterion ``kname`` (every KEYS criterion, the
    NUTS-per-lane lookaheads included). ``loop_kw`` are
    ``active/stan_loop.run_active_stan``'s keyword arguments; the sweep
    starts from that loop's initial state. Returns the traces and the final
    (sampler state, statistics)."""
    from amf_tpu_torch.active.stan_loop import KEYS, stan_family

    if kname not in KEYS:
        raise ValueError(f"unknown stan criterion {kname!r}")
    problem, family, state0 = stan_family(problem, real, seed=seed,
                                          **loop_kw)
    return _family_scan(problem, real, kname, steps, seed, record_evals,
                        family, state0, KEYS[kname].choose_max)


def result_to_records(problem: Problem, res: SweepResult):
    """The reference-schema record list of a sweep: an initial pre-query
    record then one (num_rated, err, (i, j), evals) tuple per valid step
    (plot_results.py:160-166 consumer shape)."""
    recs = [(int(problem.n_rated), float(res.rmse0), None, None)]
    evs = (res.evals.numpy() if res.evals is not None
           else [None] * len(res.valid))
    recs += [
        (int(nr), float(err), (int(i), int(j)), ev)
        for nr, err, i, j, ok, ev in zip(
            res.n_rated.tolist(), res.rmse.tolist(), res.picks_i.tolist(),
            res.picks_j.tolist(), res.valid.tolist(), evs)
        if ok
    ]
    return recs


def sweep_records(problem: Problem, real, key_names, steps: Optional[int],
                  family, state0, seed: int, maximize: Callable[[str], bool],
                  record_evals: bool = False, verbose: bool = False):
    """{criterion: records} of one sweep a criterion on a host loop's
    ``family`` from its ``state0``, as the CLIs' ``--scan`` paths write
    them: ``steps`` counts the records with the initial one, as the host
    loops count them (None: the whole pool)."""
    n_q = int(problem.queryable.sum())
    n_queries = min(steps - 1 if steps else n_q, n_q)
    out = {}
    for kname in key_names:
        t0 = time.time()
        res, _ = _family_scan(problem, real, kname, n_queries, seed,
                              record_evals, family, state0, maximize(kname))
        recs = result_to_records(problem, res)
        out[kname] = recs
        if verbose:
            print(f"{kname}: {len(recs)} records, err {recs[0][1]:.4f} -> "
                  f"{recs[-1][1]:.4f} ({time.time() - t0:.1f}s)")
    return out
