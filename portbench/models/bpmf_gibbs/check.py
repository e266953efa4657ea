"""The ``bpmf_gibbs`` family's checks: the port's outputs against the plain
reference (``reference.py`` beside this file), in float64 on the same
device, once the window has closed and the port's state is freed.

The reference follows the port from the port's own state at the start of
each stage it checks. Where the cold float32 MAP fit of the family's
start stops depends on its rounding (an accepted step that gains less
than 1e-2 ends it; the predicted matrices of a float32 and a float64 fit
from one draw lie 6e-7 to 6e-2 apart), so a reference that fitted its
own start would compare two different, equally sound starts, not the
work after them. That start is set-up, outside the window. The warm
refit of an active step is checked by what it gains, not where it ends:
from the port's previous MAP, on the step's data, the reference takes the
refit's first step (the one every refit takes, at the starting rate),
and the port's refitted MAP has to reach as low a negative log posterior
as that step does. Most warm refits are that one step; where one goes on,
float32 rounding decides where it stops (float32 and float64 refits from
one MAP end up to 3 nats apart), so its end point is not compared
(``PERF.md`` gives the readings).

  * ``check_tiles`` (the ``lookahead_tiles`` loop): from the port's MAP,
    the reference draws its own base chain (the weights, under the
    configuration's ``family_seed``) and, for ``check.candidates``
    candidates drawn from ``--seed`` among every candidate the run
    scored, each lane's refit and chain under the lane seeds of the
    candidate's tile. The sample takes as many candidates from each
    quarter of the positions in a tile (first or second half, even or
    odd), so that a fault in half of every tile cannot escape it.
    ``score_gap`` is the largest |port - reference| / |reference| of a
    score.
  * ``check_steps`` (the ``active_steps`` loop): at step 0 and at
    ``check.steps`` steps drawn from ``--seed``, from the port's MAP of
    the step, the step's chain, whose test error is compared with the
    recorded one (``err_gap``, relative) and whose predictive variance
    with the next step's recorded scores of the queryable cells
    (``evals_gap``, relative Frobenius); at each of those steps after
    the first, ``refit_gap``: by how many nats the port's refitted MAP
    falls short of the reference's first refit step from the port's
    previous MAP (0 where it goes past it).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from portbench.check import rel_gap, worst
from portbench.models.bpmf_gibbs import reference as ref
from portbench.seeds import fold_in_name, numpy_seed, tile_seed


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(numpy_seed(fold_in_name(seed, "check")))


def model_of(config: dict) -> ref.Model:
    return ref.Model(d=config["latent_d"],
                     base_samples=config["base_samples"],
                     lookahead_samples=config["lookahead_samples"],
                     values=tuple(float(v) for v in config["values"]),
                     binary_error=config["error"] == "misclassification",
                     fit_budget=config["lookahead_fit_budget"])


def reference_data(inputs, device, dtype) -> ref.Data:
    return ref.Data.build(inputs.real, inputs.known, inputs.test,
                          inputs.queryable, dtype, device)


def _on(mp, data: ref.Data):
    """The port's MAP (U, V, mean) in the reference's dtype and device."""
    return tuple(x.to(device=data.R.device, dtype=data.R.dtype) for x in mp)


def quarter(k: int, width: int) -> int:
    """Which quarter of a tile's positions ``k`` lies in: first or second
    half, even or odd."""
    return 2 * int(k >= width // 2) + k % 2


def stratified(rng: np.random.Generator, groups: List[int], k: int
               ) -> List[int]:
    """``k`` indices into ``groups`` without repeats, as many from each
    group as it has (round robin, each group's in a random order)."""
    pools = {}
    for i in rng.permutation(len(groups)):
        pools.setdefault(groups[i], []).append(int(i))
    order = [pools[g] for g in sorted(pools)]
    out: List[int] = []
    while len(out) < min(k, len(groups)):
        for pool in order:
            if pool and len(out) < k:
                out.append(pool.pop())
    return sorted(out)


def check_tiles(config, traffic, seed, inputs, done, start, device,
                dtype=None) -> Dict[str, float]:
    """``done``: [(tile, cands, scores or None)] of the run; ``start``:
    the port's MAP (U, V, mean) the tiles were scored from."""
    import torch

    dtype = dtype or torch.float64
    data = reference_data(inputs, device, dtype)
    model = model_of(config)
    start = _on(start, data)
    out = {}
    if traffic["criterion"] != "exp-variance":
        raise ValueError(f"no reference check for the criterion "
                         f"{traffic['criterion']!r}")
    scored = [(t, int(c), float(s[k]), quarter(k, len(cands)))
              for t, cands, s in done
              if s is not None for k, c in enumerate(cands)]
    if not scored:
        return {"score_gap": float("inf")}
    sample = [scored[p] for p in stratified(
        _rng(seed), [q for *_, q in scored], traffic["check"]["candidates"])]
    U, V, _ = start
    base = ref.base_chain(data, model, U, V, data.mean_rating(),
                          ref.init_seeds(config["family_seed"])[1])
    want = ref.expvar_scores(data, model, base, [c for _, c, _, _ in sample],
                             [tile_seed(seed, t) for t, *_ in sample])
    want = want.double().cpu().numpy()
    out["score_gap"] = 0.0
    for (_, _, s, _), w in zip(sample, want):
        out["score_gap"] = worst(out["score_gap"], rel_gap(s, w))
    return out


def check_steps(config, traffic, seed, inputs, records, maps, device,
                dtype=None) -> Dict[str, float]:
    """``records``: the run's [(n_rated, err, (i, j), evals)], the first
    the start's; ``maps``: the port's MAP (U, V, mean) after each."""
    import torch

    dtype = dtype or torch.float64
    crit = traffic["criterion"]
    if crit != "pred-variance":
        raise ValueError(f"no reference check for the criterion {crit!r}")
    K = len(records) - 1
    picks = [r[2] for r in records[1:]]
    steps = _rng(seed).choice(np.arange(1, K + 1),
                              size=min(traffic["check"]["steps"], K),
                              replace=False) if K else []
    check = sorted({0, *(int(k) for k in steps)})
    model = model_of(config)
    data = reference_data(inputs, device, dtype)
    gaps = {"err_gap": 0.0, "evals_gap": 0.0, "refit_gap": 0.0}
    added = 0
    for k in check:
        while added < k:
            data = data.add(*picks[added])
            added += 1
        mean = data.mean_rating()
        U, V, _ = _on(maps[k], data)
        if k:  # the refit: as low as the reference's first step from k - 1
            U0, V0, _ = _on(maps[k - 1], data)
            U1, V1 = ref.fit_batch(data, U0, V0, mean, accepts=1)
            short = (ref.objective(data, U, V, mean)
                     - ref.objective(data, U1, V1, mean))
            gaps["refit_gap"] = worst(gaps["refit_gap"], short)
        chain_seed = (ref.step_seeds(seed, crit, k)[1] if k else
                      ref.init_seeds(config["family_seed"])[1])
        base = ref.base_chain(data, model, U, V, mean, chain_seed)
        err = ref.error(data, base.pred_mean, model.binary_error)
        gaps["err_gap"] = worst(gaps["err_gap"], rel_gap(records[k][1], err))
        if k < K:  # the next step scored the pool by this chain
            ev = torch.as_tensor(records[k + 1][3], device=device,
                                 dtype=dtype)[data.queryable]
            want_ev = base.var[data.queryable]
            gap = float((ev - want_ev).norm() / want_ev.norm())
            gaps["evals_gap"] = worst(gaps["evals_gap"], gap)
    return gaps
