"""The ``bpmf_gibbs`` family: Bayesian PMF by Gibbs sampling, driven
through the port's ``active/gibbs_loop.gibbs_family``.

Its loops (a traffic file's ``loop``):

  * ``lookahead_tiles``: a closed loop of lookahead tiles, back to back in
    one process. Tile t scores ``tile_candidates`` consecutive cells of the
    flat queryable pool, starting at an offset drawn from the traffic
    file's ``start_seed`` (the same tiles for every ``--seed``), under
    the lane seed ``seeds.tile_seed(seed, t)``, through the port's
    ``bpmf_gibbs.exp_variance_scores``, as the Gibbs family's lookahead
    passes them. The warm tile is t = -1, the tile before the offset;
  * ``active_steps``: the active loop of ``active/driver.drive_active``,
    step for step with its seeds, through the Gibbs family's callables
    (``score``, ``refit``, ``err``), from the family's initial fit and
    chain; the warm step runs on a copy of the problem under the
    criterion's name with ``/warm`` added.

Both start from ``family_setup``: the problem on the card, the MAP fit and
the base chain under the configuration's ``family_seed``, the same start
for every ``--seed``; ``--seed`` draws the lanes' and the steps' noise
(``drive_active`` takes its seed apart from the family's). A unit is one
tile or one step. Their checks are ``check.py``'s, against ``reference.py``.

The controls (``CONTROLS``): the reference put in the port's place at the
cell's own size, computed one precision below the configuration's float32,
with TF32 matmuls, then judged by the float64 reference as a run is: for
tiles, ``units`` tiles of the traffic's width from the same offset and
lane seeds; for steps, that many steps of the criterion from the
reference's own start. The fault (``FAULTS``): the warm MAP refits left
out, the upper reading of ``refit_gap``, which the control cannot move.
"""

from __future__ import annotations

import contextlib
import time
import traceback
from typing import List

import numpy as np

from portbench.data import make_inputs
from portbench.loops import Setting
from portbench.models.bpmf_gibbs import check
from portbench.models.bpmf_gibbs import reference as ref
from portbench.seeds import fold_in, fold_in_name, tile_seed


def family_setup(s: Setting, inputs):
    """The port's problem, Gibbs family and initial (MAP, chain) state."""
    import torch

    from amf_tpu_torch import types
    from amf_tpu_torch.active.gibbs_loop import gibbs_family

    c = s.config
    if not c["subtract_mean"] or c["fit"] != "batch":
        raise ValueError("the Gibbs cells run --subtract-mean, batch fits")
    problem = types.problem_from_dense(
        inputs.real, inputs.known, queryable=inputs.queryable,
        test=inputs.test, dtype=torch.float32, device=s.device)
    return gibbs_family(
        problem, inputs.real, latent_d=c["latent_d"], rating_values=s.values,
        subtract_mean=True, num_samps=c["base_samples"],
        lookahead_samps=c["lookahead_samples"], seed=c["family_seed"],
        fit_type=("batch",), dtype=torch.float32, device=s.device,
        binary_acc=s.binary)


def map_of(pst) -> tuple:
    """The MAP a port's PMF state holds: (U, V, mean rating)."""
    return pst.U, pst.V, pst.mean_rating


class LookaheadTiles:
    """Tiles of ``exp-variance`` lookahead candidates (see the module)."""

    kind = "lookahead_tiles"
    unit_counts = "candidates"

    def __init__(self, s: Setting, inputs):
        from amf_tpu_torch.models import bpmf_gibbs, pmf

        if s.traffic["criterion"] != "exp-variance":
            raise ValueError(f"lookahead tiles run exp-variance, not "
                             f"{s.traffic['criterion']!r}")
        self.s = s
        self.prob, _, (self.pst, self.stats) = family_setup(s, inputs)
        self.start = map_of(self.pst)
        d = s.config["latent_d"]
        self.pcfg = pmf.PMFConfig(latent_d=d, subtract_mean=True)
        self.gcfg = bpmf_gibbs.GibbsConfig(latent_d=d, subtract_mean=True)
        self.pool = inputs.pool
        self.C = s.traffic["tile_candidates"]
        self.offset = self.offset_for(s, len(self.pool))
        self.lanes = self.C * len(s.values)
        self.next = 0
        self.done: List[tuple] = []  # (tile, cands, scores or None)

    @staticmethod
    def offset_for(s: Setting, pool: int) -> int:
        """Where tile 0 starts in the pool, drawn from ``start_seed``."""
        rng = np.random.default_rng(s.traffic["start_seed"])
        return int(rng.integers(pool))

    def cands(self, t: int) -> np.ndarray:
        idx = (self.offset + t * self.C + np.arange(self.C)) % len(self.pool)
        return self.pool[idx]

    def score(self, t: int):
        import torch

        from amf_tpu_torch.models import bpmf_gibbs

        c = self.s.config
        return bpmf_gibbs.exp_variance_scores(
            tile_seed(self.s.seed, t), self.pst, self.prob, self.pcfg,
            self.gcfg, self.stats, self.s.values,
            num_samps=c["lookahead_samples"],
            n_base_samples=c["base_samples"],
            fit_budget=c["lookahead_fit_budget"],
            cand=torch.as_tensor(self.cands(t), device=self.s.device))

    def warm(self) -> None:
        self.score(-1)

    def unit(self) -> int:
        """Score the next tile; returns the candidates it attempted."""
        t = self.next
        self.next += 1
        try:
            out = self.score(t)
        except RuntimeError:
            traceback.print_exc()
            out = None
        self.done.append((t, self.cands(t), out))
        return self.C

    def failed(self) -> int:
        import torch

        bad = 0
        for _, cands, out in self.done:
            bad += len(cands) if out is None else int(
                (~torch.isfinite(out)).sum())
        return bad

    def free(self) -> None:
        """Drop the port's state; the scores stay, on the host."""
        self.done = [(t, c, None if o is None else o.double().cpu().numpy())
                     for t, c, o in self.done]
        self.start = tuple(x.double().cpu() for x in self.start)
        del self.prob, self.pst, self.stats

    def check(self, inputs) -> dict:
        """The compared numbers (``check.check_tiles``), once freed."""
        s = self.s
        return check.check_tiles(s.config, s.traffic, s.seed, inputs,
                                 self.done, self.start, s.device)


class ActiveSteps:
    """Steps of the active loop, as ``drive_active`` takes them."""

    kind = "active_steps"
    unit_counts = "steps"

    def __init__(self, s: Setting, inputs):
        self.s = s
        self.real = inputs.real
        self.crit = s.traffic["criterion"]
        self.prob, self.family, self.state = family_setup(s, inputs)
        self.kloop = fold_in_name(s.seed, self.crit)
        self.records = [(int(self.prob.n_rated),
                         float(self.family.err(self.state, self.prob)),
                         None, None)]
        self.maps = [map_of(self.state[0])]  # the MAP after each step
        self.spans: List[tuple] = []  # (score_s, refit_s) a step
        self.raised = 0

    def step(self, prob, state, records, kloop):
        """One step of ``drive_active``: (problem, state, record, score s,
        refit s); the record is (n_rated, err, (i, j), evals)."""
        import torch

        m = prob.shape[1]
        t_step = time.perf_counter()
        kstep = fold_in(kloop, len(records))
        kscore, krefit = fold_in(kstep, 0), fold_in(kstep, 1)
        if int(prob.queryable.sum()) == 1:
            flat = int(torch.nonzero(prob.queryable.flatten())[0, 0])
            evals = None
        else:
            ev, choose_max = self.family.score(self.crit, state, prob, kscore)
            fill = -torch.inf if choose_max else torch.inf
            masked = torch.where(prob.queryable & torch.isfinite(ev), ev, fill)
            flat = int(torch.argmax(masked) if choose_max
                       else torch.argmin(masked))
            if not bool(torch.isfinite(masked.flatten()[flat])):
                flat = int(torch.argmax(prob.queryable.flatten().to(
                    torch.int32)))
            evals = ev.cpu().numpy()
        i, j = flat // m, flat % m
        t_score = time.perf_counter() - t_step
        prob = prob.add_rating(i, j, float(self.real[i, j]))
        state = self.family.refit(state, prob, krefit)
        err = float(self.family.err(state, prob))
        t_all = time.perf_counter() - t_step
        return (prob, state, (int(prob.n_rated), err, (i, j), evals),
                t_score, t_all - t_score)

    def warm(self) -> None:
        self.step(self.prob, self.state, self.records,
                  fold_in_name(self.s.seed, self.crit + "/warm"))

    def exhausted(self) -> bool:
        return self.raised > 0 or not bool(self.prob.queryable.any())

    def unit(self) -> int:
        try:
            self.prob, self.state, rec, ts, tr = self.step(
                self.prob, self.state, self.records, self.kloop)
        except RuntimeError:
            traceback.print_exc()
            self.raised += 1
            return 1
        self.records.append(rec)
        self.maps.append(map_of(self.state[0]))
        self.spans.append((ts, tr))
        return 1

    def failed(self) -> int:
        return self.raised + sum(1 for r in self.records[1:]
                                 if not np.isfinite(r[1]))

    def free(self) -> None:
        self.maps = [tuple(x.double().cpu() for x in mp) for mp in self.maps]
        del self.prob, self.state, self.family

    def check(self, inputs) -> dict:
        """The compared numbers (``check.check_steps``), once freed."""
        s = self.s
        return check.check_steps(s.config, s.traffic, s.seed, inputs,
                                 self.records, self.maps, s.device)


LOOPS = {"lookahead_tiles": LookaheadTiles, "active_steps": ActiveSteps}


@contextlib.contextmanager
def refit_skipped():
    """The port with its warm MAP refits left out: once the family's start
    is built, ``pmf.fit`` returns the MAP it is given, and each step still
    draws its chain afresh, from that MAP."""
    global family_setup
    from amf_tpu_torch.models import pmf

    real_setup, real_fit = family_setup, pmf.fit

    def setup(s, inputs):
        out = real_setup(s, inputs)
        pmf.fit = lambda state, *a, **k: (state, None)
        return out

    family_setup = setup
    try:
        yield
    finally:
        family_setup, pmf.fit = real_setup, real_fit


FAULTS = {"refit_skipped": refit_skipped}


def control_tiles(cell, seed, device, units):
    import torch

    inputs = make_inputs(cell.config)
    model = check.model_of(cell.config)
    s = Setting(cell.config, cell.traffic, seed, device)
    C = cell.traffic["tile_candidates"]
    pool = inputs.pool
    offset = LookaheadTiles.offset_for(s, len(pool))
    done = []
    with ref.matmul_precision(True):
        data = check.reference_data(inputs, device, torch.float32)
        base = ref.initial_state(data, model, cell.config["family_seed"])
        start = (base.U.cpu(), base.V.cpu(), base.mean.cpu())
        for t in range(units):
            cands = pool[(offset + t * C + np.arange(C)) % len(pool)]
            scores = ref.expvar_scores(data, model, base, cands,
                                       [tile_seed(seed, t)] * C)
            done.append((t, cands, scores.double().cpu().numpy()))
    del data, base
    torch.cuda.empty_cache()
    return check.check_tiles(cell.config, cell.traffic, seed, inputs, done,
                             start, device)


def control_steps(cell, seed, device, units):
    import torch

    inputs = make_inputs(cell.config)
    model = check.model_of(cell.config)
    crit = cell.traffic["criterion"]
    with ref.matmul_precision(True):
        data = check.reference_data(inputs, device, torch.float32)
        state = ref.initial_state(data, model, cell.config["family_seed"])
        records = [(int(data.known.sum()),
                    ref.error(data, state.pred_mean, model.binary_error),
                    None, None)]
        maps = [(state.U.cpu(), state.V.cpu(), state.mean.cpu())]
        for k in range(1, units + 1):
            var = torch.where(data.queryable, state.var, -torch.inf)
            flat = int(torch.argmax(var))
            i, j = divmod(flat, data.R.shape[1])
            evals = torch.where(data.queryable, state.var, torch.nan)
            data = data.add(i, j)
            state = ref.refit(data, model, state.U, state.V,
                              ref.step_seeds(seed, crit, k)[1])
            records.append((int(data.known.sum()),
                            ref.error(data, state.pred_mean,
                                      model.binary_error), (i, j),
                            evals.cpu().numpy()))
            maps.append((state.U.cpu(), state.V.cpu(), state.mean.cpu()))
    del data, state
    torch.cuda.empty_cache()
    return check.check_steps(cell.config, cell.traffic, seed, inputs,
                             records, maps, device)


CONTROLS = {"lookahead_tiles": control_tiles, "active_steps": control_steps}
