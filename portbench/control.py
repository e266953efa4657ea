"""The readings that a cell's limits are set from, in one process.

    python3 -m portbench.control --workload <name> --seeds 1 2 3 \
        [--program-seconds S] [--control-units N] [--fault refit_skipped]

For each seed, on the card:

  * ``program``: a run of the cell as ``python3 -m portbench`` makes it
    (window of ``--program-seconds``), and its compared numbers: the lower
    readings;
  * ``control``: the reference put in the port's place at the cell's own
    size, computed one precision below the configuration's float32, with
    TF32 matmuls, then judged by the float64 reference as a run is: for
    tiles, ``--control-units`` tiles of the traffic's width from the same
    offset and lane seeds; for steps, that many steps of the criterion
    from the reference's own start. Its numbers are the upper readings;
  * with ``--fault``, the ``program`` run has that fault planted in the
    port (``FAULTS``): the upper reading of a number that the control
    cannot move.

One JSON line a seed and side on standard output. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np

from portbench import check, loops
from portbench import reference as ref
from portbench.data import make_inputs
from portbench.run import load_cell, run_cell
from portbench.seeds import tile_seed


@contextlib.contextmanager
def refit_skipped():
    """The port with its warm MAP refits left out: once the family's start
    is built, ``pmf.fit`` returns the MAP it is given, and each step still
    draws its chain afresh, from that MAP."""
    from amf_tpu_torch.models import pmf

    real_setup, real_fit = loops.family_setup, pmf.fit

    def setup(s, inputs):
        out = real_setup(s, inputs)
        pmf.fit = lambda state, *a, **k: (state, None)
        return out

    loops.family_setup = setup
    try:
        yield
    finally:
        loops.family_setup, pmf.fit = real_setup, real_fit


FAULTS = {"refit_skipped": refit_skipped}


def control_tiles(cell, seed, device, units):
    import torch

    inputs = make_inputs(cell.config)
    model = check.model_of(cell.config)
    s = loops.Setting(cell.config, cell.traffic, seed, device)
    C = cell.traffic["tile_candidates"]
    pool = inputs.pool
    offset = loops.LookaheadTiles.offset_for(s, len(pool))
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program-seconds", type=float, default=0.0,
                    help="0: no program runs")
    ap.add_argument("--control-units", type=int, default=0,
                    help="0: no control runs")
    ap.add_argument("--fault", choices=sorted(FAULTS),
                    help="plant this fault in the program's runs")
    args = ap.parse_args(argv)
    from amf_tpu_torch.utils.platform import resolve_device

    cell = load_cell(args.workload)
    device = resolve_device("cuda")
    fn = (control_tiles if cell.traffic["loop"] == "lookahead_tiles"
          else control_steps)
    for seed in args.seeds:
        if args.program_seconds > 0:
            with (FAULTS[args.fault]() if args.fault
                  else contextlib.nullcontext()):
                out = run_cell(cell, seed, args.program_seconds, False,
                               device)
            print(json.dumps({"seed": seed,
                              "side": f"fault:{args.fault}" if args.fault
                              else "program",
                              "correct": out["correct"],
                              "checks": out["checks"],
                              "metrics": out["metrics"]}), flush=True)
        if args.control_units > 0:
            nums = fn(cell, seed, device, args.control_units)
            print(json.dumps({"seed": seed, "side": "control",
                              "numbers": nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
