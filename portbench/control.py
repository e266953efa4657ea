"""The readings that a cell's limits are set from, in one process.

    python3 -m portbench.control --workload <name> --seeds 1 2 3 \
        [--program-seconds S] [--control-units N] [--fault <name>]

For each seed, on the card:

  * ``program``: a run of the cell as ``python3 -m portbench`` makes it
    (window of ``--program-seconds``), and its compared numbers: the lower
    readings;
  * ``control``: the control of the cell's loop, from its family's
    ``CONTROLS`` (``portbench/loops.py``): the reference put in the port's
    place at the cell's own size, one precision below the configuration's,
    over ``--control-units`` units, judged as a run is. Its numbers are the
    upper readings;
  * with ``--fault``, the ``program`` run has that fault of the family's
    ``FAULTS`` planted in the port: the upper reading of a number that the
    control cannot move.

One JSON line a seed and side on standard output. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

from portbench.run import family, load_cell, member, run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program-seconds", type=float, default=0.0,
                    help="0: no program runs")
    ap.add_argument("--control-units", type=int, default=0,
                    help="0: no control runs")
    ap.add_argument("--fault", help="plant this fault of the cell's family "
                                    "in the program's runs")
    args = ap.parse_args(argv)
    from amf_tpu_torch.utils.platform import resolve_device

    cell = load_cell(args.workload)
    fam = family(cell.config["model"])
    fault = member(fam, "FAULTS", args.fault) if args.fault else None
    control = (member(fam, "CONTROLS", cell.traffic["loop"])
               if args.control_units > 0 else None)
    device = resolve_device("cuda")
    for seed in args.seeds:
        if args.program_seconds > 0:
            with fault() if fault else contextlib.nullcontext():
                out = run_cell(cell, seed, args.program_seconds, False,
                               device)
            print(json.dumps({"seed": seed,
                              "side": f"fault:{args.fault}" if args.fault
                              else "program",
                              "correct": out["correct"],
                              "checks": out["checks"],
                              "metrics": out["metrics"]}), flush=True)
        if control is not None:
            nums = control(cell, seed, device, args.control_units)
            print(json.dumps({"seed": seed, "side": "control",
                              "numbers": nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
