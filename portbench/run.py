"""The benchmark of ``amf_tpu_torch``: one cell, one run, one JSON line.

    python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is looked up by name in ``BENCHMARK.json`` at the checkout's
root; its configuration file, its traffic file
(``portbench/traffic/<traffic>.json``), its model family (the
configuration's ``model``: ``portbench/models/<model>/``, ``family``), its
loop (the traffic's ``loop``, one of the family's ``LOOPS``) and the
reader of each of its metrics (``portbench/e2e/<name>.py``,
``portbench/metrics/<name>.py``) are found by their names. A run:

  1. refuses without enough CUDA cards (exit 3, no result); runs torch
     on one host thread, with Python's bytecode cached in
     ``build/pycache/`` of the checkout;
  2. set-up: makes the inputs from the configuration
     (``portbench/data.py``), starts the family's loop on the device (the
     port's problem and the state its first unit needs), runs one warm
     unit of the cell's own shapes, and freezes the set-up's objects out
     of the garbage collector's reach; ``setup_s`` runs from the process's
     start to the first timed unit, and standard error gives its phases;
  3. the window: units back to back until the first that ends at or after
     ``--seconds`` (``portbench/loops.py``, which gives a loop's contract);
  4. with ``--trace 1``, ``trace_units`` more units under the profiler
     (``portbench/trace.py``), after the window;
  5. reads the peak memory, frees the port's state, and checks the
     outputs against the family's plain reference (the loop's ``check``,
     judged by ``portbench/check.py``);
  6. prints the compared numbers beside their limits on standard error,
     then the result line on standard output: the end-to-end metrics, or
     with ``--trace 1`` the per-layer ones, and under ``checks``, last,
     each compared number with its limit.

A run exits non-zero and prints no result when a module named ``jax``,
``jaxlib``, ``flax`` or ``amf_tpu`` (by whole top-level name) is loaded
once the window has closed.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "amf_tpu")


def since_start() -> float:
    """Seconds since this process started (its start time in the kernel's
    process table, against the boot clock)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


PHASES: List[tuple] = []  # (set-up phase, since_start() at its end)


def mark(phase: str) -> None:
    PHASES.append((phase, since_start()))


@dataclasses.dataclass
class Cell:
    workload: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]  # the manifest's metrics this cell reports
    per_layer: List[dict]


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    man = json.loads((root / "BENCHMARK.json").read_text())
    wl = next((w for w in man["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cfg = next(c for c in man["configs"] if c["name"] == wl["config"])
    return Cell(
        workload=workload,
        config=json.loads((root / cfg["file"]).read_text()),
        traffic=json.loads(
            (HERE / "traffic" / f"{wl['traffic']}.json").read_text()),
        chips=wl["chips"],
        end_to_end=[m for m in man["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in man["per_layer"] if _applies(m, workload)])


def named(folder: str, name: str, attr: str):
    """``attr`` of ``portbench/<folder>/<name>.py``, loaded from its path."""
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise LookupError(f"no {name!r} in portbench/{folder}/: "
                          f"portbench/{folder}/{name}.py is not a file")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, attr)


def reader(kind: str, name: str):
    """The ``read`` function of ``portbench/<kind>/<name>.py``."""
    return named(kind, name, "read")


def family(model: str):
    """The model family ``portbench/models/<model>/`` (see ``loops.py``)."""
    path = HERE / "models" / model / "__init__.py"
    if not (model.isidentifier() and path.is_file()):
        raise LookupError(f"no model family {model!r}: portbench/models/"
                          f"{model}/__init__.py is not a file")
    return importlib.import_module(f"portbench.models.{model}")


def member(fam, table: str, name: str):
    """``fam.<table>[name]``, or an error that names the family's file."""
    got = getattr(fam, table, {})
    if name not in got:
        where = fam.__name__.replace(".", "/") + "/__init__.py"
        raise LookupError(f"no {name!r} in {table} of {where} (it has "
                          f"{sorted(got)})")
    return got[name]


@dataclasses.dataclass
class Reading:
    """What the readers of a run's metrics read."""

    loop: object  # the cell's loop (see loops.py), its port state freed
    config: dict
    traffic: dict
    device_name: str
    setup_s: float
    window: object  # loops.Window
    window_peak_bytes: Optional[int]
    known: int  # cells known at the start
    trace: Optional[object] = None  # trace.Trace


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
        return out.stdout.strip().splitlines()[0].split(",")[-1].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device) -> dict:
    """One run of ``cell`` on ``device``; returns the result line as a
    dict (without the look for forbidden modules)."""
    import torch

    from portbench import check, loops
    from portbench.data import make_inputs
    from portbench.trace import capture

    cuda = device.type == "cuda"
    Loop = member(family(cell.config["model"]), "LOOPS", cell.traffic["loop"])
    s = loops.Setting(cell.config, cell.traffic, seed, device)
    inputs = make_inputs(cell.config)
    mark("inputs")
    loop = Loop(s, inputs)
    loops.sync(device)
    mark("start")  # the family's start: the problem on the card, its state
    loop.warm()
    loops.sync(device)
    mark("warm")
    # The set-up's objects out of the collector's reach for the window: a
    # full collection then walks only what the window makes.
    gc.collect()
    gc.freeze()
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = since_start()
    win = loops.run_window(loop, seconds, device,
                           getattr(loop, "exhausted", None))
    print(f"window: {win.units} units in {win.seconds!r} s; a unit "
          f"{min(win.unit_s)!r} to {max(win.unit_s)!r} s, median "
          f"{sorted(win.unit_s)[len(win.unit_s) // 2]!r}; set-up "
          f"{setup_s!r} s", file=sys.stderr)
    print("set-up phases (s from the process's start): " + ", ".join(
        f"{k} {v:.3f}" for k, v in PHASES), file=sys.stderr)
    gc.unfreeze()
    win_peak = torch.cuda.max_memory_allocated(device) if cuda else None
    attempted = win.attempted
    tr = None
    if trace:
        n = cell.traffic["trace_units"]
        for _ in range(3):  # a window the profiler saw nothing of is retried
            got = []
            tr = capture(lambda: got.extend(loop.unit() for _ in range(n)),
                         lambda: loops.sync(device))
            attempted += sum(got)
            if tr is not None:
                break
    if cuda:
        peak = max(peak, torch.cuda.max_memory_allocated(device))
    failed = loop.failed()
    loop.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    numbers = loop.check(inputs)
    correct, rows = check.judge(numbers, cell.traffic["check"]["limits"],
                                attempted, failed)

    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    r = Reading(loop=loop, config=cell.config, traffic=cell.traffic,
                device_name=name, setup_s=setup_s, window=win,
                window_peak_bytes=win_peak, known=int(inputs.known.sum()),
                trace=tr)
    metrics: Dict[str, dict] = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = reader("metrics" if trace else "e2e", m["name"])(r)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": name,
           "count": cell.chips if cuda else 0, "memory_peak_bytes": peak}
    if cuda:
        dev["power_limit"] = power_limit()
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.top_device_ops(),
                            "idle_gaps": tr.idle_by_host_op()}
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return out


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def emit(out: dict) -> int:
    """Print the checks on standard error, then the result line; or, with
    a forbidden module loaded, name it and print no result."""
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    mark("python")
    # Python's bytecode cache inside the checkout, at a fixed path, even
    # where PYTHONDONTWRITEBYTECODE is set: without it every process
    # compiles torch's sources afresh, most of set-up and most of its
    # spread (PERF.md, section 2). Only a checkout's first run writes it.
    sys.pycache_prefix = str(ROOT / "build" / "pycache")
    sys.dont_write_bytecode = False
    # One thread for torch, OpenMP, MKL and OpenBLAS: the pace of a
    # host-bound cell is its Python thread's, and a pool's threads beside
    # it spread the runs (PERF.md, section 2).
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    import torch

    torch.set_num_threads(1)
    mark("torch")

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s), "
              f"found {have}", file=sys.stderr)
        return 3
    from amf_tpu_torch.utils.platform import resolve_device

    device = resolve_device("cuda")
    torch.zeros(1, device=device)
    mark("card")
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
    return emit(out)
