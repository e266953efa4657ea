"""Tracing and profiling helpers (mirrors ``amf_tpu/utils/profiling.py``).

Named wall-clock phase timers plus an optional ``torch.profiler`` trace of
the card (of the host where there is no card), usable from any loop or
CLI:

    with phase_timer("initial fit"):
        ...
    print(phase_report())

    with device_trace("/tmp/amf-trace"):   # open in chrome://tracing or Perfetto
        run_active_pmf(...)
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator

_lock = threading.Lock()
_totals: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)


@contextlib.contextmanager
def phase_timer(name: str) -> Iterator[None]:
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            _totals[name] += dt
            _counts[name] += 1


def phase_report(reset: bool = False) -> str:
    with _lock:
        lines = [f"{'phase':<32} {'calls':>6} {'total s':>10} {'mean s':>10}"]
        for name in sorted(_totals, key=lambda n: -_totals[n]):
            t, c = _totals[name], _counts[name]
            lines.append(f"{name:<32} {c:>6} {t:>10.3f} {t / c:>10.4f}")
        if reset:
            _totals.clear()
            _counts.clear()
    return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator["torch.profiler.profile"]:
    """``torch.profiler`` trace around a block, written to
    ``<logdir>/trace.json`` (a Chrome trace) when the block ends: the card's
    activity (kernels, copies and the runtime calls that launched them)
    where there is a card, else the host's operators. Yields the profiler;
    the trace is written without parsing it in Python, which for a long
    block costs far more than the block."""
    import torch

    activity = (torch.profiler.ProfilerActivity.CUDA
                if torch.cuda.is_available()
                else torch.profiler.ProfilerActivity.CPU)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=[activity]) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
