"""The traced run's device trace: capture with ``torch.profiler`` and read.

The profiler records the host's operators and the card's kernels, copies
and fills over a few units of work; its Chrome trace is written to a
temporary directory under ``TMPDIR``, read back and deleted. What the
per-layer readers take from it:

  * ``device_ops``: every kernel, copy and fill on the card (name, start,
    length, in microseconds of the trace's clock);
  * ``busy_s``: the length of the union of those intervals;
  * ``idle_by_host_op``: each idle gap between them, put under the
    innermost host operator running at the gap's middle on the thread that
    launched the most work (``(no operator)`` where Python alone ran), the
    seconds summed by operator;
  * ``top_device_ops``: device seconds summed by name.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
import time
from collections import Counter, defaultdict
from typing import Callable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op",)
NAME_CHARS = 160


@dataclasses.dataclass
class Trace:
    device_ops: List[Tuple[str, float, float]]  # (name, ts_us, dur_us)
    host_ops: List[Tuple[str, float, float]]
    window_s: float  # host clock around the traced work, sync to sync
    copy_names: frozenset = frozenset()  # device ops that are no kernel

    @property
    def kernels(self) -> List[Tuple[str, float, float]]:
        return [e for e in self.device_ops if e[0] not in self.copy_names]

    def busy_s(self) -> float:
        return sum(b - a for a, b in _union(self.device_ops)) * 1e-6

    def top_device_ops(self, k: int = 10) -> List[list]:
        tot: Counter = Counter()
        for name, _, dur in self.device_ops:
            tot[name[:NAME_CHARS]] += dur * 1e-6
        return [[n, s] for n, s in tot.most_common(k)]

    def idle_by_host_op(self, k: int = 10) -> List[list]:
        spans = _union(self.device_ops)
        gaps = [(a1, b0) for (_, a1), (b0, _) in zip(spans, spans[1:])]
        tot: Counter = Counter()
        host = sorted(self.host_ops, key=lambda e: e[1])
        starts = [e[1] for e in host]
        for a, b in gaps:
            tot[_innermost(host, starts, (a + b) / 2)] += (b - a) * 1e-6
        return [[n, s] for n, s in tot.most_common(k)]


def _union(ops) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for _, ts, dur in sorted(ops, key=lambda e: e[1]):
        if out and ts <= out[-1][1]:
            out[-1][1] = max(out[-1][1], ts + dur)
        else:
            out.append([ts, ts + dur])
    return [tuple(x) for x in out]


def _innermost(host, starts, t: float, reach: int = 256) -> str:
    """The shortest host operator that contains time ``t``."""
    best, best_dur = "(no operator)", float("inf")
    hi = bisect.bisect_right(starts, t)
    for name, ts, dur in host[max(0, hi - reach):hi]:
        if ts + dur >= t and dur < best_dur:
            best, best_dur = name[:NAME_CHARS], dur
    return best


def parse(path: str, window_s: float) -> Trace:
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    device, host_by_tid = [], defaultdict(list)
    copies = set()
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        rec = (e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)))
        if cat in DEVICE_CATS:
            device.append(rec)
            if cat != "kernel":
                copies.add(rec[0])
        elif cat in HOST_CATS:
            host_by_tid[e.get("tid")].append(rec)
    host = max(host_by_tid.values(), key=len) if host_by_tid else []
    return Trace(device_ops=device, host_ops=host, window_s=window_s,
                 copy_names=frozenset(copies))


def capture(work: Callable[[], None], sync: Callable[[], None]
            ) -> Optional[Trace]:
    """Run ``work`` under the profiler (host operators and the card) and
    read its trace; None where the profiler recorded nothing on the card."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory(prefix="portbench-trace-") as tmp:
        path = os.path.join(tmp, "trace.json")
        with torch.profiler.profile(activities=acts) as prof:
            sync()
            t0 = time.perf_counter()
            work()
            sync()
            window_s = time.perf_counter() - t0
        prof.export_chrome_trace(path)
        tr = parse(path, window_s)
    return tr if tr.device_ops else None
