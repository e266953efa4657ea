"""Spans, counters and device traces of the port (the JAX package's
``amf_tpu/utils/profiling.py`` has the phase report).

A span times one unit of the port's work at a boundary between layers;
its attributes are the unit's counters::

    with span("gibbs.chain", rounds=num_samps) as sp:
        ...
        sp.set(lanes=L)          # known only inside

Tracing is on while a ``torch.profiler`` session is active in this
process, or inside ``tracing()``. Otherwise a span is one flag read and a
shared null context, and records nothing. While tracing is on, a span
records in memory its name, its id, its parent's id and its root's id
(every span under one outermost span shares that span's id as its root),
the host clock at its start and end, and its attributes. The host clock is
``time.time_ns()``, the clock a profiler's Chrome trace is written from
(the trace's ``ts`` is that clock less its ``baseTimeNanoseconds``). Under
a profiler a span also opens ``torch.profiler.record_function`` under its
name, so it shows in the trace above the operators it ran. On the card it
records a pair of CUDA events on the current stream, which give its
stream time. A span launches nothing and never waits for the device:
tensor attributes are reduced and read, and the events timed, only by
``spans()``.

    with tracing():
        run_active_gibbs(...)
    print(phase_report())        # the spans by name: calls, total and mean s

    with device_trace("traces/run1"):   # trace.json and spans.json
        run_active_pmf(...)
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import re
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_closed: List["Span"] = []
_forced = 0  # depth of open ``tracing()`` blocks


def enabled() -> bool:
    """Whether spans record: a profiler is active or ``tracing()`` is open."""
    return bool(_forced) or _autograd_profiler._is_profiler_enabled


@dataclasses.dataclass
class Span:
    """One recorded span. ``start_ns``/``end_ns`` are ``time.time_ns()``;
    ``stream_s`` (the time between its CUDA events on the stream) is set
    by ``spans()``, None where no event was recorded (no card, or a
    stream being captured into a CUDA graph)."""

    name: str
    id: int
    parent: Optional[int]
    root: int
    start_ns: int
    end_ns: int = 0
    attrs: dict = dataclasses.field(default_factory=dict)
    stream_s: Optional[float] = None
    events: Optional[Tuple[object, object]] = dataclasses.field(
        default=None, repr=False)

    @property
    def host_s(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def set(self, **attrs) -> None:
        """Add attributes; a tensor is kept as it is until ``spans()``."""
        self.attrs.update(attrs)

    def settle(self) -> None:
        """Time the events and read the tensor attributes (their means)."""
        if self.events is not None:
            start, end = self.events
            end.synchronize()
            self.stream_s = start.elapsed_time(end) * 1e-3
            self.events = None
        for k, v in self.attrs.items():
            if isinstance(v, torch.Tensor):
                self.attrs[k] = float(v.double().mean())


class _NullSpan:
    def set(self, **attrs) -> None:
        pass


_NULL = contextlib.nullcontext(_NullSpan())


def _stack() -> List[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _stream_events():
    """A started pair of timing events on the current stream, or None."""
    if not torch.cuda.is_initialized() or \
            torch.cuda.is_current_stream_capturing():
        return None
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    return start, end


class _Open:
    __slots__ = ("name", "attrs", "_range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> Span:
        stack = _stack()
        parent = stack[-1] if stack else None
        sid = next(_ids)
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            self._range = _autograd_profiler.record_function(self.name)
            self._range.__enter__()
        events = _stream_events()
        sp = Span(self.name, sid, None if parent is None else parent.id,
                  sid if parent is None else parent.root, time.time_ns(),
                  attrs=dict(self.attrs), events=events)
        stack.append(sp)
        return sp

    def __exit__(self, *exc) -> bool:
        sp = _stack().pop()
        sp.end_ns = time.time_ns()
        if sp.events is not None:
            if torch.cuda.is_current_stream_capturing():
                sp.events = None
            else:
                sp.events[1].record()
        if self._range is not None:
            self._range.__exit__(*exc)
        with _lock:
            _closed.append(sp)
        return False


def span(name: str, **attrs):
    """A context manager that records one span while tracing is on (see
    the module) and yields it (``set`` adds attributes); otherwise the
    shared null context, whose ``set`` does nothing."""
    if not (_forced or _autograd_profiler._is_profiler_enabled):
        return _NULL
    return _Open(name, attrs)


@contextlib.contextmanager
def tracing() -> Iterator[None]:
    """Spans record inside this block, with or without a profiler."""
    global _forced
    with _lock:
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1


def synchronize(device) -> None:
    """Wait for ``device`` while tracing is on, so that a span ending here
    holds its device work in its host time; nothing otherwise."""
    if enabled() and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def spans(reset: bool = False) -> List[Span]:
    """The closed spans, in the order they opened (settled: see
    ``Span.settle``); ``reset`` forgets them."""
    with _lock:
        out = sorted(_closed, key=lambda s: s.id)
        if reset:
            _closed.clear()
    for sp in out:
        sp.settle()
    return out


def self_s(sp: Span, records: List[Span]) -> float:
    """``sp``'s host time less what its children in ``records`` cover."""
    return sp.host_s - sum(c.host_s for c in records if c.parent == sp.id)


def trace_base_ns(span_ns: int, op_us: float) -> int:
    """A Chrome trace's ``baseTimeNanoseconds`` from a span's host stamp
    ``span_ns`` and the trace time ``op_us`` of a host operator within half
    a second of it: the whole number of seconds between the two clocks (the
    profiler writes a base of whole seconds)."""
    return round((span_ns - op_us * 1e3) / 1e9) * 1_000_000_000


def on_trace_clock(sp: Span, base_ns: int) -> Tuple[float, float]:
    """(start, end) of ``sp`` in microseconds of a trace with that base."""
    return (sp.start_ns - base_ns) * 1e-3, (sp.end_ns - base_ns) * 1e-3


def phase_report(reset: bool = False) -> str:
    """The recorded spans by name, the most total host time first: calls,
    total and mean seconds (the JAX package's phase report)."""
    totals: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for sp in spans(reset=reset):
        totals[sp.name] = totals.get(sp.name, 0.0) + sp.host_s
        counts[sp.name] = counts.get(sp.name, 0) + 1
    lines = [f"{'phase':<32} {'calls':>6} {'total s':>10} {'mean s':>10}"]
    for name in sorted(totals, key=lambda n: -totals[n]):
        t, c = totals[name], counts[name]
        lines.append(f"{name:<32} {c:>6} {t:>10.3f} {t / c:>10.4f}")
    return "\n".join(lines)


_BASE = re.compile(rb'"baseTimeNanoseconds"\s*:\s*(\d+)')


def chrome_trace_base_ns(path: str) -> Optional[int]:
    """The ``baseTimeNanoseconds`` of a Chrome trace (from its header)."""
    with open(path, "rb") as f:
        m = _BASE.search(f.read(1 << 16))
    return int(m.group(1)) if m else None


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator["torch.profiler.profile"]:
    """``torch.profiler`` trace around a block, written when the block ends
    to ``<logdir>/trace.json`` (a Chrome trace: the card's activity, its
    kernels, copies and the runtime calls that launched them, where there
    is a card, else the host's operators) and ``<logdir>/spans.json`` (the
    spans the block recorded, on the trace's clock: ``ts`` and ``dur`` in
    microseconds, ``stream_us``, the ids and the attributes). Yields the
    profiler; the trace is written without parsing it in Python, which for
    a long block costs far more than the block."""
    activity = (torch.profiler.ProfilerActivity.CUDA
                if torch.cuda.is_available()
                else torch.profiler.ProfilerActivity.CPU)
    os.makedirs(logdir, exist_ok=True)
    t0 = time.time_ns()
    with torch.profiler.profile(activities=[activity]) as prof:
        yield prof
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    base = chrome_trace_base_ns(path) or 0
    rows = []
    for sp in spans():
        if sp.start_ns < t0:
            continue
        ts, end = on_trace_clock(sp, base)
        rows.append(dict(name=sp.name, id=sp.id, parent=sp.parent,
                         root=sp.root, ts=ts, dur=end - ts,
                         stream_us=None if sp.stream_s is None
                         else sp.stream_s * 1e6, attrs=sp.attrs))
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump({"baseTimeNanoseconds": base, "spans": rows}, f)
