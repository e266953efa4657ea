"""What the span readers share: the spans the port recorded in the traced
units (``amf_tpu_torch.utils.profiling``: tracing is on while the
profiler runs), grouped under their outer spans, and the traced window's
idle gaps put on the spans' clock.

Every function returns None where the port records no spans (a port
without the span API) or the cell recorded none of the spans asked for.
A reader normalises by the outer spans it finds (a traced unit that the
profiler saw nothing of is run again, and its spans stay), never by the
traffic's ``trace_units``.
"""

from __future__ import annotations

import bisect

from portbench.trace import _union


def recorded():
    """The port's recorded spans, or None where it has no span API."""
    try:
        from amf_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return read() if read is not None else None


def within(name: str, outer: str):
    """(the spans named ``name`` inside a span named ``outer``, the
    ``outer`` spans), or None where no ``outer`` span was recorded."""
    recs = recorded()
    if not recs:
        return None
    by_id = {s.id: s for s in recs}
    outers = [s for s in recs if s.name == outer]
    if not outers:
        return None

    def inside(s):
        p = by_id.get(s.parent)
        while p is not None:
            if p.name == outer:
                return True
            p = by_id.get(p.parent)
        return False

    return [s for s in recs if s.name == name and inside(s)], outers


def per_outer(name: str, outer: str, value):
    """The sum of ``value(span)`` over the spans named ``name`` inside
    ``outer`` spans, over the number of ``outer`` spans; None where a
    value is None."""
    got = within(name, outer)
    if got is None:
        return None
    inner, outers = got
    vals = [value(s) for s in inner]
    if any(v is None for v in vals):
        return None
    return sum(vals) / len(outers)


def stream_pct(name: str, outer: str):
    """The stream time of the ``name`` spans inside ``outer`` spans over
    the ``outer`` spans' stream time, in %; None without a card."""
    got = within(name, outer)
    if got is None:
        return None
    inner, outers = got
    times = [s.stream_s for s in inner + outers]
    if any(t is None for t in times):
        return None
    total = sum(s.stream_s for s in outers)
    return 100.0 * sum(s.stream_s for s in inner) / total if total > 0 \
        else None


def idle_pct_inside(r, name: str):
    """The device-idle gaps of the traced window whose midpoint lies
    inside a span named ``name``, over the window, in %. The spans are put
    on the trace's clock by the whole seconds that bring the last span's
    end onto the last host operator's end (``profiling.trace_base_ns``):
    the last, because the spans of a traced attempt that was run again
    come first. None without a device trace."""
    tr = r.trace
    if tr is None or not tr.host_ops or tr.window_s <= 0:
        return None
    recs = recorded()
    if not recs:
        return None
    from amf_tpu_torch.utils import profiling

    last = max(recs, key=lambda s: s.end_ns)
    base = profiling.trace_base_ns(
        last.end_ns, max(ts + dur for _, ts, dur in tr.host_ops))
    spans = sorted(profiling.on_trace_clock(s, base)
                   for s in recs if s.name == name)
    if not spans:
        return None
    starts = [a for a, _ in spans]
    busy = _union(tr.device_ops)
    idle_us = 0.0
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = (a + b) / 2
        k = bisect.bisect_right(starts, mid) - 1
        if k >= 0 and mid <= spans[k][1]:
            idle_us += b - a
    return 100.0 * idle_us * 1e-6 / tr.window_s
