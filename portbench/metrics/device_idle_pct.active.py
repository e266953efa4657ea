"""device_idle_pct.active: 1 - the union of the card's operations over the
traced steps' window."""

from portbench.metrics._shared import idle_pct


def read(r):
    return idle_pct(r.trace) if r.loop.kind == "active_steps" else None
