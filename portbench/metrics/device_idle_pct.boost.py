"""device_idle_pct.boost: 1 - the union of the card's operations over the
traced tiles' window."""

from portbench.metrics._shared import idle_pct


def read(r):
    return idle_pct(r.trace) if r.loop.kind == "boost_tiles" else None
