"""b1_roofline_pct.lookahead: B1's least time by its bytes and operations
(``portbench/counts.py``) over its device time, in the traced tiles."""

from portbench.metrics._shared import b1_roofline_pct


def read(r):
    if r.loop.kind != "lookahead_tiles":
        return None
    return b1_roofline_pct(r, r.loop.lanes)
