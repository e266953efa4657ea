"""b1_roofline_pct.active: B1's least time over its device time in the
traced steps, whose chains draw one lane."""

from portbench.metrics._shared import b1_roofline_pct


def read(r):
    if r.loop.kind != "active_steps":
        return None
    return b1_roofline_pct(r, 1)
