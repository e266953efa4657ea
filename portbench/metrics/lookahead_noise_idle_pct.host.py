"""lookahead_noise_idle_pct.host: the device-idle gaps of the traced
window whose midpoint lies inside a lane chain's noise draws (the spans
``gibbs.noise``), over the window, in %."""

from portbench.metrics._spans import idle_pct_inside


def read(r):
    if r.loop.kind != "lookahead_tiles":
        return None
    return idle_pct_inside(r, "gibbs.noise")
