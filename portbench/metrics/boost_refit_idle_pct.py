"""boost_refit_idle_pct: the device-idle gaps of the traced window whose
midpoint lies inside the lanes' refit (the spans ``pmf.refit_batch``),
over the window, in %."""

from portbench.metrics._spans import idle_pct_inside


def read(r):
    if r.loop.kind != "boost_tiles":
        return None
    return idle_pct_inside(r, "pmf.refit_batch")
