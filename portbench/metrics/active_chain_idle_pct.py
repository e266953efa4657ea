"""active_chain_idle_pct: the device-idle gaps of the traced window whose
midpoint lies inside the fresh chain (the spans ``gibbs.chain``, their
``gibbs.noise`` draws included), over the window, in %."""

from portbench.metrics._spans import idle_pct_inside


def read(r):
    if r.loop.kind != "active_steps":
        return None
    return idle_pct_inside(r, "gibbs.chain")
