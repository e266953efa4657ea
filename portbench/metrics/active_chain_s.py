"""active_chain_s: the host time of the fresh chain (the span
``gibbs.chain`` inside ``active.refit``), a traced step's mean."""

from portbench.metrics._spans import per_outer


def read(r):
    if r.loop.kind != "active_steps":
        return None
    return per_outer("gibbs.chain", "active.refit", lambda s: s.host_s)
