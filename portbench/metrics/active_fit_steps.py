"""active_fit_steps: the steps the warm MAP refit accepted (the
``accepts`` of the span ``pmf.fit`` inside ``active.refit``), a traced
step's mean."""

from portbench.metrics._spans import per_outer


def read(r):
    if r.loop.kind != "active_steps":
        return None
    return per_outer("pmf.fit", "active.refit",
                     lambda s: s.attrs.get("accepts"))
