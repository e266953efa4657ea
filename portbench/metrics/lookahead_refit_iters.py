"""lookahead_refit_iters: the passes of the lane refits' lockstep loop (the
``iters`` of the spans ``pmf.fit`` inside ``lookahead.tile``), a traced
tile's mean."""

from portbench.metrics._spans import per_outer


def read(r):
    if r.loop.kind != "lookahead_tiles":
        return None
    return per_outer("pmf.fit", "lookahead.tile",
                     lambda s: s.attrs.get("iters"))
