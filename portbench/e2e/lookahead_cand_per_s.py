"""lookahead_cand_per_s: every candidate the window scored over all of the
window's time (host clock, synchronize to synchronize)."""


def read(r):
    if r.loop.kind != "lookahead_tiles":
        return None
    return r.window.attempted / r.window.seconds
