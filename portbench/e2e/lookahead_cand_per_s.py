"""lookahead_cand_per_s: every candidate the window scored over all of the
window's time (host clock, synchronize to synchronize), in the cells whose
loop counts candidates a unit (``unit_counts``, ``portbench/loops.py``)."""


def read(r):
    if r.loop.unit_counts != "candidates":
        return None
    return r.window.attempted / r.window.seconds
