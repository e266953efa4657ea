"""active_step_s: the window's time over the steps it completed, in the
cells whose loop runs one active step a unit (``unit_counts``,
``portbench/loops.py``)."""


def read(r):
    if r.loop.unit_counts != "steps":
        return None
    return r.window.seconds / r.window.units
