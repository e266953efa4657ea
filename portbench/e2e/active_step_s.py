"""active_step_s: the window's time over the steps it completed."""


def read(r):
    if r.loop.kind != "active_steps":
        return None
    return r.window.seconds / r.window.units
