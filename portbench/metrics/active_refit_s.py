"""active_refit_s: the mean over the window's steps of the host time from
the pick to the recorded error's host read (query, MAP refit, chain,
error)."""


def read(r):
    if r.loop.kind != "active_steps":
        return None
    spans = r.loop.spans[:r.window.units]
    return sum(t for _, t in spans) / len(spans) if spans else None
