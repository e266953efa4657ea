"""active_score_s: the mean over the window's steps of the host time from
a step's start to its pick's host read (score, pick, the evals' copy)."""


def read(r):
    if r.loop.kind != "active_steps":
        return None
    spans = r.loop.spans[:r.window.units]
    return sum(s for s, _ in spans) / len(spans) if spans else None
