"""lookahead_refit_pct: the stream time of the lane refits (the spans
``pmf.fit`` inside ``lookahead.tile``) over the traced tiles' stream time
(the ``lookahead.tile`` spans), in %. Needs the card's stream events."""

from portbench.metrics._spans import stream_pct


def read(r):
    if r.loop.kind != "lookahead_tiles":
        return None
    return stream_pct("pmf.fit", "lookahead.tile")
