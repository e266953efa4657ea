"""boost_refit_pct: the stream time of the lanes' refit (the spans
``pmf.refit_batch`` inside ``boost.tile``) over the traced tiles' stream
time (the ``boost.tile`` spans), in %. Needs the card's stream events."""

from portbench.metrics._spans import stream_pct


def read(r):
    if r.loop.kind != "boost_tiles":
        return None
    return stream_pct("pmf.refit_batch", "boost.tile")
