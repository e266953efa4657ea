"""lookahead_gram_index_pct: the share of the lane chains whose row draws
sum the masked Gram over the rated-cell index (the ``gram_index``
attribute, 1 or 0, of the spans ``gibbs.chain`` inside ``lookahead.tile``),
in %. None where the port records no such attribute."""

from portbench.metrics._spans import within


def read(r):
    if r.loop.kind != "lookahead_tiles":
        return None
    got = within("gibbs.chain", "lookahead.tile")
    if got is None or not got[0]:
        return None
    flags = [s.attrs.get("gram_index") for s in got[0]]
    if any(f is None for f in flags):
        return None
    return 100.0 * sum(flags) / len(flags)
