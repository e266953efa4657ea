"""boost_refit_passes: the passes of the lanes' lockstep refit loop (the
``passes`` of the spans ``pmf.refit_batch`` inside ``boost.tile``:
``DescentInfo.loop_iters``, a host int), a traced tile's mean."""

from portbench.metrics._spans import per_outer


def read(r):
    if r.loop.kind != "boost_tiles":
        return None
    return per_outer("pmf.refit_batch", "boost.tile",
                     lambda s: s.attrs.get("passes"))
