"""boost_mfu: the operations the window's tiles need
(``portbench/models/pmf_refit/counts.tile_flops``: B4 on every evaluation
of each tile's refit loop, counted by its launches, and every lane's
prediction for its RMSE) over the window's time, over the card's float32
peak."""

from portbench.metrics._shared import mfu_pct
from portbench.models.pmf_refit import counts


def read(r):
    if r.loop.kind != "boost_tiles":
        return None
    c = r.config
    flops = sum(counts.tile_flops(r.loop.lanes, c["rows"], c["cols"],
                                  c["latent_d"], r.known, e)
                for e in r.loop.evaluations()[:r.window.units])
    return mfu_pct(r, flops)
