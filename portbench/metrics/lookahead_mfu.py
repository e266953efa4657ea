"""lookahead_mfu: the operations the window's lane chains need
(``counts.chain_sample_flops``: every lane, every sample, on the known
cells plus the lane's own) over the window's time, over the card's
float32 peak."""

from portbench import counts
from portbench.metrics._shared import mfu_pct


def read(r):
    if r.loop.kind != "lookahead_tiles":
        return None
    c = r.config
    per_lane = c["lookahead_samples"] * counts.chain_sample_flops(
        c["rows"], c["cols"], c["latent_d"], r.known + 1)
    return mfu_pct(r, r.window.units * r.loop.lanes * per_lane)
