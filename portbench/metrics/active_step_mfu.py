"""active_step_mfu: the operations the window's steps' chains need (each
step's chain on the cells known after its pick) over the window's time,
over the card's float32 peak. The refit and the pick are not counted."""

from portbench import counts
from portbench.metrics._shared import mfu_pct


def read(r):
    if r.loop.kind != "active_steps":
        return None
    c = r.config
    flops = sum(c["base_samples"] * counts.chain_sample_flops(
        c["rows"], c["cols"], c["latent_d"], rec[0])
        for rec in r.loop.records[1:r.window.units + 1])
    return mfu_pct(r, flops)
