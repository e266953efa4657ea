"""b4_roofline_pct.boost: B4's least time by its bytes and operations
(``portbench/models/pmf_refit/counts.py``) over its device time, in the
traced tiles: every launch takes the tile's lanes, each adding one cell to
the known ones.

B4's launches are the kernels whose symbol is ``value_grad`` of
``csrc/pmf_value_grad.cu`` in float32 in and out, without the bf16
residual: ``(anonymous namespace)::value_grad<float, float, false, ...>``.
B2 comes from the same source; its bf16 carry has another symbol, and its
float32 layout differs from B4's only in strides, given at run time, so a
float32 B2 launch would carry B4's symbol. The cell's route (the CLI's,
``lane_block`` 0) launches no B2, and the cell's standard error counts its
B4 launches by layout.
"""

import re

from portbench import counts as peaks
from portbench.models.pmf_refit import counts

B4 = re.compile(r"(^|[\s:])value_grad<float, float, false,")


def read(r):
    if r.loop.kind != "boost_tiles" or r.trace is None:
        return None
    peak = peaks.peaks(r.device_name)
    launches = [d for n, _, d in r.trace.kernels if B4.search(n)]
    if peak is None or not launches:
        return None
    shape = (r.loop.lanes, r.config["rows"], r.config["cols"],
             r.config["latent_d"], r.known)
    least = peaks.least_seconds(counts.b4_flops(*shape),
                                counts.b4_bytes(*shape), peak)
    return 100.0 * least * len(launches) / (sum(launches) * 1e-6)
