"""lookahead_gemm_pct: device time of the cuBLAS and CUTLASS matrix
products over all kernel time, in the traced tiles."""

from portbench.metrics._shared import gemm_pct


def read(r):
    return gemm_pct(r.trace) if r.loop.kind == "lookahead_tiles" else None
