"""lookahead_gemm_pct.host:
``lookahead_gemm_pct``, in the cells that
report ``lookahead_cand_per_s.host``."""

from portbench.run import reader

read = reader("metrics", "lookahead_gemm_pct")
