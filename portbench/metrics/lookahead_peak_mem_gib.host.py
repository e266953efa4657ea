"""lookahead_peak_mem_gib.host:
``lookahead_peak_mem_gib``, in the cells that
report ``lookahead_cand_per_s.host``."""

from portbench.run import reader

read = reader("metrics", "lookahead_peak_mem_gib")
