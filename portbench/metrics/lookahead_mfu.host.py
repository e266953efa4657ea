"""lookahead_mfu.host:
``lookahead_mfu``, in the cells that
report ``lookahead_cand_per_s.host``."""

from portbench.run import reader

read = reader("metrics", "lookahead_mfu")
