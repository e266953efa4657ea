"""b1_roofline_pct.lookahead_host:
``b1_roofline_pct.lookahead``, in the cells that
report ``lookahead_cand_per_s.host``."""

from portbench.run import reader

read = reader("metrics", "b1_roofline_pct.lookahead")
