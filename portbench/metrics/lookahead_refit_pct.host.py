"""lookahead_refit_pct.host:
``lookahead_refit_pct``, in the cells that
report ``lookahead_cand_per_s.host``."""

from portbench.run import reader

read = reader("metrics", "lookahead_refit_pct")
