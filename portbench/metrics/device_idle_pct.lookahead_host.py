"""device_idle_pct.lookahead_host:
``device_idle_pct.lookahead``, in the cells that
report ``lookahead_cand_per_s.host``."""

from portbench.run import reader

read = reader("metrics", "device_idle_pct.lookahead")
