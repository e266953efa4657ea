"""lookahead_cand_per_s.host: ``lookahead_cand_per_s`` in the lookahead
cells whose pace the host's launches and syncs set: their runs spread
several times as widely as the device-bound cell's, so the two take
bounds of their own."""

from portbench.run import reader

read = reader("e2e", "lookahead_cand_per_s")
