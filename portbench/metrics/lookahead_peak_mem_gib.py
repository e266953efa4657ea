"""lookahead_peak_mem_gib: the card's allocated peak over the window
(``max_memory_allocated`` after a reset at the window's start)."""


def read(r):
    if r.loop.kind != "lookahead_tiles" or r.window_peak_bytes is None:
        return None
    return r.window_peak_bytes / 2 ** 30
