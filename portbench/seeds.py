"""Seed arithmetic shared by the harness and the reference.

The port roots every random stream in an integer seed and derives child
seeds by a splitmix64 mix (its ``utils/rng.fold_in``); each stream is a
``torch.Generator`` seeded with one. The benchmark derives the seeds it
hands the port (the family's seed, the tiles' lane seeds) and the seeds
the reference draws the same noise from with this copy of that
arithmetic, so the reference needs nothing of the port.
"""

from __future__ import annotations

import zlib

_MASK64 = (1 << 64) - 1


def fold_in(seed: int, data: int) -> int:
    """Child seed of ``seed`` for the integer ``data``: splitmix64, cut to
    63 bits so that it is a valid ``torch.Generator`` seed."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(data)
         + 0x632BE59BD9B4E019) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) >> 1


def fold_in_name(seed: int, name: str) -> int:
    """Named child seed, by a hash that is the same in every process."""
    return fold_in(seed, zlib.crc32(name.encode()) & 0x7FFFFFFF)


def lane_seeds(seed: int, cand, n_vals: int):
    """Seeds of the (candidate, value) lanes of a lookahead under ``seed``,
    candidate-major: one per flat candidate cell and value index."""
    return [fold_in(fold_in(seed, int(c)), v)
            for c in cand for v in range(n_vals)]


def tile_seed(seed: int, tile: int) -> int:
    """The lane seed a lookahead tile is scored under: ``--seed`` folded
    with the tile's index (the warm tile is index -1)."""
    return fold_in(fold_in_name(seed, "tiles"), tile & _MASK64)


def numpy_seed(seed: int) -> int:
    """``--seed`` as a non-negative integer for ``numpy.random``."""
    return int(seed) & _MASK64
