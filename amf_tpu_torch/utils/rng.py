"""Seeded random streams.

The JAX package derives streams from ``jax.random`` keys; here a stream is
an integer seed, a child seed is derived by a fixed 64-bit mix, and draws
come from a ``torch.Generator`` seeded with it. The two packages give
different numbers from the same seed; the tests hand both the same noise.
"""

from __future__ import annotations

import zlib
from typing import List, Sequence

import torch

_MASK64 = (1 << 64) - 1


def fold_in(seed: int, data: int) -> int:
    """Child seed of ``seed`` for the integer ``data`` (splitmix64 mix).

    Deterministic across processes and platforms; the result fits 63 bits
    so it is a valid ``torch.Generator`` seed.
    """
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(data) + 0x632BE59BD9B4E019) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) >> 1


def fold_in_name(seed: int, name: str) -> int:
    """Named child stream with a PROCESS-STABLE hash.

    Python's ``hash(str)`` is salted per interpreter, which would make a
    fixed --seed unreproducible across runs; crc32 is stable everywhere.
    """
    return fold_in(seed, zlib.crc32(name.encode()) & 0x7FFFFFFF)


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed))
    return gen


def lane_seeds(seed: int, cand: Sequence[int], n_vals: int) -> List[int]:
    """Seeds of the (candidate, value) lanes, in candidate-major order.

    Each lane's seed comes from the GLOBAL flat candidate index, not from
    the lane's position in the current batch, so the scores do not depend
    on how the candidate axis is tiled.
    """
    return [fold_in(fold_in(seed, int(c)), v)
            for c in cand for v in range(n_vals)]


def lane_generators(seed: int, cand: Sequence[int], n_vals: int, device
                    ) -> List[torch.Generator]:
    """One generator per (candidate, value) lane (see ``lane_seeds``)."""
    return [generator(s, device) for s in lane_seeds(seed, cand, n_vals)]


def lane_normals(generators: Sequence[torch.Generator], size: int, dtype,
                 device) -> torch.Tensor:
    """(L, size) standard normals, row l from generator l in one draw each."""
    out = torch.empty((len(generators), size), dtype=dtype, device=device)
    for row, gen in zip(out, generators):
        row.normal_(generator=gen)
    return out


def lane_gammas(generators: Sequence[torch.Generator],
                shape: torch.Tensor) -> torch.Tensor:
    """(L, k) standard Gamma draws with shape parameters ``shape`` (k,),
    row l from generator l in one draw each."""
    return torch.stack([torch._standard_gamma(shape, generator=gen)
                        for gen in generators])
