"""Seeded random streams.

The JAX package derives streams from ``jax.random`` keys; here a stream is
an integer seed, a child seed is derived by a fixed 64-bit mix, and draws
come from a ``torch.Generator`` seeded with it. The two packages give
different numbers from the same seed; the tests hand both the same noise.
Lanes draw together through ``LaneStreams``: on the card one launch for
every lane, with each lane's generator's own numbers.
"""

from __future__ import annotations

import zlib
from typing import List, Optional, Sequence, Tuple

import torch

from amf_tpu_torch.ops import lane_noise

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


class LaneStreams:
    """The noise streams of L lanes, one generator each, for a chain of
    draws (``draw``); a context manager, closed when the chain ends.

    On the card (CUDA generators) each generator is a (seed, Philox offset)
    pair, read once here: the seeds into an (L,) int64 device tensor, the
    offsets as one host int where all are equal (lane generators start at
    0) and as an (L,) device tensor where not. A draw is one launch of
    ``ops/lane_noise``'s kernel, which gives lane l the bits its
    generator's ``normal_`` and ``_standard_gamma`` would give, at the
    offset those calls would have reached, with no host work a lane.
    ``close`` sets every generator (``set_offset``) where those calls would
    have left it: L host calls a chain. Nothing else may draw from the
    generators while the streams are open, and a stream being captured into
    a CUDA graph cannot be drawn on (the offsets are the host's).

    On the CPU (a Mersenne Twister each) a draw is the per-lane calls
    (``lane_noise.lane_noise_plain``). ``batched`` says which: True where
    draws go through the kernel. ``None`` stands for the device's default
    generator.
    """

    def __init__(self, generators: Sequence[Optional[torch.Generator]],
                 device):
        self.device = torch.device(device)
        self.batched = self.device.type == "cuda"
        self.generators = list(generators)
        self._drawn = 0  # how far every lane's stream has moved
        if not self.batched:
            return
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        default = torch.cuda.default_generators[self.device.index]
        self.generators = [default if g is None else g
                           for g in self.generators]
        seeds = [g.initial_seed() for g in self.generators]
        self._offsets = [g.get_offset() for g in self.generators]
        # a seed's 64 bits as a signed int64
        self._seeds = torch.tensor([s - (s >> 63 << 64) for s in seeds],
                                   dtype=torch.int64, device=self.device)
        self._base, self._starts = min(self._offsets, default=0), None
        if len(set(self._offsets)) > 1:
            self._base = 0
            self._starts = torch.tensor(self._offsets, dtype=torch.int64,
                                        device=self.device)

    def __len__(self) -> int:
        return len(self.generators)

    def draw(self, size: int, dtype, shape: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(L, size) standard normals, row l from lane l's stream as one
        ``normal_`` call, then, with ``shape`` (k,), (L, k) standard Gamma
        draws at those shapes as one ``_standard_gamma`` call (None
        without)."""
        if not self.batched:
            return lane_noise.lane_noise_plain(self.generators, size, dtype,
                                               self.device, shape)
        out = lane_noise.lane_noise_cuda(self._seeds,
                                         self._base + self._drawn,
                                         self._starts, size, dtype, shape)
        self._drawn += lane_noise.draw_increment(size, dtype,
                                                 shape is not None,
                                                 self.device)
        return out

    def close(self) -> None:
        """Move every generator past what the draws took."""
        if self.batched and self._drawn:
            self._offsets = [o + self._drawn for o in self._offsets]
            for gen, offset in zip(self.generators, self._offsets):
                gen.set_offset(offset)
            self._base += self._drawn
            self._drawn = 0

    def __enter__(self) -> "LaneStreams":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def lane_normals(generators: Sequence[torch.Generator], size: int, dtype,
                 device) -> torch.Tensor:
    """(L, size) standard normals, row l from generator l in one draw each
    (``LaneStreams``: one launch for all lanes on the card)."""
    with LaneStreams(generators, device) as streams:
        return streams.draw(size, dtype)[0]
