"""Synthetic dataset generator (numpy only).

A copy of ``amf_tpu/data/synthetic.py``: importing the JAX package would
import JAX. Reference equivalents: ``active_pmf.make_fake_data``/
``get_ratings`` (python-pmf/active_pmf.py:926-1010) and the exact-class-count
low-rank generator ``generate.py`` (generate.py:17-146). Every function
takes a seeded rng.
"""

from __future__ import annotations

import numbers
from typing import Optional, Sequence, Tuple

import numpy as np

DEF_VALS = (1.0, 2.0, 3.0, 4.0, 5.0)


def _rng(seed_or_rng) -> np.random.Generator:
    if isinstance(seed_or_rng, np.random.Generator):
        return seed_or_rng
    return np.random.default_rng(seed_or_rng)


# ---------------------------------------------------------------------------
# active_pmf.make_fake_data equivalent


def get_ratings_mask(real: np.ndarray, mask_type=0.0, rng=None) -> np.ndarray:
    """Initially-known mask (reference: active_pmf.get_ratings :963-1010).

    mask_type: a float => Bernoulli(p) mask; or one of
    {'diag', 'diag-plus', 'diag-block'}. Every row and column is guaranteed at
    least one known entry.
    """
    rng = _rng(rng)
    num_users, num_items = real.shape

    if isinstance(mask_type, numbers.Real):
        mask = rng.binomial(1, float(mask_type), real.shape).astype(bool)
    elif mask_type in {"diag", "diagonal", "diag-plus", "diag-block"}:
        mask = np.zeros(real.shape, dtype=bool)
        np.fill_diagonal(mask, True)
        if mask_type == "diag-plus" and num_users == num_items:
            n = num_users
            mask[-1, 1] = True
            mask[range(1, n - 1), range(2, n)] = True
        elif mask_type == "diag-block" and num_users == num_items:
            mask[: num_users // 2, : num_items // 2] = True
    else:
        raise ValueError(f"unknown mask_type {mask_type!r}")

    for j in np.nonzero(~mask.any(axis=0))[0]:
        mask[rng.integers(num_users), j] = True
    for i in np.nonzero(~mask.any(axis=1))[0]:
        mask[i, rng.integers(num_items)] = True
    return mask


def make_fake_data(
    noise: float = 0.25,
    num_users: int = 10,
    num_items: int = 10,
    mask_type=0.0,
    data_type="float",
    rank: int = 5,
    u_mean: float = 0.0,
    u_std: float = 2.0,
    v_mean: float = 0.0,
    v_std: float = 2.0,
    rng=None,
) -> Tuple[np.ndarray, np.ndarray, Optional[Tuple[float, ...]]]:
    """Random low-rank matrix + known mask + rating-value set.

    Returns (real, known_mask, rating_values) — the reference returns a
    ratings list instead of a mask (active_pmf.py:926-960); use
    ``types.problem_from_dense`` to build a Problem.
    """
    rng = _rng(rng)
    u = rng.normal(u_mean, u_std, (num_users, rank))
    v = rng.normal(v_mean, v_std, (num_items, rank))
    real = u @ v.T
    if noise:
        real = real + rng.normal(0, noise, real.shape)

    vals: Optional[Tuple[float, ...]]
    if data_type == "float":
        vals = None
    elif data_type == "int":
        real = np.round(real)
        vals = None
    elif data_type == "int-bounds":
        real = np.round(real)
        minval, maxval = real.min(), real.max()
        lo = int(np.floor(minval * 1.2 if minval < 0 else minval * 0.8))
        hi = int(np.ceil(maxval * 1.2 if maxval > 0 else maxval * 0.8))
        vals = tuple(float(x) for x in range(lo, hi))
    elif data_type == "binary":
        real = (real > 0.5).astype(np.float64)
        vals = (0.0, 1.0)
    elif isinstance(data_type, numbers.Integral):
        real = np.clip(np.round(real), 0, int(data_type))
        vals = tuple(float(x) for x in range(int(data_type) + 1))
    else:
        raise ValueError(f"unknown data_type {data_type!r}")

    known = get_ratings_mask(real, mask_type, rng)
    return real.astype(np.float64), known, vals


# ---------------------------------------------------------------------------
# generate.py equivalent: discrete low-rank matrices with exact class counts


def _make_orig(m, n, values, probs, rng):
    values = np.asarray(values, dtype=np.float64)
    if probs is None:
        p = np.full(len(values), 1.0 / len(values))
    else:
        p = np.asarray(probs, dtype=np.float64)
        p = p / p.sum()
    idx = rng.choice(len(values), size=(m, n), p=p)
    return values[idx]


def _low_rank_reconstruct(orig, k, values):
    u, s, vh = np.linalg.svd(orig, full_matrices=False)
    approx = (u[:, :k] * s[:k]) @ vh[:k, :]
    values = np.asarray(values, dtype=np.float64)
    idx = np.argmin(np.abs(approx[..., None] - values[None, None, :]), axis=-1)
    return values[idx]


def known_diag(m: int, n: int) -> np.ndarray:
    """Wrap-around diagonal mask (reference: generate.known_diag :91-96)."""
    known = np.zeros((m, n), dtype=bool)
    indices = np.arange(max(m, n))
    known[indices % m, indices % n] = True
    return known


def gen_known_diag_counts(
    m: int,
    n: int,
    rank: int,
    known_pos: int,
    unknown_pos: int,
    vals: Sequence[float] = DEF_VALS,
    probs=None,
    cutoff: float = 4.0,
    rng=None,
    max_tries: int = 200_000,
) -> np.ndarray:
    """Rejection-sample a snapped low-rank matrix with exact positive counts
    in the diag-known / unknown partitions (reference: generate.py:69-103).
    """
    rng = _rng(rng)
    known = known_diag(m, n)
    unknown = ~known
    for _ in range(max_tries):
        ary = _low_rank_reconstruct(_make_orig(m, n, vals, probs, rng), rank, vals)
        if (ary[known] >= cutoff).sum() == known_pos and (
            ary[unknown] >= cutoff
        ).sum() == unknown_pos:
            return ary
    raise RuntimeError("gen_known_diag_counts: exceeded max_tries")
