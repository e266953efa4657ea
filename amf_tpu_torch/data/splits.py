"""Experiment split builders (numpy only).

A copy of ``amf_tpu/data/splits.py``: importing the JAX package would
import JAX. Host-side equivalents of the reference's
``choose_training.py``: initially known sets covering every row+column
(:20-50), DrugBank positive-per-drug picking (:53-83), test-set selection
(random / one-per-row-col / equal-class / class-ratio, :110-156), and
new-item cold-start splits (:236-252). All functions take an explicit
seeded ``numpy.random.Generator``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _rng(seed_or_rng) -> np.random.Generator:
    if isinstance(seed_or_rng, np.random.Generator):
        return seed_or_rng
    return np.random.default_rng(seed_or_rng)


def pick_ratings(
    knowable: np.ndarray, num_to_pick: Optional[int], rng=None
) -> np.ndarray:
    """Pick an initially-known set covering every row and column, padded to
    ``num_to_pick`` entries (reference: choose_training.pick_ratings :20-50).

    ``num_to_pick=None`` picks only the row/column cover ("--pick-no-extras").
    """
    rng = _rng(rng)
    knowable = knowable.copy().astype(bool)
    known = np.zeros(knowable.shape, dtype=bool)

    for j in np.nonzero(~known.any(axis=0))[0]:
        choices = np.nonzero(knowable[:, j])[0]
        if choices.size == 0:
            continue
        i = rng.choice(choices)
        known[i, j] = True
        knowable[i, j] = False

    for i in np.nonzero(~known.any(axis=1))[0]:
        choices = np.nonzero(knowable[i, :])[0]
        if choices.size == 0:
            continue
        j = rng.choice(choices)
        known[i, j] = True
        knowable[i, j] = False

    if num_to_pick is None:
        return known

    extra = num_to_pick - int(known.sum())
    if extra < 0:
        raise ValueError("row/col cover already exceeds num_to_pick")
    flat_choices = np.nonzero(knowable.ravel())[0]
    picked = rng.choice(flat_choices, size=extra, replace=False)
    known.ravel()[picked] = True
    return known


def pick_ratings_drugbank(real: np.ndarray, num_to_pick: int, rng=None) -> np.ndarray:
    """DrugBank-style seed set: one positive per drug (row), one negative per
    empty target (column), rest random negatives
    (reference: choose_training.pick_ratings_drugbank :53-83)."""
    rng = _rng(rng)
    knowable = np.isfinite(real)
    pos = knowable & (real > 0)
    neg = knowable & (real <= 0)

    known = np.zeros(knowable.shape, dtype=bool)
    for i in range(real.shape[0]):
        choices = np.nonzero(pos[i, :])[0]
        if choices.size == 0:
            continue
        j = rng.choice(choices)
        known[i, j] = True
        knowable[i, j] = False

    for j in np.nonzero(~known.any(axis=0))[0]:
        choices = np.nonzero(neg[:, j] & knowable[:, j])[0]
        if choices.size == 0:
            continue
        i = rng.choice(choices)
        known[i, j] = True
        knowable[i, j] = False

    extra = num_to_pick - int(known.sum())
    if extra < 0:
        raise ValueError("cover already exceeds num_to_pick")
    flat = np.nonzero((neg & knowable).ravel())[0]
    picked = rng.choice(flat, size=extra, replace=False)
    known.ravel()[picked] = True
    return known


def choose_test_set(
    real: np.ndarray,
    known: np.ndarray,
    num_test: int,
    mode: str = "random",
    class_ratios: Optional[Dict[float, float]] = None,
    rng=None,
) -> np.ndarray:
    """Pick a test mask disjoint from the known set.

    mode: 'random' | 'one-per-row-col' | 'equal-classes' | 'class-ratios'
    (reference: choose_training.figure_out_test :110-156).
    """
    rng = _rng(rng)
    knowable = np.isfinite(real) & (real != 0)
    testable = knowable & ~known
    if num_test >= testable.sum():
        raise ValueError("test set larger than testable pool")

    if mode in ("equal-classes", "class-ratios"):
        labels = sorted(set(real[knowable].ravel()))
        n_labels = len(labels)
        if mode == "equal-classes":
            ratios = np.full(n_labels, 1.0 / n_labels)
        else:
            ratios = np.array([class_ratios[k] for k in labels], dtype=np.float64)
            total = ratios.sum()
            assert 0.97 <= total <= 1.03, f"total ratio was {total}"
            ratios = ratios / total
        n_per = np.round(ratios * num_test).astype(int)
        diff = num_test - n_per.sum()
        bump = rng.choice(n_labels, size=abs(diff), replace=False)
        n_per[bump] += np.sign(diff)
        test_on = np.zeros(testable.shape, dtype=bool)
        for label, num in zip(labels, n_per):
            flat = np.nonzero(((real == label) & testable).ravel())[0]
            picked = rng.choice(flat, size=num, replace=False)
            test_on.ravel()[picked] = True
        return test_on

    if mode == "one-per-row-col":
        return pick_ratings(testable, num_test, rng)

    flat = np.nonzero(testable.ravel())[0]
    picked = rng.choice(flat, size=num_test, replace=False)
    test_on = np.zeros(testable.shape, dtype=bool)
    test_on.ravel()[picked] = True
    return test_on


def make_split(
    real: np.ndarray,
    pick_known_frac: float = 0.05,
    n_pick: Optional[int] = None,
    pick_no_extras: bool = False,
    drugbank: bool = False,
    n_test: Optional[int] = None,
    test_known_frac: Optional[float] = None,
    test_mode: str = "random",
    class_ratios: Optional[Dict[float, float]] = None,
    rng=None,
) -> Dict[str, np.ndarray]:
    """Full split pipeline -> the reference npz schema dict
    (``_real``, ``_ratings``-equivalent masks, ``_rating_vals``, ``_test_on``).

    Mirrors choose_training.main (:159-259) but returns masks; use
    ``loaders.save_npz_schema`` for byte-compatible npz export.
    """
    rng = _rng(rng)
    real = np.asarray(real, dtype=np.float64)
    knowable = np.isfinite(real) & (real != 0)

    if pick_no_extras:
        num_to_pick = None
    elif n_pick is not None:
        num_to_pick = n_pick
    else:
        num_to_pick = int(np.round(knowable.sum() * pick_known_frac))

    if drugbank:
        known = pick_ratings_drugbank(real, num_to_pick, rng)
    else:
        known = pick_ratings(knowable, num_to_pick, rng)

    out: Dict[str, np.ndarray] = {"_real": real, "_known": known}

    if np.all(real[knowable] == np.round(real[knowable])):
        vals = sorted(set(real[knowable].ravel()))
        out["_rating_vals"] = np.asarray(vals, dtype=np.float64)

    num_test = n_test
    if num_test is None and test_known_frac is not None:
        num_test = int(np.round(knowable.sum() * test_known_frac))
    if num_test:
        out["_test_on"] = choose_test_set(
            real, known, num_test, test_mode, class_ratios, rng
        )
    return out


def make_new_items_split(
    real: np.ndarray,
    n_new: int,
    know_all_old: bool = False,
    pick_no_extras: bool = True,
    pick_known_frac: float = 0.05,
    n_test: Optional[int] = None,
    test_known_frac: Optional[float] = None,
    rng=None,
) -> Dict[str, np.ndarray]:
    """Cold-start split: mark ``n_new`` random columns as new items; known and
    test sets for new columns only (reference: choose_training.py:236-252)."""
    rng = _rng(rng)
    real = np.asarray(real, dtype=np.float64)
    knowable = np.isfinite(real) & (real != 0)
    m = real.shape[1]

    is_new = np.zeros(m, dtype=bool)
    is_new[rng.choice(m, size=n_new, replace=False)] = True

    def _pick(sub_real):
        sub_knowable = np.isfinite(sub_real) & (sub_real != 0)
        if pick_no_extras:
            return pick_ratings(sub_knowable, None, rng)
        return pick_ratings(
            sub_knowable, int(np.round(sub_knowable.sum() * pick_known_frac)), rng
        )

    known = np.zeros(real.shape, dtype=bool)
    known[:, ~is_new] = knowable[:, ~is_new] if know_all_old else _pick(real[:, ~is_new])
    known_new = _pick(real[:, is_new])
    known[:, is_new] = known_new

    out = make_split_header(real, knowable)
    out["_known"] = known
    out["_is_new_item"] = is_new

    num_test = n_test
    if num_test is None and test_known_frac is not None:
        num_test = int(np.round(knowable[:, is_new].sum() * test_known_frac))
    if num_test:
        test_new = choose_test_set(real[:, is_new], known_new, num_test, "random", rng=rng)
        test_on = np.zeros(real.shape, dtype=bool)
        test_on[:, is_new] = test_new
        out["_test_on"] = test_on
    return out


def make_split_header(real, knowable) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {"_real": real}
    if np.all(real[knowable] == np.round(real[knowable])):
        vals = sorted(set(real[knowable].ravel()))
        out["_rating_vals"] = np.asarray(vals, dtype=np.float64)
    return out
