"""A configuration's inputs, made in NumPy from its file alone.

The matrix is the configuration's stand-in for its dataset, made from the
file's own ``data.seed``: one fixed matrix, as the dataset is one. The
split into known, test and queryable cells is fixed too, by
``split.seed``, and the family's start (the MAP fit's draw and the base
chain) by ``family_seed``, so that every ``--seed`` does the same work:
the run's seed draws the lookahead lanes' and the active steps' noise,
not the problem. Two kinds of matrix:

  * ``ratings``: a rank-``rank`` Gaussian product scaled to the stated
    mean and spread, rounded and clipped to the values; ``rated_cells``
    cells rated, every row at least ``min_per_row``, rows and columns
    weighted by log-normal activity and popularity (weighted sampling
    without replacement by Gumbel keys); unrated cells are 0, unknowable;
  * ``labels``: the sign of a rank-``rank`` product against the quantile
    that leaves ``positive_share`` positive, every cell knowable.

Two kinds of split, named by ``split.kind``:

  * ``uniform``: ``known`` and then ``test`` cells uniformly from the
    rated ones;
  * ``drugbank``: one positive a row, one negative a column with none,
    random negatives up to ``known``; ``test`` cells in equal classes
    from the rest (the reference's ``choose_training --drugbank
    --n-pick N --test-equal-classes --n-test T``).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Inputs:
    real: np.ndarray  # (n, m) float64; 0 where unknowable
    known: np.ndarray  # (n, m) bool
    test: np.ndarray
    queryable: np.ndarray

    @property
    def pool(self) -> np.ndarray:
        """The flat queryable cells, in order."""
        return np.flatnonzero(self.queryable.ravel())


def _factors(rng, n, m, rank):
    return rng.standard_normal((n, rank)) @ rng.standard_normal((m, rank)).T


def _top_k(keys: np.ndarray, k: int) -> np.ndarray:
    """Flat indices of the k largest keys."""
    flat = keys.ravel()
    return np.argpartition(-flat, k - 1)[:k]


def ratings_matrix(spec: dict, n: int, m: int, values) -> np.ndarray:
    rng = np.random.default_rng(spec["seed"])
    X = _factors(rng, n, m, spec["rank"])
    X = (X - X.mean()) / X.std() * spec["std"] + spec["mean"]
    full = np.clip(np.round(X), min(values), max(values))
    act = np.log(rng.lognormal(0.0, spec["row_activity_sigma"], n))
    pop = np.log(rng.lognormal(0.0, spec["col_popularity_sigma"], m))
    # every row's first min_per_row cells by popularity, then the rest
    # by activity x popularity
    per_row = pop[None, :] + rng.gumbel(size=(n, m))
    first = np.argpartition(-per_row, spec["min_per_row"] - 1, axis=1)[
        :, :spec["min_per_row"]]
    keys = act[:, None] + pop[None, :] + rng.gumbel(size=(n, m))
    keys[np.arange(n)[:, None], first] = np.inf
    rated = np.zeros(n * m, dtype=bool)
    rated[_top_k(keys, spec["rated_cells"])] = True
    return np.where(rated.reshape(n, m), full, 0.0)


def labels_matrix(spec: dict, n: int, m: int) -> np.ndarray:
    rng = np.random.default_rng(spec["seed"])
    X = _factors(rng, n, m, spec["rank"])
    cut = np.quantile(X, 1.0 - spec["positive_share"])
    return np.where(X > cut, 1.0, -1.0)


def uniform_split(real, spec, rng):
    flat = rng.permutation(np.flatnonzero(real.ravel() != 0))
    k, t = spec["known"], spec["test"]
    known = np.zeros(real.size, dtype=bool)
    test = np.zeros(real.size, dtype=bool)
    known[flat[:k]] = True
    test[flat[k:k + t]] = True
    return known.reshape(real.shape), test.reshape(real.shape)


def drugbank_split(real, spec, rng):
    n, m = real.shape
    pos, neg = real > 0, real < 0
    known = np.zeros((n, m), dtype=bool)
    for i in range(n):
        js = np.flatnonzero(pos[i])
        if js.size:
            known[i, rng.choice(js)] = True
    for j in np.flatnonzero(~known.any(axis=0)):
        ii = np.flatnonzero(neg[:, j] & ~known[:, j])
        if ii.size:
            known[rng.choice(ii), j] = True
    extra = spec["known"] - int(known.sum())
    if extra < 0:
        raise ValueError("the forced cover exceeds the known cells")
    free = np.flatnonzero((neg & ~known).ravel())
    known.ravel()[rng.choice(free, size=extra, replace=False)] = True
    test = np.zeros((n, m), dtype=bool)
    for label, count in ((1.0, spec["test"] // 2),
                         (-1.0, spec["test"] - spec["test"] // 2)):
        free = np.flatnonzero(((real == label) & ~known).ravel())
        test.ravel()[rng.choice(free, size=count, replace=False)] = True
    return known, test


SPLITS = {"uniform": uniform_split, "drugbank": drugbank_split}


def make_inputs(config: dict) -> Inputs:
    """The configuration's matrix and its split."""
    n, m = config["rows"], config["cols"]
    spec = config["data"]
    real = (ratings_matrix(spec, n, m, config["values"])
            if spec["kind"] == "ratings" else labels_matrix(spec, n, m))
    split = config["split"]
    rng = np.random.default_rng(split["seed"])
    known, test = SPLITS[split["kind"]](real, split, rng)
    queryable = (real != 0) & ~known & ~test
    return Inputs(real=real, known=known, test=test, queryable=queryable)
