"""ratings: a rank-``rank`` Gaussian product scaled to the stated mean and
spread, rounded and clipped to the values; ``rated_cells`` cells rated,
every row at least ``min_per_row``, rows and columns weighted by
log-normal activity and popularity (weighted sampling without replacement
by Gumbel keys); unrated cells are 0, unknowable."""

import numpy as np

from portbench.data import factors


def _top_k(keys: np.ndarray, k: int) -> np.ndarray:
    """Flat indices of the k largest keys."""
    flat = keys.ravel()
    return np.argpartition(-flat, k - 1)[:k]


def make(config: dict) -> np.ndarray:
    spec, n, m, values = (config["data"], config["rows"], config["cols"],
                          config["values"])
    rng = np.random.default_rng(spec["seed"])
    X = factors(rng, n, m, spec["rank"])
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
