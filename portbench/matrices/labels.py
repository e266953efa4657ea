"""labels: the sign of a rank-``rank`` product against the quantile that
leaves ``positive_share`` positive, every cell knowable."""

import numpy as np

from portbench.data import factors


def make(config: dict) -> np.ndarray:
    spec, n, m = config["data"], config["rows"], config["cols"]
    rng = np.random.default_rng(spec["seed"])
    X = factors(rng, n, m, spec["rank"])
    cut = np.quantile(X, 1.0 - spec["positive_share"])
    return np.where(X > cut, 1.0, -1.0)
