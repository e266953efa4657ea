"""A configuration's inputs, made in NumPy from its file alone.

The matrix is the configuration's stand-in for its dataset, made from the
file's own ``data.seed``: one fixed matrix, as the dataset is one. The
split into known, test and queryable cells is fixed too, by
``split.seed``, so that every ``--seed`` does the same work on the same
problem; the run's seed draws only the noise of the work.

Both are found by name: ``data.kind`` names the matrix kind
``portbench/matrices/<kind>.py``, whose ``make(config)`` returns the
(rows, cols) float64 matrix, 0 where a cell is unknowable; ``split.kind``
names the split kind ``portbench/splits/<kind>.py``, whose
``split(real, spec, rng)`` returns the known and test masks, drawn with
``rng`` (seeded by ``split.seed``). Every other knowable cell is
queryable.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench.run import named


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


def factors(rng, n, m, rank):
    """A rank-``rank`` Gaussian product, (n, m): the matrix kinds' start."""
    return rng.standard_normal((n, rank)) @ rng.standard_normal((m, rank)).T


def make_inputs(config: dict) -> Inputs:
    """The configuration's matrix and its split."""
    real = named("matrices", config["data"]["kind"], "make")(config)
    split = config["split"]
    rng = np.random.default_rng(split["seed"])
    known, test = named("splits", split["kind"], "split")(real, split, rng)
    queryable = (real != 0) & ~known & ~test
    return Inputs(real=real, known=known, test=test, queryable=queryable)
