"""uniform: ``known`` and then ``test`` cells uniformly from the rated
ones."""

import numpy as np


def split(real, spec, rng):
    flat = rng.permutation(np.flatnonzero(real.ravel() != 0))
    k, t = spec["known"], spec["test"]
    known = np.zeros(real.size, dtype=bool)
    test = np.zeros(real.size, dtype=bool)
    known[flat[:k]] = True
    test[flat[k:k + t]] = True
    return known.reshape(real.shape), test.reshape(real.shape)
