"""drugbank: one positive a row, one negative a column with none, random
negatives up to ``known``; ``test`` cells in equal classes from the rest
(the reference's ``choose_training --drugbank --n-pick N
--test-equal-classes --n-test T``)."""

import numpy as np


def split(real, spec, rng):
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
