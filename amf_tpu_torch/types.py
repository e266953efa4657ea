"""Problem state: a dense masked ratings matrix, as tensors.

Mirrors ``amf_tpu/types.py``. A problem is a dense value matrix plus
boolean masks; adding a rating is an update that returns a new Problem.

The lookahead fans one refit and one chain out per hypothesised rating.
Those lanes do not copy the problem: they share the base ``Problem`` and
carry only their own cell, value and mean rating (``LaneCells``). Where a
lane's model needs its whole problem (the variational approximations'
KL and statistics), ``LaneCells.problems`` gives each lane its own
(n, m) masks, a Problem with a leading lane dimension.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from amf_tpu_torch.utils.platform import resolve_device


@dataclasses.dataclass(frozen=True)
class Problem:
    """Dense masked view of an active matrix-completion problem.

    Every field may carry leading lane dimensions, (..., n, m); ``shape``
    is (n, m) and the counts are per lane.

    Attributes:
      R_obs:     (n, m) float. Observed value of every rated cell; arbitrary
                 elsewhere (multiply by ``rated`` before use).
      rated:     (n, m) bool. Cells whose value the learner knows.
      queryable: (n, m) bool. Cells the learner may still query; disjoint
                 from ``rated``.
      test:      (n, m) bool. Held-out cells for RMSE / misclassification.
    """

    R_obs: torch.Tensor
    rated: torch.Tensor
    queryable: torch.Tensor
    test: torch.Tensor

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.R_obs.shape[-2:])

    @property
    def n_rated(self) -> torch.Tensor:
        return self.rated.sum(dim=(-2, -1))

    def mean_rating(self) -> torch.Tensor:
        """Mean of the observed ratings (reference: pmf.py:45,90)."""
        cnt = self.rated.sum(dim=(-2, -1)).clamp(min=1)
        return torch.where(self.rated, self.R_obs, 0.0).sum(dim=(-2, -1)) / cnt

    def add_rating(self, i, j, value) -> "Problem":
        """A new Problem with ``value`` recorded for cell (i, j)."""
        R_obs, rated, queryable = (
            self.R_obs.clone(), self.rated.clone(), self.queryable.clone())
        R_obs[i, j] = value
        rated[i, j] = True
        queryable[i, j] = False
        return dataclasses.replace(
            self, R_obs=R_obs, rated=rated, queryable=queryable)

    def to(self, device=None, dtype=None) -> "Problem":
        """Move to ``device``; cast the float matrix to ``dtype``."""
        return Problem(
            R_obs=self.R_obs.to(device=device, dtype=dtype),
            rated=self.rated.to(device=device),
            queryable=self.queryable.to(device=device),
            test=self.test.to(device=device),
        )


@dataclasses.dataclass(frozen=True)
class LaneCells:
    """Hypothesised ratings over a shared base Problem, one per lane.

    Lane l is the base problem plus rating ``v[l]`` at cell
    ``(i[l], j[l])`` (``Problem.add_rating`` without the copy).
    """

    i: torch.Tensor  # (L,) int64 rows
    j: torch.Tensor  # (L,) int64 columns
    v: torch.Tensor  # (L,) float values

    def __len__(self) -> int:
        return self.i.shape[0]

    def deltas(self, problem: Problem) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-lane change at the lane's cell of the mask (``dm``, 0 or 1)
        and of the masked ratings ``rated * R_obs`` (``dr``)."""
        was = problem.rated[self.i, self.j].to(self.v.dtype)
        dm = 1.0 - was
        dr = self.v - was * problem.R_obs[self.i, self.j]
        return dm, dr

    def mean_rating(self, problem: Problem) -> torch.Tensor:
        """(L,) mean observed rating of each lane's problem."""
        dm, dr = self.deltas(problem)
        total = torch.where(problem.rated, problem.R_obs, 0.0).sum()
        cnt = problem.rated.sum().to(self.v.dtype)
        return (total + dr) / (cnt + dm).clamp(min=1)

    def problems(self, problem: Problem) -> Problem:
        """Every lane's own problem, (L, n, m) each field: the base with
        the lane's cell rated at its value and no longer queryable
        (``Problem.add_rating`` of every lane at once); ``test`` is shared."""
        L = len(self)
        lane = torch.arange(L, device=self.i.device)
        shape = (L,) + problem.shape

        def copy(x):
            return x.expand(shape).clone()

        R_obs, rated, queryable = (copy(problem.R_obs), copy(problem.rated),
                                   copy(problem.queryable))
        R_obs[lane, self.i, self.j] = self.v.to(R_obs.dtype)
        rated[lane, self.i, self.j] = True
        queryable[lane, self.i, self.j] = False
        return Problem(R_obs=R_obs, rated=rated, queryable=queryable,
                       test=problem.test.expand(shape))


def problem_from_dense(
    real: np.ndarray,
    known: np.ndarray,
    queryable: Optional[np.ndarray] = None,
    test: Optional[np.ndarray] = None,
    dtype=torch.float32,
    zeros_unknowable: bool = True,
    device=None,
) -> Problem:
    """Build a Problem from a dense matrix + initially-known mask.

    Cells with value NaN (and 0, unless ``zeros_unknowable`` is False) are
    unknowable; queryable defaults to knowable-and-not-known, test to all
    knowable cells. An explicit held-out ``test`` mask is excluded from the
    query pool (reference: python-pmf/bayes_pmf.py:739-772). ``device``
    None means the card (``utils.platform.resolve_device``).
    """
    real = np.asarray(real, dtype=np.float64)
    known = np.asarray(known, dtype=bool)
    knowable = np.isfinite(real)
    if zeros_unknowable:
        knowable &= real != 0
    if queryable is None:
        queryable = knowable & ~known
        if test is not None:
            queryable = queryable & ~np.asarray(test, dtype=bool)
    if test is None:
        test = knowable
    r_obs = np.where(known, np.nan_to_num(real), 0.0)
    return _problem(r_obs, known, queryable, test, dtype, device)


def _problem(r_obs, rated, queryable, test, dtype, device) -> Problem:
    device = resolve_device(device)

    def mask(x):
        return torch.as_tensor(np.asarray(x, dtype=bool), device=device)

    return Problem(
        R_obs=torch.as_tensor(np.asarray(r_obs, dtype=np.float64),
                              device=device).to(dtype),
        rated=mask(rated),
        queryable=mask(queryable),
        test=mask(test),
    )


def ratings_array(problem: Problem) -> np.ndarray:
    """The rated cells as the reference's (n_rated, 3) [i, j, value] array."""
    rated = problem.rated.cpu().numpy()
    r = problem.R_obs.cpu().numpy()
    ii, jj = np.nonzero(rated)
    return np.stack([ii, jj, r[ii, jj]], axis=1).astype(np.float64)


def problem_from_ratings(
    ratings: np.ndarray,
    shape: Optional[Tuple[int, int]] = None,
    real: Optional[np.ndarray] = None,
    test: Optional[np.ndarray] = None,
    dtype=torch.float32,
    device=None,
) -> Problem:
    """Build a Problem from the reference's (k, 3) ratings array.

    If ``real`` is given, unknowable cells (0 / NaN in ``real``) are excluded
    from the queryable set (reference: active_pmf.py:1217-1219). ``device``
    None means the card.
    """
    ratings = np.asarray(ratings, dtype=np.float64)
    if shape is None:
        if real is not None:
            shape = real.shape
        else:
            shape = (int(ratings[:, 0].max()) + 1, int(ratings[:, 1].max()) + 1)
    known = np.zeros(shape, dtype=bool)
    r_obs = np.zeros(shape, dtype=np.float64)
    ii = ratings[:, 0].astype(int)
    jj = ratings[:, 1].astype(int)
    known[ii, jj] = True
    r_obs[ii, jj] = ratings[:, 2]
    if real is not None:
        knowable = np.isfinite(np.asarray(real, dtype=np.float64))
        knowable &= np.asarray(real) != 0
    else:
        knowable = np.ones(shape, dtype=bool)
    queryable = knowable & ~known
    if test is None:
        test_mask = knowable
    else:
        test_mask = np.asarray(test, dtype=bool)
        queryable = queryable & ~test_mask
    return _problem(r_obs, known, queryable, test_mask, dtype, device)


def rating_bounds(rating_values: Tuple[float, ...]) -> np.ndarray:
    """Midpoints between sorted rating values, with +-inf ends
    (reference: active_pmf.py:171-185, bayes_pmf.py:137-150)."""
    vals = np.sort(np.asarray(rating_values, dtype=np.float64))
    v = np.empty(len(vals) + 2)
    v[0] = -np.inf
    v[1:-1] = vals
    v[-1] = np.inf
    return (v[1:] + v[:-1]) / 2
