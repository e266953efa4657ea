"""Checkpoint/resume for active-learning sweeps
(mirrors ``amf_tpu/utils/checkpoint.py``; numpy and pickle only).

Reference analogues (SURVEY.md §5.4): MMMF saves partial_results.mat every 20
steps mid-run (mmmf/evaluate_active.m:84-86); Makefile targets skip existing
results. One partial pickle per run holds, per criterion, a slim record
trace: enough to replay the problem state exactly (the picks are replayed in
order). A fingerprint of the problem (data, initial rated and test masks)
guards against resuming with the wrong dataset or split, and an engine-era
stamp against resuming a trace another sampler wrote. Per-step eval
matrices are NOT persisted (replay needs only the picks).

A problem's masks may live on the card: they are read through ``.cpu()``,
so a card problem and the same problem on the CPU have one fingerprint.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np


def _host(x) -> np.ndarray:
    """``x`` (a tensor on any device, or an array) as a numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def problem_fingerprint(real, rated_mask, test_mask) -> str:
    """Stable identity of (dataset, initial known cells, test split)."""
    h = hashlib.sha256()
    for arr, dt in ((real, np.float64), (rated_mask, np.uint8),
                    (test_mask, np.uint8)):
        a = np.ascontiguousarray(_host(arr).astype(dt))
        h.update(a.tobytes())
        h.update(str(a.shape).encode())
    return h.hexdigest()[:16]


def _slim(records: List[tuple]) -> List[tuple]:
    """Drop per-step eval matrices; keep (n_rated, err, ij, None, ...)."""
    out = []
    for rec in records:
        rec = list(rec)
        if len(rec) > 3:
            rec[3] = None
        out.append(tuple(rec))
    return out


class LoopCheckpointer:
    """Periodically persists per-criterion pick traces; supports exact resume
    by replaying recorded picks into the problem state.

    Resumed criteria lose the eval matrices of already-replayed steps (the
    trace is slim on purpose); fresh steps record them as usual.
    """

    def __init__(self, path: Optional[str], every: int = 20,
                 fingerprint: Optional[str] = None,
                 era: Optional[str] = None, write: bool = True):
        self.path = path
        self.write = write
        self.every = max(every, 1)
        self.fingerprint = fingerprint
        self.era = era
        self._state: Dict[str, object] = {}
        if path and os.path.exists(path):
            with open(path, "rb") as f:
                self._state = pickle.load(f)
            stored = self._state.get("_fingerprint")
            if fingerprint is not None and stored is not None \
                    and stored != fingerprint:
                raise ValueError(
                    f"checkpoint {path} was written for a different problem "
                    f"(fingerprint {stored} != {fingerprint}); refusing to "
                    "resume — delete the file or pass the matching data"
                )
            # engine-era guard: a trace written by another sampler era is
            # never resumed (the resumed steps would mix two engines in one
            # trace); the stale file is moved aside and the run re-records
            stored_era = self._state.get("_era", "pre-era")
            if era is not None and self._state and stored_era != era:
                self._state = {}
                if write:
                    stale = path + ".stale-era"
                    os.replace(path, stale)
                    sys.stderr.write(
                        f"checkpoint {path} was written by engine era "
                        f"{stored_era!r} but the current engine is {era!r}; "
                        f"moved it to {stale} and re-recording from scratch\n"
                    )

    @classmethod
    def for_problem(cls, path: Optional[str], problem, real,
                    every: int = 20, era: Optional[str] = None,
                    write: bool = True) -> "LoopCheckpointer":
        """A checkpointer keyed to a Problem; the fingerprint is computed
        only when a path is given (it hashes the full matrix). ``write``
        False resumes from the file and never writes it (the ranks of a
        sharded run other than rank 0)."""
        fp = None
        if path:
            fp = problem_fingerprint(real, problem.rated, problem.test)
        return cls(path, every=every, fingerprint=fp, era=era, write=write)

    def completed_records(self, key: str) -> Optional[List[tuple]]:
        """Records saved for a criterion in a previous run (or None)."""
        recs = self._state.get(key)
        return recs if isinstance(recs, list) else None

    def replay(self, key: str, problem, real,
               max_records: Optional[int] = None):
        """Re-apply recorded picks to a fresh problem; returns
        (problem, records) positioned exactly where the previous run stopped.

        max_records truncates the replay so a resume requesting FEWER steps
        than the checkpoint holds yields exactly the requested budget.
        """
        records = list(self.completed_records(key) or [])
        if max_records is not None:
            records = records[:max_records]
        for rec in records:
            ij = rec[2]
            if ij is not None:
                i, j = int(ij[0]), int(ij[1])
                if not (0 <= i < problem.shape[0] and 0 <= j < problem.shape[1]):
                    raise ValueError(
                        f"checkpoint pick {ij} out of bounds for problem "
                        f"{problem.shape} — wrong checkpoint file?"
                    )
                problem = problem.add_rating(i, j, float(real[i, j]))
        return problem, records

    def resume(self, key: str, problem, real, max_steps: int
               ) -> Tuple[object, List[tuple], bool]:
        """Replay (truncated to the requested budget) and report whether the
        criterion still has work. Returns (problem, records, will_run)."""
        problem, records = self.replay(key, problem, real,
                                       max_records=max_steps)
        will_run = bool(_host(problem.queryable).any()) and (
            len(records) == 0 or len(records) < max_steps
        )
        return problem, records, will_run

    def update(self, key: str, records: List[tuple], force: bool = False):
        if not self.path or not self.write:
            return
        self._state[key] = _slim(records)
        if self.fingerprint is not None:
            self._state["_fingerprint"] = self.fingerprint
        if self.era is not None:
            self._state["_era"] = self.era
        n_steps = len(records) - 1
        if force or (n_steps % self.every == 0):
            tmp = self.path + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump(self._state, f)
            os.replace(tmp, self.path)
