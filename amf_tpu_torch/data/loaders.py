"""IO for the reference npz/pkl data schema (numpy only).

A copy of ``amf_tpu/data/loaders.py``: importing the JAX package would
import JAX.

Schema (documented at reference stan-bpmf/bpmf.py:744-754, produced by
choose_training.py:215-259 and generate.py:139-146):
  _real         dense (n, m) matrix; 0 / NaN = unknowable
  _ratings      (k, 3) [i, j, value] initially-known ratings
  _rating_vals  optional sorted tuple of discrete values
  _test_on      optional (n, m) bool test mask
  _is_new_item  optional (m,) bool new-item (cold-start) flags
"""

from __future__ import annotations

import gzip
import os
import pickle
from typing import Dict, Optional

import numpy as np


def _ratings_from_known(real: np.ndarray, known: np.ndarray) -> np.ndarray:
    ii, jj = np.nonzero(known)
    return np.stack([ii, jj, real[ii, jj]], axis=1).astype(np.float64)


def save_npz_schema(path: str, dct: Dict[str, np.ndarray]) -> None:
    """Write a split dict in the reference schema. Accepts either ``_ratings``
    or the mask form ``_known`` produced by ``splits.make_split``."""
    out = dict(dct)
    if "_ratings" not in out and "_known" in out:
        out["_ratings"] = _ratings_from_known(out["_real"], out.pop("_known"))
    out.pop("_known", None)
    np.savez_compressed(path, **out)


def load_npz_schema(path: str) -> Dict[str, np.ndarray]:
    """Load a data file in the reference schema (npz, npy, or pickle).

    A bare array is interpreted as ``_real`` with no initial ratings, matching
    reference CLI behavior (active_pmf.py:1200-1213).
    """
    if path.endswith(".pkl") or path.endswith(".pickle"):
        with open(path, "rb") as f:
            data = pickle.load(f)
    else:
        with open(path, "rb") as f:
            data = np.load(f, allow_pickle=True)
            if isinstance(data, np.ndarray):
                data = {"_real": data}
            else:
                data = {k: data[k] for k in data.files}
    out: Dict[str, np.ndarray] = {"_real": np.asarray(data["_real"], dtype=np.float64)}
    if "_ratings" in data:
        out["_ratings"] = np.asarray(data["_ratings"], dtype=np.float64)
    if "_rating_vals" in data and data["_rating_vals"] is not None:
        vals = np.asarray(data["_rating_vals"], dtype=np.float64).ravel()
        if vals.size:
            out["_rating_vals"] = vals
    for key in ("_test_on", "_is_new_item"):
        if key in data and data[key] is not None:
            out[key] = np.asarray(data[key]).astype(bool)
    return out


def load_dense_matrix(path: str) -> np.ndarray:
    """Load a dense matrix from .npy or gzipped .npy (e.g. the reference's
    movielens-100k/ratings_matrix.npy.gz, read at choose_training.py:205-209)."""
    try:
        with gzip.GzipFile(path, "rb") as f:
            return np.load(f)
    except (OSError, gzip.BadGzipFile):
        return np.load(path)


def find_reference_dataset(name: str, root: Optional[str] = None) -> Optional[str]:
    """Locate a known dataset file under a reference checkout, if present.

    ``root`` is the checkout, or the ``AMF_REFERENCE_ROOT`` environment
    variable when it is None; with neither, or without the file, None. Reads
    data files (never code) from an existing checkout of the reference
    repository.
    """
    root = root or os.environ.get("AMF_REFERENCE_ROOT")
    candidates = {
        "movielens-100k": "movielens-100k/ratings_matrix.npy.gz",
        "movielens-75k": "movielens-100k/half_ratings.npy.gz",
        "movielens-58k": "movielens-100k/half_ratings_70.npy.gz",
    }
    rel = candidates.get(name)
    if root is None or rel is None:
        return None
    path = os.path.join(root, rel)
    return path if os.path.exists(path) else None
