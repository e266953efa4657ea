"""Results-schema tooling (mirrors ``amf_tpu/analysis/results.py``).

The shared results-pickle schema (reference: plot_results.py:37-50, 160-166,
356-371): a dict with ``_real``, ``_ratings``, ``_rating_vals``, optional
``_test_on``/``_args``, and per-criterion lists of
``(num_rated, rmse, (i, j), evals_matrix[, pred_matrix])`` tuples, with model
kinds distinguished by key prefixes ('' = apmf, 'mnpmf_', 'rc_', 'mmmf_',
'bayes_', 'stan_').
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np

from amf_tpu_torch.active.criteria import KEY_FUNCS as _APMF_KEYS
from amf_tpu_torch.active.gibbs_loop import KEYS as _BAYES_KEYS
from amf_tpu_torch.active.stan_loop import KEYS as _STAN_KEYS
from amf_tpu_torch.analysis.metrics import area_under_curve, kendall_tau
from amf_tpu_torch.models.mmmf import MMMF_KEYS as _MMMF_KEYS
from amf_tpu_torch.models.ratingconc import RC_KEYS as _RC_KEYS

KINDS = ("apmf", "mnpmf", "rc", "mmmf", "bayes", "stan")

# key -> nice name, per kind (reference: plot_results.KEY_NAMES :37-50)
KEY_NAMES: Dict[str, str] = {}
KEY_NAMES.update({k: v.nice_name for k, v in _APMF_KEYS.items()})
KEY_NAMES.update({"mnpmf_" + k: "MN: " + v.nice_name for k, v in _APMF_KEYS.items()})
KEY_NAMES.update({"rc_" + k: "RC: " + v[0] for k, v in _RC_KEYS.items()})
KEY_NAMES.update({"mmmf_" + k: "MMMF: " + v for k, v in _MMMF_KEYS.items()})
KEY_NAMES.update({"bayes_" + k: "Bayes: " + v.nice_name for k, v in _BAYES_KEYS.items()})
KEY_NAMES.update({"stan_" + k: "Stan: " + v.nice_name for k, v in _STAN_KEYS.items()})


def guess_kind(results: Dict) -> str:
    """Infer the producing model family from the ``_kind`` stamp (written by
    this framework's CLIs) or the key prefixes
    (reference: plot_results.guess_kind :349-354)."""
    if "_kind" in results:
        return results["_kind"]
    for key in results:
        if key.startswith("_"):
            continue
        for kind in ("mnpmf", "rc", "mmmf", "bayes", "stan"):
            if key.startswith(kind + "_"):
                return kind
    return "apmf"


def load_results(path: str, kind: Optional[str] = None) -> Dict:
    """Load a results pickle (or a committed digest_*.json.gz) and normalize
    criterion keys to '<kind>_<key>' prefixes (reference:
    plot_results.load_results :356-371). Digest inputs are rebuilt via
    ``results_from_digest`` so plotting/compare tooling runs from committed
    artifacts alone — raw pickles do not survive a fresh checkout."""
    if path.endswith(".json.gz"):
        import gzip
        import json

        with gzip.open(path, "rt") as f:
            results = results_from_digest(json.load(f))
    else:
        with open(path, "rb") as f:
            results = pickle.load(f)
    kind = kind or guess_kind(results)
    out = {}
    for key, val in results.items():
        if key.startswith("_"):
            out[key] = val
        elif kind != "apmf" and not key.startswith(kind + "_"):
            out[f"{kind}_{key}"] = val
        else:
            out[key] = val
    return out


def results_from_digest(dg: Dict) -> Dict:
    """Reconstruct a results-shaped dict from a committed digest.

    Raw results pickles are gitignored (GBs of per-step eval grids) — the
    committed artifact is ``digest_<run>.json.gz``. This adapter rebuilds
    enough of the pickle schema from a digest that every acceptance band in
    ``analysis.parity`` (structural, learning, active-vs-random, discovery,
    cross-engine tau) can re-run from committed artifacts alone:

    - record tuples ``(n_rated, err, pick, evals)``, with the stored
      first-step criterion map reattached to the first post-initial record;
    - a NaN-filled ``_real`` carrying exactly the recorded true pick values
      (``pick_vals``), so discovery counts recompute identically — never-
      picked cells stay NaN and count as unknowable, as in ``_pick_vals``.
    """
    crits = dg.get("criteria", {})
    max_i = max_j = 0
    for c in crits.values():
        for p in c.get("picks", ()):
            if p is not None:
                max_i = max(max_i, int(p[0]))
                max_j = max(max_j, int(p[1]))
    real = np.full((max_i + 1, max_j + 1), np.nan)
    out: Dict[str, object] = {
        "_kind": dg.get("kind"),
        "_rating_vals": (
            tuple(dg["rating_vals"]) if dg.get("rating_vals") else None
        ),
        "_args": dg.get("args", {}),
        "_from_digest": True,
    }
    # engine-era provenance round-trips: digest(results_from_digest(dg))
    # must keep the recorded era, and the parity checker reads it to flag
    # mixed-era arms
    if dg.get("sampler_era") is not None:
        out["_sampler_era"] = dg["sampler_era"]
    if dg.get("solver_era") is not None:
        out["_solver_era"] = dg["solver_era"]
    crit_meta = {
        short: {k: c[k] for k in ("spliced", "era") if k in c}
        for short, c in crits.items()
        if any(k in c for k in ("spliced", "era"))
    }
    if crit_meta:
        out["_criteria_meta"] = crit_meta
    kind = dg.get("kind")
    for short, c in crits.items():
        fse = c.get("first_step_evals")
        recs: List[tuple] = []
        pick_vals = c.get("pick_vals") or [None] * len(c["n_rated"])
        for t, (nr, err) in enumerate(zip(c["n_rated"], c["err"])):
            p = c["picks"][t]
            pick = None if p is None else (int(p[0]), int(p[1]))
            if pick is not None and pick_vals[t] is not None:
                real[pick] = float(pick_vals[t])
            evals = None
            if t == 1 and fse is not None:
                evals = np.asarray(fse, np.float64)
            recs.append((int(nr), float(err), pick, evals))
        key = short if kind in (None, "apmf") else f"{kind}_{short}"
        out[key] = recs
    out["_real"] = real
    return out


def merge_results(base: Dict, extra: Dict) -> Dict:
    """Merge criterion records from another results file (the reference
    merges MMMF/RC outputs into a shared pickle, active_mmmf.py:240-245).

    ``_real`` must also merge: a digest-reconstructed results dict carries a
    NaN-filled ``_real`` sized to ITS OWN recorded picks (results_from_digest),
    so keeping only ``base``'s matrix lets ``extra``'s picks index out of
    bounds in the discovery curves. Union the two on a NaN-padded canvas of
    the larger shape; where both recorded a true value, ``base`` wins (they
    agree whenever the runs share a data file)."""
    out = dict(base)
    for key, val in extra.items():
        if not key.startswith("_"):
            out[key] = val
    br, er = base.get("_real"), extra.get("_real")
    if br is not None and er is not None:
        br, er = np.asarray(br, float), np.asarray(er, float)
        shape = (max(br.shape[0], er.shape[0]), max(br.shape[1], er.shape[1]))
        real = np.full(shape, np.nan)
        real[: er.shape[0], : er.shape[1]] = er
        canvas = real[: br.shape[0], : br.shape[1]]
        real[: br.shape[0], : br.shape[1]] = np.where(
            np.isnan(br), canvas, br
        )
        out["_real"] = real
    return out


def rmse_curve(records: List[tuple]) -> Tuple[np.ndarray, np.ndarray]:
    """(num_rated, rmse) arrays from one criterion's records."""
    ns = np.asarray([r[0] for r in records], dtype=np.float64)
    errs = np.asarray([r[1] for r in records], dtype=np.float64)
    return ns, errs


def first_step_evals(records: List[tuple]) -> Optional[np.ndarray]:
    """The first-step criterion map (used for cross-implementation agreement,
    compare_firsts.py methodology)."""
    for rec in records[1:]:
        if rec[3] is not None:
            return np.asarray(rec[3])
    return None


def aucs(results: Dict) -> Dict[str, float]:
    """Area under each criterion's RMSE curve (plot_aucs.py analogue)."""
    out = {}
    for key, recs in results.items():
        if key.startswith("_") or not isinstance(recs, list):
            continue
        ns, errs = rmse_curve(recs)
        if len(ns) >= 2:
            out[key] = area_under_curve(ns, errs)
    return out


def count_ge_cutoff_curve(
    results: Dict, key: str, cutoff: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Discovery curve: cumulative count of queried cells with true value >=
    cutoff (reference: plot_results.py:200-213)."""
    real = results["_real"]
    recs = results[key]
    ns, counts = [], []
    total = 0
    for rec in recs:  # records may carry a 5th pred_matrix element (mmmf)
        num_rated, ij = rec[0], rec[2]
        if ij is not None and real[ij[0], ij[1]] >= cutoff:
            total += 1
        ns.append(num_rated)
        counts.append(total)
    return np.asarray(ns), np.asarray(counts)


def first_step_maps(
    results_list: List[Dict], keys: List[str]
) -> Dict[str, "np.ndarray"]:
    """First-step criterion maps, labeled 'run<i>:<key>' when the same key
    appears in multiple files (so two runs of one criterion still pair)."""
    maps: Dict[str, np.ndarray] = {}
    for idx, res in enumerate(results_list):
        for key in keys:
            if key in res:
                ev = first_step_evals(res[key])
                if ev is not None:
                    label = key if key not in maps and not any(
                        k.endswith(":" + key) for k in maps
                    ) else f"run{idx}:{key}"
                    if key in maps:  # retro-label the first occurrence
                        maps[f"run0:{key}"] = maps.pop(key)
                        label = f"run{idx}:{key}"
                    maps[label] = ev
    return maps


def compare_first_steps(
    results_list: List[Dict], keys: List[str]
) -> Dict[Tuple[str, str], float]:
    """Pairwise Kendall-tau agreement between first-step criterion maps
    across results files (reference: compare_firsts.py:133-151)."""
    maps = first_step_maps(results_list, keys)
    out = {}
    names = sorted(maps)
    for i, a in enumerate(names):
        for b in names[i + 1 :]:
            out[(a, b)] = kendall_tau(maps[a], maps[b])
    return out
