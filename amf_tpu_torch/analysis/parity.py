"""Parity acceptance checks and compact digests for experiment results
(mirrors ``amf_tpu/analysis/parity.py``).

BASELINE.md's parity targets cannot be literal draw-level comparisons: the
reference uses unseeded global RNG everywhere (SURVEY.md §2.5) and cannot
execute under numpy 2, and it publishes no numbers. The operational
acceptance bands, following the reference's own strongest correctness
methodology (cross-implementation agreement, compare_firsts.py:133-151):

  1. structural  — every criterion's record trace is well-formed: finite
     errors, monotone n_rated, picks inside the matrix (HARD check);
  2. learning    — the error at the end of the sweep improved on the initial
     fit for informative criteria (HARD, with slack: noisy small problems);
  3. active>=random — informative criteria have learning-curve AUC no worse
     than random's × (1 + slack) on the same data (HARD on the 10x10 and
     DrugBank workloads where the reference documents active winning —
     strict_active; SOFT elsewhere: the reference's own MovieLens curves
     show pred-variance tracking/losing to random at the 200-step horizon);
  4. cross-engine agreement — where two independent engines (Gibbs vs NUTS
     vs variational) scored the same first step on the same data, Kendall τ
     of their eval maps ≥ a floor (SOFT; reference evidence level is τ>0.4
     between its Gibbs and Stan implementations).

``digest`` strips eval grids so full-length sweeps can be committed as
artifacts (a raw ML-100k results pickle is ~2 GB of per-step eval matrices;
the digest keeps curves, picks, and the first-step eval map only).
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np

from amf_tpu_torch.analysis import metrics
from amf_tpu_torch.analysis.results import (
    first_step_evals,
    guess_kind,
    load_results,
    results_from_digest,
    rmse_curve,
)

# criteria that carry information (everything except random); 'pred' ranks
# by predicted magnitude, which is informative for discovery counts but NOT
# expected to beat random on RMSE — exclude it from the active>=random band
# (the reference's own plots show pred losing on RMSE, plot_results.py:200).
_RMSE_UNINFORMATIVE = ("random", "pred")


def _ge_cutoff(short: str) -> Optional[float]:
    """Cutoff of a discovery (active-search) criterion, else None.

    prob-ge-X / 1step-ge-X / rc's ge-X deliberately query cells likely to
    BE >= cutoff (Garnett-style active search), not cells that reduce test
    error — the reference evaluates them on count-≥-cutoff discovery
    curves (plot_results.py:200-213), and its papers show them losing to
    random on RMSE by design. They get the discovery band, not the RMSE
    bands."""
    for pre in ("prob-ge-", "1step-ge-", "ge-"):
        if short.startswith(pre):
            try:
                return float(short[len(pre):])
            except ValueError:
                return None
    if short.endswith("-margin-pos"):
        # MMMF positive-margin selectors query among predicted-positive
        # cells only (select_min_margin_pos.m) — a discovery restriction;
        # results are ±1-binarized, so positives are values >= 0
        return 0.0
    return None


# MMMF's max-margin selector queries the MOST certain cell — the
# reference's deliberately-anti-informative comparison arm (its papers
# show it losing to random by design). Not an RMSE acceptance target.
_RMSE_CONTROL = ("max-margin",)


def _pick_vals(recs, real: np.ndarray) -> List[Optional[float]]:
    """True rating of each queried cell (None for the initial record)."""
    out: List[Optional[float]] = []
    for r in recs:
        ij = r[2]
        if ij is None:
            out.append(None)
        else:
            v = float(real[int(ij[0]), int(ij[1])])
            out.append(v if np.isfinite(v) else None)
    return out


def _discovery_auc(ns, pick_vals, cutoff: float) -> float:
    """Area under the cumulative count-≥-cutoff curve (higher = better)."""
    c, counts = 0, []
    for v in pick_vals:
        if v is not None and v >= cutoff:
            c += 1
        counts.append(c)
    return float(metrics.area_under_curve(ns, np.asarray(counts, float)))


def _strip_prefix(key: str) -> str:
    for pre in ("mnpmf_", "mmmf_", "bayes_", "stan_", "rc_", "apmf_"):
        if key.startswith(pre):
            return key[len(pre):]
    return key


# Workload dirs where the reference's papers document active selection
# beating random (10x10 synthetic lookahead configs; DrugBank discovery):
# there the active>=random band is allowed to HARD-FAIL instead of warn.
# On the MovieLens from-5% workloads the reference's own curves show
# pred-variance tracking or losing to random at the 200-step horizon, so
# underperformance there characterizes the workload, not the code.
_STRICT_ACTIVE_PREFIXES = ("10x10", "drugbank", "criteria")


def strict_active_for(outdir: str) -> bool:
    return os.path.basename(os.path.normpath(outdir)).startswith(
        _STRICT_ACTIVE_PREFIXES
    )


def digest(results: Dict, kind: Optional[str] = None) -> Dict:
    """Compact, committable summary of one results pickle."""
    kind = kind or guess_kind(results)
    out: Dict[str, object] = {
        "kind": kind,
        "rating_vals": (
            list(np.asarray(results["_rating_vals"]).tolist())
            if results.get("_rating_vals") is not None else None
        ),
        "args": {
            # scalars pass through; the list-valued --note (git-rev +
            # experiment provenance) is joined so digests keep it
            k: (" | ".join(map(str, v)) if k == "note" and
                isinstance(v, (list, tuple)) else v)
            for k, v in (results.get("_args") or {}).items()
            if isinstance(v, (str, int, float, bool, type(None)))
            or (k == "note" and isinstance(v, (list, tuple)))
        },
        "criteria": {},
    }
    # engine-era provenance: lets later re-record queues decide
    # whether a committed digest was produced by current engine code
    # (raw pickles are gitignored, so the digest is the durable record).
    # The era is COPIED from the run-time stamp the CLI wrote into the
    # results pickle — never re-derived from the currently imported
    # constants, so re-digesting an old-era pickle keeps its true era
    # ("pre-era" = produced before run-time stamping existed; see
    # scripts/backfill_era.py for provenance-based backfills).
    if kind in ("stan", "stan_newitems"):
        out["sampler_era"] = str(results.get("_sampler_era", "pre-era"))
    elif kind == "mmmf":
        out["solver_era"] = str(results.get("_solver_era", "pre-era"))
    for key, recs in results.items():
        if key.startswith("_") or not isinstance(recs, list):
            continue
        ns, errs = rmse_curve(recs)
        picks = [
            (None if r[2] is None else [int(r[2][0]), int(r[2][1])])
            for r in recs
        ]
        fse = first_step_evals(recs)
        out["criteria"][_strip_prefix(key)] = {
            "n_rated": [int(x) for x in ns],
            "err": [float(x) for x in errs],
            "picks": picks,
            # true rating of each pick: lets any cutoff's discovery curve
            # be recomputed from the digest alone (seed aggregation)
            "pick_vals": _pick_vals(recs, np.asarray(results["_real"], float)),
            "auc": float(metrics.area_under_curve(ns, errs)),
            "first_step_evals": (
                None if fse is None
                else np.round(np.asarray(fse, np.float64), 6).tolist()
            ),
        }
    # round-trip per-criterion provenance notes (splice markers, per-arm
    # era) when re-digesting a digest-reconstructed results dict
    for short, meta in (results.get("_criteria_meta") or {}).items():
        if short in out["criteria"]:
            out["criteria"][short].update(meta)
    return out


def load_adjudications(outdir: str) -> Dict[Tuple[str, str], str]:
    """Committed noise-floor adjudication artifacts for an experiment dir.

    Returns {(kind, criterion): artifact filename} for every criterion a
    committed ``adjudication_*.json`` probe measured as UNRELIABLE at the
    recorded sample budget (``reliable: false`` with split-half / seed-pair
    Kendall-τ evidence; written by scripts/adjudicate_*.py). A map that
    cannot reproduce its own candidate ranking across seeds cannot drive
    learning on that workload, so strict-band failures for those criteria
    are downgraded to evidence-pointing warns ("expected-flat", VERDICT r2
    item 4) rather than reported as engine defects."""
    floored: Dict[Tuple[str, str], str] = {}
    for path in sorted(glob.glob(os.path.join(outdir, "adjudication_*.json"))):
        try:
            with open(path) as f:
                art = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        if art.get("reliable") is not False:
            continue
        for crit in art.get("criteria") or ():
            floored[(art.get("kind"), crit)] = os.path.basename(path)
    return floored


def check_results(results: Dict, kind: Optional[str] = None,
                  improve_slack: float = 0.02,
                  random_slack: float = 0.10,
                  strict_active: bool = False,
                  noise_floored: Optional[Dict[str, str]] = None
                  ) -> List[Dict]:
    """Run bands 1-3 on one results dict; returns a list of check rows
    {check, key, status ('pass'|'warn'|'fail'), detail}.

    With ``strict_active`` (workloads where the reference documents active
    beating random, see _STRICT_ACTIVE_PREFIXES), a criterion whose error
    WORSENS over the sweep or whose AUC is worse than random beyond slack
    hard-fails instead of warning — "ran and didn't diverge" is not
    acceptance evidence on those workloads.

    ``noise_floored`` maps criterion shorts to the adjudication artifact
    that measured their map below the reliability floor (load_adjudications);
    fails on those criteria downgrade to warns citing the artifact."""
    noise_floored = noise_floored or {}

    def _floor_downgrade(short, status, note):
        if status == "fail" and short in noise_floored:
            return "warn", (f"{note}; criterion map measured below noise "
                            f"floor at recorded budget, expected-flat "
                            f"({noise_floored[short]})")
        return status, note
    kind = kind or guess_kind(results)
    rows: List[Dict] = []
    curves: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    recs_by_short: Dict[str, list] = {}
    for key, recs in results.items():
        if key.startswith("_") or not isinstance(recs, list):
            continue
        short = _strip_prefix(key)
        ns, errs = rmse_curve(recs)
        curves[short] = (ns, errs)
        recs_by_short[short] = recs
        shape = np.asarray(results["_real"]).shape

        ok = (
            np.all(np.isfinite(errs))
            and np.all(np.diff(ns) > 0)
            and all(
                r[2] is None
                or (0 <= r[2][0] < shape[0] and 0 <= r[2][1] < shape[1])
                for r in recs
            )
        )
        # A [0,1]-bounded (misclassification) trace pinned at exactly 1.0
        # means EVERY test cell is scored wrong — unreachable by any real
        # predictor (coin-flipping scores ~0.5); it is the signature of
        # sign(NaN) poisoning (the gesdd-SVT failure that invalidated the
        # first newmovies-20d mmmf recording). Structural failure.
        sat = np.asarray(errs) >= 1.0 - 1e-12
        pinned = bool(
            np.max(errs) <= 1.0 + 1e-12 and sat[-1] and sat.sum() >= 3
        )
        detail = (f"{len(recs)} records, err[0]={errs[0]:.4f}, "
                  f"err[-1]={errs[-1]:.4f}")
        if pinned:
            detail += (" — PINNED at 1.0 misclassification "
                       "(all cells wrong: NaN/sign pathology)")
        rows.append({
            "check": "structural", "key": short,
            "status": "pass" if ok and not pinned else "fail",
            "detail": detail,
        })

    # era/initial-state consistency: every arm of one run shares the same
    # initial fit, so initial errors must agree (committed digests show
    # byte-identical err[0] across arms; a spliced fresh arm may differ by
    # sampler MC noise). A large spread is the signature of MIXED-ERA arms
    # — e.g. a frozen-sampler checkpoint resumed next to fixed-sampler
    # re-records (the 58k-15d random arm, err[0] 0.9874 vs 1.2927) — which
    # makes active-vs-random AUC comparisons meaningless. Provenance
    # defect, so it hard-fails regardless of strict_active.
    if len(curves) > 1:
        crit_meta = results.get("_criteria_meta") or {}
        e0 = {s: float(errs[0]) for s, (ns, errs) in curves.items()
              if len(errs)}
        # a NaN err[0] would fall through every band below (NaN compares
        # false) into a spurious MIXED-ERA fail with arbitrary lo/hi arms;
        # it is a numeric pathology, not a provenance defect — name it,
        # and run the spread bands on the finite arms only
        nan_arms = sorted(s for s, v in e0.items() if not np.isfinite(v))
        if nan_arms:
            rows.append({
                "check": "initial_consistency", "key": "all-arms",
                "status": "fail",
                "detail": f"non-finite err[0] in arms {nan_arms} "
                          "(numeric pathology; see structural rows)",
            })
            e0 = {s: v for s, v in e0.items() if np.isfinite(v)}
        if len(e0) > 1:
            lo_s = min(e0, key=e0.get)
            hi_s = max(e0, key=e0.get)
            lo, hi = e0[lo_s], e0[hi_s]
            rel = (hi - lo) / max((hi + lo) / 2.0, 1e-12)
            spliced = sorted(
                s for s, m in crit_meta.items() if "spliced" in m)
            if rel <= 0.02:
                status, note = "pass", "arms share the initial state"
            elif rel <= 0.08:
                status = "warn"
                note = ("initial errs differ beyond MC noise"
                        if not spliced else
                        f"initial errs differ; spliced arms: {spliced}")
            else:
                status = "fail"
                note = ("initial errs inconsistent — arms look MIXED-ERA "
                        "(stale checkpoint resumed next to re-recorded "
                        "arms?)")
            rows.append({
                "check": "initial_consistency", "key": "all-arms",
                "status": status,
                "detail": f"err[0] spread {rel * 100:.1f}% "
                          f"({lo_s} {lo:.4f} .. {hi_s} {hi:.4f}) ({note})",
            })

    for short, (ns, errs) in curves.items():
        if short in _RMSE_UNINFORMATIVE or short in _RMSE_CONTROL:
            continue
        if len(errs) <= 2 or _ge_cutoff(short) is not None:
            continue  # discovery criteria get the discovery band below
        improved = errs[-1] <= errs[0] * (1 + improve_slack)
        worsened = errs[-1] > errs[0] * (1 + improve_slack)
        tracks_random = "random" in curves and (
            errs[-1] <= curves["random"][1][-1] * (1 + random_slack)
        )
        if improved:
            status = "pass"
            note = ("improved" if errs[-1] <= errs[0]
                    else "flat within improve slack")
        elif worsened and strict_active:
            # on strict workloads a rising error curve is a defect, not a
            # regime — no random-slack escape hatch
            status, note = "fail", "err ROSE on a strict workload"
        elif tracks_random:
            # metric-flat regime the reference itself documents (its ML
            # curves show pred-variance losing to random at 200/58k
            # ratings): acceptable within the same slack used for the
            # AUC-vs-random band
            note = ("err rose but tracks random within slack"
                    if worsened else "flat, tracks random within slack")
            status = "warn"
        else:
            status, note = "fail", "err rose beyond random+slack"
        status, note = _floor_downgrade(short, status, note)
        rows.append({
            "check": "learning", "key": short,
            "status": status,
            "detail": f"err {errs[0]:.4f} -> {errs[-1]:.4f} ({note})",
        })

    if "random" in curves:
        ns_r, err_r = curves["random"]
        auc_r = metrics.area_under_curve(ns_r, err_r)
        for short, (ns, errs) in curves.items():
            if short in _RMSE_UNINFORMATIVE or short in _RMSE_CONTROL:
                continue
            if len(errs) < 3 or _ge_cutoff(short) is not None:
                continue
            auc = metrics.area_under_curve(ns, errs)
            if auc <= auc_r:
                status, note = "pass", "beats random"
            elif auc <= auc_r * (1 + random_slack):
                status = "warn" if strict_active else "pass"
                note = "worse than random, within slack"
            else:
                status = "fail" if strict_active else "warn"
                note = "underperforms random beyond slack"
            status, note = _floor_downgrade(short, status, note)
            rows.append({
                "check": "active_vs_random", "key": short,
                "status": status,
                "detail": f"auc {auc:.4f} vs random {auc_r:.4f} ({note})",
            })

        # discovery band: ge-criteria query cells likely >= cutoff; the
        # acceptance axis is the cumulative count of true-positives found
        # (reference: count_ge_cutoff curves, plot_results.py:200-213)
        real = np.asarray(results["_real"], float)
        rand_vals = _pick_vals(recs_by_short["random"], real)
        ns_rand = [r[0] for r in recs_by_short["random"]]
        for short, recs in recs_by_short.items():
            cutoff = _ge_cutoff(short)
            if cutoff is None or len(recs) < 3:
                continue
            ns_k = [r[0] for r in recs]
            auc = _discovery_auc(ns_k, _pick_vals(recs, real), cutoff)
            auc_r = _discovery_auc(ns_rand, rand_vals, cutoff)
            if auc >= auc_r:
                status, note = "pass", "finds >= random"
            elif auc >= auc_r * (1 - random_slack):
                status = "warn" if strict_active else "pass"
                note = "finds fewer than random, within slack"
            else:
                status = "fail" if strict_active else "warn"
                note = "finds fewer than random beyond slack"
            rows.append({
                "check": "discovery_vs_random", "key": short,
                "status": status,
                "detail": f"count>={cutoff:g} auc {auc:.1f} vs random "
                          f"{auc_r:.1f} ({note})",
            })
    return rows


def check_cross_engine(results_by_kind: Dict[str, Dict],
                       tau_floor: float = 0.4) -> List[Dict]:
    """Band 4: Kendall τ between first-step eval maps of the same criterion
    computed by different engines on the same data (compare_firsts.py
    methodology; τ>0.4 is the reference's own cross-implementation level)."""
    rows: List[Dict] = []
    maps: Dict[str, Dict[str, np.ndarray]] = {}
    for kind, res in results_by_kind.items():
        for key, recs in res.items():
            if key.startswith("_") or not isinstance(recs, list):
                continue
            if _strip_prefix(key) == "random":
                # two uniform-noise maps: tau ~ 0 by construction, not a
                # cross-implementation signal
                continue
            fse = first_step_evals(recs)
            if fse is not None:
                maps.setdefault(_strip_prefix(key), {})[kind] = fse
    for short, by_kind in maps.items():
        kinds = sorted(by_kind)
        for i in range(len(kinds)):
            for j in range(i + 1, len(kinds)):
                a, b = by_kind[kinds[i]], by_kind[kinds[j]]
                sel = np.isfinite(a) & np.isfinite(b)
                if sel.sum() < 5:
                    continue
                tau = metrics.kendall_tau(a[sel], b[sel])
                rows.append({
                    "check": "cross_engine_tau",
                    "key": f"{short}:{kinds[i]}~{kinds[j]}",
                    "status": "pass" if tau >= tau_floor else "warn",
                    "detail": f"tau={tau:.3f} over {int(sel.sum())} cells",
                })
    return rows


def aggregate_seed_checks(
    seed_dirs: List[str],
    strict_active: bool = False,
    random_slack: float = 0.10,
    improve_slack: float = 0.02,
) -> List[Dict]:
    """Acceptance bands over SEED MEANS (VERDICT r2: single-seed 10x10
    bands are noisy draws). Reads the digest_*.json.gz files previously
    written in each seed dir; for every (run, criterion) the statistic is
    the per-seed AUC ratio vs that SAME seed's random arm, aggregated as
    mean +/- spread across seeds. A ``seed_learning`` band aggregates the
    same endpoint-rise statistic as the single-run learning band
    (err[-1]/err[0], same improve slack), so a strict learning fail can be
    adjudicated by replicates of the statistic that failed — exactly the
    treatment the d4 min-margin-pos discovery fail got."""
    per: Dict[Tuple[str, str], List[Tuple[float, Optional[float]]]] = {}
    disc: Dict[Tuple[str, str], List[Tuple[float, float]]] = {}
    learn: Dict[Tuple[str, str], List[float]] = {}
    for d in seed_dirs:
        for dpath in sorted(glob.glob(os.path.join(d, "digest_*.json.gz"))):
            with gzip.open(dpath, "rt") as f:
                dg = json.load(f)
            stem = os.path.basename(dpath)[len("digest_"):-len(".json.gz")]
            crits = dg.get("criteria", {})
            rand = crits.get("random") or {}
            rand_auc = rand.get("auc")
            for key, c in crits.items():
                # AUC-over-steps bands need a horizon to integrate: on the
                # 2-step criteria-comparison workloads (reference
                # 1step_discrete) discovery counts are 0/1/2 and the
                # per-seed ratios collapse to {0, 1} — pure noise. Those
                # workloads are judged by first-step map agreement
                # (compare_firsts violin grids), not learning curves.
                if len(c.get("n_rated") or ()) < 10:
                    continue
                cutoff = _ge_cutoff(key)
                if cutoff is not None:
                    # discovery keys aggregate on count-≥-cutoff AUC
                    if c.get("pick_vals") and rand.get("pick_vals"):
                        disc.setdefault((stem, key), []).append((
                            _discovery_auc(c["n_rated"], c["pick_vals"],
                                           cutoff),
                            _discovery_auc(rand["n_rated"],
                                           rand["pick_vals"], cutoff),
                        ))
                    continue
                if key in _RMSE_CONTROL:
                    continue
                per.setdefault((stem, key), []).append((c["auc"], rand_auc))
                errs = c.get("err") or ()
                if (key not in _RMSE_UNINFORMATIVE
                        and len(errs) > 2 and errs[0]):
                    learn.setdefault((stem, key), []).append(
                        float(errs[-1]) / float(errs[0]))
    rows: List[Dict] = []
    for (stem, key), ratios in sorted(learn.items()):
        if len(ratios) < 2:
            continue
        mean, spread = float(np.mean(ratios)), float(np.std(ratios))
        if mean <= 1.0 + improve_slack:
            status = "pass"
            note = ("improved on seed mean" if mean <= 1.0
                    else "flat within improve slack on seed mean")
        else:
            status = "fail" if strict_active else "warn"
            note = "err rose beyond improve slack on seed mean"
        rows.append({
            "check": "seed_learning",
            "key": f"{stem}:{key}",
            "status": status,
            "detail": f"err[-1]/err[0] over {len(ratios)} seeds: "
                      f"{mean:.4f} +/- {spread:.4f} ({note})",
        })
    for (stem, key), entries in sorted(disc.items()):
        ratios = [a / r for a, r in entries if r]
        if len(ratios) < 2:
            continue
        mean, spread = float(np.mean(ratios)), float(np.std(ratios))
        if mean >= 1.0:
            status, note = "pass", "finds >= random on seed mean"
        elif mean >= 1.0 - random_slack:
            status = "warn" if strict_active else "pass"
            note = "finds fewer than random on seed mean, within slack"
        else:
            status = "fail" if strict_active else "warn"
            note = "finds fewer than random on seed mean beyond slack"
        rows.append({
            "check": "seed_discovery_vs_random",
            "key": f"{stem}:{key}",
            "status": status,
            "detail": f"discovery auc/random over {len(ratios)} seeds: "
                      f"{mean:.4f} +/- {spread:.4f} ({note})",
        })
    for (stem, key), entries in sorted(per.items()):
        if key in _RMSE_UNINFORMATIVE:
            continue
        ratios = [a / r for a, r in entries if r]
        if len(ratios) < 2:
            continue
        mean = float(np.mean(ratios))
        spread = float(np.std(ratios))
        if mean <= 1.0:
            status, note = "pass", "beats random on seed mean"
        elif mean <= 1.0 + random_slack:
            status = "warn" if strict_active else "pass"
            note = "worse than random on seed mean, within slack"
        else:
            status = "fail" if strict_active else "warn"
            note = "underperforms random on seed mean beyond slack"
        rows.append({
            "check": "seed_active_vs_random",
            "key": f"{stem}:{key}",
            "status": status,
            "detail": f"auc/random over {len(ratios)} seeds: "
                      f"{mean:.4f} +/- {spread:.4f} ({note})",
        })
    return rows


def _seed_passing_bands(outdir: str) -> Dict[Tuple[str, str, str], str]:
    """(stem, key, check) triples whose seed-MEAN band passes in a committed
    parity_report_seeds.json (written by `run.experiment --seeds --check`).

    A strict single-run band exists to catch real regressions, but on the
    small workloads one draw is noisy; when the seed-mean estimator of the
    same statistic passes, a single-run fail is a draw, not a defect —
    downgrade it with the evidence pointer."""
    path = os.path.join(outdir, "parity_report_seeds.json")
    out: Dict[Tuple[str, str], str] = {}
    try:
        with open(path) as f:
            report = json.load(f)
    except (OSError, json.JSONDecodeError):
        return out
    for row in report.get("checks", []):
        check = row.get("check", "")
        if not check.startswith("seed_"):
            continue
        if row.get("status") == "pass" and ":" in row.get("key", ""):
            stem, key = row["key"].split(":", 1)
            # keyed by the single-run band this seed band replicates
            # (seed_learning adjudicates learning, seed_discovery_vs_random
            # adjudicates discovery_vs_random, ...): a passing seed-mean of
            # one statistic must not excuse a fail of a different one
            out[(stem, key, check[len("seed_"):])] = os.path.basename(path)
    return out


def check_experiment_dir(outdir: str,
                         strict_active: Optional[bool] = None
                         ) -> Tuple[List[Dict], bool]:
    """Check every results_*.pkl in an experiment directory; also writes
    digest_<kind>.json.gz next to each. Returns (rows, hard_ok).
    ``strict_active`` defaults from the directory name (strict on the
    10x10/drugbank workloads where the reference documents active wins)."""
    if strict_active is None:
        strict_active = strict_active_for(outdir)
    rows: List[Dict] = []
    by_kind: Dict[str, Dict] = {}
    adjudicated = load_adjudications(outdir)
    seed_pass = _seed_passing_bands(outdir)
    # raw results pickles are gitignored and may be absent on a fresh
    # checkout (or after a cleanup); committed digest_*.json.gz files are
    # the durable artifact — fall back to them so the acceptance bands are
    # reproducible from committed artifacts alone
    # *_fresh artifacts are splice temps (scripts/splice_digest_key.py:
    # a single-key re-run awaiting merge into a committed digest) — not
    # durable runs; digesting one would leave a phantom single-arm "run"
    # in the dir, and while the pickle exists it would hijack by_kind for
    # its engine, suppressing the real cross-engine rows
    sources: List[Tuple[str, str]] = [
        (p, "pickle")
        for p in sorted(glob.glob(os.path.join(outdir, "results_*.pkl")))
        if not p.endswith("_fresh.pkl")
    ]
    pkl_stems = {
        os.path.basename(p)[len("results_"):-len(".pkl")]
        for p, _ in sources
    }
    for dpath in sorted(glob.glob(os.path.join(outdir, "digest_*.json.gz"))):
        stem = os.path.basename(dpath)[len("digest_"):-len(".json.gz")]
        if stem not in pkl_stems and not stem.endswith("_fresh"):
            sources.append((dpath, "digest"))

    for path, src in sources:
        if src == "digest":
            with gzip.open(path, "rt") as f:
                res = results_from_digest(json.load(f))
            stem = os.path.basename(path)[len("digest_"):-len(".json.gz")]
        else:
            res = load_results(path)
            stem = os.path.basename(path)[len("results_"):-len(".pkl")]
        kind = guess_kind(res)
        # first file of a kind wins for cross-engine comparison (sorted
        # order puts results_bayes.pkl before results_bayes_la.pkl — the
        # main run, not an auxiliary one)
        by_kind.setdefault(kind, res)
        floored = {
            crit: fname for (k, crit), fname in adjudicated.items()
            if k in (None, kind)
        }
        for row in check_results(res, kind, strict_active=strict_active,
                                 noise_floored=floored):
            row["run"] = stem
            if src == "digest":
                row["source"] = "digest"
            sp = seed_pass.get((stem, row["key"], row["check"]))
            if row["status"] == "fail" and sp:
                row["status"] = "warn"
                row["detail"] += (
                    "; single-seed draw — the seed-mean band of this same "
                    f"statistic passes ({sp})")
            rows.append(row)
        if src == "digest":
            continue  # never overwrite a committed digest with a round-trip
        dg = digest(res, kind)
        # digest named after the results file (not the kind): one dir can
        # hold several runs of the same kind (e.g. results_bayes +
        # results_bayes_la for the 70x306 lookahead demonstration)
        dpath = os.path.join(outdir, f"digest_{stem}.json.gz")
        with gzip.open(dpath, "wt") as f:
            json.dump(dg, f)
    if len(by_kind) > 1:
        rows.extend(check_cross_engine(by_kind))
    hard_ok = all(r["status"] != "fail" for r in rows)
    return rows, hard_ok
