"""The port's parity acceptance checks (``amf_tpu_torch/analysis/parity.py``)
held to the JAX package's on the same inputs.

* ``check_experiment_dir`` on two copies of each of two committed
  experiment directories (``experiments/10x10_discrete2_d2``: 99 rows,
  ``hard_ok`` true, statuses pass and warn; ``experiments/drugbank-94x425``:
  25 rows, ``hard_ok`` false, statuses pass, warn and fail): the same rows
  in the same order, each field equal, and the digests each writes equal
  with numbers to 1e-12. The checker writes ``digest_*.json.gz`` next to
  every results pickle, so it runs on copies in ``tmp_path``, never on
  ``experiments/``.
* Every case of ``tests/test_parity.py`` that builds synthetic results
  dicts, run through both packages: the outputs equal, numbers to 1e-12.
"""

import gzip
import json
import os
import pickle
import shutil

import numpy as np
import pytest

import torch_threads  # noqa: F401  (one torch thread a worker)
from amf_tpu.analysis import parity as jparity
from amf_tpu.analysis import results as jresults
from amf_tpu_torch.analysis import parity as tparity
from amf_tpu_torch.analysis import results as tresults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPERIMENTS = os.path.join(ROOT, "experiments")
TOL = 1e-12


def assert_same(got, want, where="out"):
    """Equal structure; strings, bools and ints exactly, floats to TOL,
    NaN where NaN."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), (
            where, list(got), list(want))
        for k in want:
            assert_same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        np.testing.assert_allclose(np.asarray(got, float),
                                   np.asarray(want, float), rtol=TOL,
                                   atol=TOL, err_msg=where)
    elif isinstance(want, float):
        assert isinstance(got, float), (where, got)
        if np.isnan(want):
            assert np.isnan(got), (where, got)
        else:
            assert got == pytest.approx(want, rel=TOL, abs=TOL), (
                where, got, want)
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


def read_digests(d):
    out = {}
    for name in sorted(os.listdir(d)):
        if name.startswith("digest_") and name.endswith(".json.gz"):
            with gzip.open(os.path.join(d, name), "rt") as f:
                out[name] = json.load(f)
    return out


@pytest.mark.parametrize("name,n_rows,hard_ok,statuses", [
    ("10x10_discrete2_d2", 99, True, {"pass", "warn"}),
    ("drugbank-94x425", 25, False, {"pass", "warn", "fail"}),
])
def test_check_experiment_dir_matches_jax(tmp_path, name, n_rows, hard_ok,
                                          statuses):
    src = os.path.join(EXPERIMENTS, name)
    runs = {}
    for pkg, parity in (("jax", jparity), ("torch", tparity)):
        d = str(tmp_path / pkg / name)
        shutil.copytree(src, d)
        rows, ok = parity.check_experiment_dir(d)
        runs[pkg] = (rows, ok, read_digests(d))
    rows, ok, digests = runs["torch"]
    assert len(rows) == n_rows and ok is hard_ok
    assert {r["status"] for r in rows} == statuses
    assert_same(runs["torch"], runs["jax"])


def _fake_results(err_curve, key="pred-variance", kind="apmf", n=4, m=4):
    rng = np.random.default_rng(0)
    recs = [(4, err_curve[0], None, None)]
    for t, e in enumerate(err_curve[1:]):
        ev = rng.normal(size=(n, m))
        recs.append((5 + t, e, (t % n, (t + 1) % m), ev))
    rand = [(4, err_curve[0], None, None)] + [
        (5 + t, err_curve[0] * (1 - 0.01 * t), (t % n, t % m),
         rng.normal(size=(n, m)))
        for t in range(len(err_curve) - 1)
    ]
    return {
        "_real": np.ones((n, m)),
        "_rating_vals": (1.0, 2.0),
        "_kind": kind,
        key: recs,
        "random": rand,
    }


def _write_digest(path, dg):
    with gzip.open(path, "wt") as f:
        json.dump(dg, f)


# Each case takes (parity module, results module, a fresh directory) and
# returns what tests/test_parity.py's test of the same name asserts on.

def case_check_results_pass(P, R, d):
    return P.check_results(_fake_results([1.0, 0.8, 0.6, 0.5]), "apmf")


def case_initial_consistency_mixed_era(P, R, d):
    res = _fake_results([1.0, 0.8, 0.6, 0.5])
    rand = res["random"]
    res["random"] = [(rand[0][0], 0.75, None, None)] + rand[1:]
    return P.check_results(res, "apmf")


def case_initial_consistency_nan_arms(P, R, d):
    res = _fake_results([1.0, 0.8, 0.6, 0.5])
    rand = res["random"]
    res["random"] = [(rand[0][0], float("nan"), None, None)] + rand[1:]
    return P.check_results(res, "apmf")


def case_check_dir_skips_splice_fresh_temps(P, R, d):
    with open(os.path.join(d, "results_stan.pkl"), "wb") as f:
        pickle.dump(_fake_results([1.0, 0.8, 0.6, 0.5], kind="stan"), f)
    with open(os.path.join(d, "results_stan_random_fresh.pkl"), "wb") as f:
        pickle.dump(_fake_results([2.0, 1.8, 1.7, 1.6], kind="stan"), f)
    rows, ok = P.check_experiment_dir(d)
    return rows, ok, sorted(read_digests(d))


def case_check_results_fail_on_worsening(P, R, d):
    return P.check_results(_fake_results([1.0, 1.2, 1.4, 1.5]), "apmf")


def case_strict_active_fails_on_rising_error(P, R, d):
    res = _fake_results([1.0, 1.01, 1.02, 1.04])
    return (P.check_results(res, "apmf", strict_active=False),
            P.check_results(res, "apmf", strict_active=True))


def case_noise_floor_downgrades_fail_to_warn(P, R, d):
    rows = P.check_results(
        _fake_results([1.0, 1.2, 1.4, 1.5]), "apmf", strict_active=True,
        noise_floored={"pred-variance": "adjudication_noise_floor.json"})
    with open(os.path.join(d, "adjudication_a.json"), "w") as f:
        json.dump({"kind": "bayes", "criteria": ["pred-variance"],
                   "reliable": False}, f)
    with open(os.path.join(d, "adjudication_b.json"), "w") as f:
        json.dump({"kind": "stan", "criteria": ["exp-variance"],
                   "reliable": True}, f)
    return rows, P.load_adjudications(d)


def case_seed_passing_bands_loader(P, R, d):
    with open(os.path.join(d, "parity_report_seeds.json"), "w") as f:
        json.dump({"checks": [
            {"check": "seed_active_vs_random", "key": "mmmf:min-margin",
             "status": "pass", "detail": "..."},
            {"check": "seed_active_vs_random", "key": "apmf:pred-variance",
             "status": "warn", "detail": "..."},
            {"check": "active_vs_random", "key": "notseed", "status": "pass",
             "detail": "..."},
        ]}, f)
    return (P._seed_passing_bands(d),
            P._seed_passing_bands(os.path.join(d, "missing")))


def case_strict_active_for_dir_names(P, R, d):
    return [P.strict_active_for(x) for x in (
        "experiments/10x10_discrete2_d2", "experiments/drugbank-70x306-gibbs/",
        "experiments/movielens-58k-from5pct-test5pct-15d",
        "experiments/criteria_10x10_r1")]


def case_aggregate_seed_checks(P, R, d):
    ns = list(range(4, 16))
    errc = [1.0 - 0.01 * t for t in range(len(ns))]
    dirs = [os.path.join(d, f"seed{k}") for k in (1, 2, 3)]
    for sd, ratio in zip(dirs, [0.9, 0.95, 1.02]):
        os.makedirs(sd)
        _write_digest(os.path.join(sd, "digest_apmf.json.gz"), {"criteria": {
            "random": {"auc": 100.0, "err": errc, "n_rated": ns},
            "pred-variance": {"auc": 100.0 * ratio, "err": errc,
                              "n_rated": ns}}})
    long_rows = P.aggregate_seed_checks(dirs, strict_active=True)
    for sd in dirs:
        _write_digest(os.path.join(sd, "digest_apmf.json.gz"), {"criteria": {
            "random": {"auc": 1.0, "err": [1.0, 0.9], "n_rated": [4, 5]},
            "prob-ge-3.5": {"auc": 0.5, "err": [1.0, 0.8], "n_rated": [4, 5],
                            "pick_vals": [None, 4.0]}}})
    return long_rows, P.aggregate_seed_checks(dirs, strict_active=True)


def case_check_results_structural_fail_on_nan(P, R, d):
    return P.check_results(_fake_results([1.0, float("nan"), 0.6, 0.5]),
                           "apmf")


def case_structural_fail_on_pinned_misclassification(P, R, d):
    return (P.check_results(_fake_results([0.49, 1.0, 1.0, 1.0, 1.0],
                                          key="mmmf_min-margin", kind="mmmf"),
                            "mmmf"),
            P.check_results(_fake_results([1.0, 0.8, 0.6, 0.5],
                                          key="mmmf_min-margin", kind="mmmf"),
                            "mmmf"))


def case_learning_label_distinguishes_flat_from_improved(P, R, d):
    return (P.check_results(_fake_results([1.0, 0.99, 1.01]), "apmf"),
            P.check_results(_fake_results([1.0, 0.9, 0.8]), "apmf"))


def case_digest_strips_eval_grids(P, R, d):
    return P.digest(_fake_results([1.0, 0.8, 0.6]), "apmf")


def case_cross_engine_tau(P, R, d):
    a = _fake_results([1.0, 0.8, 0.6], kind="bayes")
    rng = np.random.default_rng(1)
    base = rng.normal(size=(4, 4))
    a["pred-variance"][1] = (5, 0.8, (0, 1), base)
    b = _fake_results([1.0, 0.9, 0.7], kind="stan")
    b["pred-variance"][1] = (5, 0.9, (0, 1),
                             base + 0.01 * rng.normal(size=(4, 4)))
    return P.check_cross_engine({"bayes": a, "stan": b})


def case_check_rows_reproducible_from_digest(P, R, d):
    with open(os.path.join(d, "results_apmf.pkl"), "wb") as f:
        pickle.dump(_fake_results([1.0, 0.8, 0.6, 0.5]), f)
    from_pickle = P.check_experiment_dir(d)
    os.remove(os.path.join(d, "results_apmf.pkl"))
    from_digest = P.check_experiment_dir(d)
    with gzip.open(os.path.join(d, "digest_apmf.json.gz"), "rt") as f:
        rt = R.results_from_digest(json.load(f))
    return from_pickle, from_digest, rt


def case_digest_copies_run_time_era(P, R, d):
    out = []
    for era in ("esjd-leapfrog-v1", "pre-esjd", None):
        res = _fake_results([1.0, 0.9], kind="stan")
        if era:
            res["_sampler_era"] = era
        out.append(P.digest(res, "stan"))
    res = _fake_results([1.0, 0.9], kind="mmmf")
    res["_solver_era"] = "eigh-svt-v1"
    out.append(P.digest(res, "mmmf"))
    out.append(P.digest(_fake_results([1.0, 0.9], kind="apmf"), "apmf"))
    return out


def case_era_round_trips_through_digest_reconstruction(P, R, d):
    res = _fake_results([1.0, 0.9], kind="stan")
    res["_sampler_era"] = "esjd-leapfrog-v1"
    dg = P.digest(res, "stan")
    dg["criteria"]["random"]["spliced"] = "fresh re-run merged at abc1234"
    dg["criteria"]["random"]["era"] = "esjd-leapfrog-v1"
    return P.digest(R.results_from_digest(dg), "stan")


def case_merge_results_unions_real_matrices(P, R, d):
    base = {"_real": np.full((3, 3), np.nan),
            "apmf_pred": [(1, 1.0, None, None), (2, 0.9, (2, 2), None)]}
    base["_real"][2, 2] = 5.0
    extra = {"_real": np.full((5, 6), np.nan),
             "bayes_pred": [(1, 1.2, None, None), (2, 1.1, (4, 5), None)]}
    extra["_real"][4, 5] = 4.0
    merged = R.merge_results(base, extra)
    return (merged, R.count_ge_cutoff_curve(merged, "bayes_pred", 3.5),
            R.count_ge_cutoff_curve(merged, "apmf_pred", 3.5))


def case_seed_learning_band_and_matched_downgrade(P, R, d):
    ns = list(range(4, 16))
    rising = [0.48 + 0.002 * t for t in range(len(ns))]
    dirs = [os.path.join(d, f"seed{k}") for k in (1, 2, 3)]
    for k, sd in zip((1, 2, 3), dirs):
        os.makedirs(sd)
        errs = [0.49 + (0.001 if k == 2 else -0.001) * t
                for t in range(len(ns))]
        _write_digest(os.path.join(sd, "digest_stan.json.gz"), {"criteria": {
            "random": {"auc": 100.0, "err": errs, "n_rated": ns},
            "pred-variance": {"auc": 102.0, "err": errs, "n_rated": ns}}})
    seed_rows = P.aggregate_seed_checks(dirs, strict_active=True)
    with open(os.path.join(d, "parity_report_seeds.json"), "w") as f:
        json.dump({"checks": seed_rows}, f)
    res = {
        "_real": np.ones((4, 4)),
        "_kind": "stan",
        "stan_pred-variance": [
            (n, e, (0, 0) if t else None, None)
            for t, (n, e) in enumerate(zip(ns, rising))],
        "stan_random": [
            (n, e, (1, 1) if t else None, None)
            for t, (n, e) in enumerate(zip(ns, rising))],
    }
    with open(os.path.join(d, "results_stan.pkl"), "wb") as f:
        pickle.dump(res, f)
    dir_rows = P.check_experiment_dir(d, strict_active=True)
    with open(os.path.join(d, "parity_report_seeds.json"), "w") as f:
        json.dump({"checks": [{"check": "seed_learning",
                               "key": "stan:pred-variance", "status": "pass",
                               "detail": "..."}]}, f)
    return seed_rows, dir_rows, P._seed_passing_bands(d)


CASES = {name[len("case_"):]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_synthetic_case_matches_jax(tmp_path, name):
    outs = {}
    for pkg, P, R in (("jax", jparity, jresults),
                      ("torch", tparity, tresults)):
        d = tmp_path / pkg
        d.mkdir()
        outs[pkg] = CASES[name](P, R, str(d))
    assert_same(outs["torch"], outs["jax"])
