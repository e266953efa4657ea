"""The port's result tools held to the JAX package's on the same inputs:
``analysis/results`` (``KEY_NAMES`` from the port's own registries; loading
committed results pickles and digests, RMSE curves, AUCs, first-step maps
and their Kendall-tau, all to 1e-12) and the text CLIs ``plot_results``,
``plot_aucs`` and ``compare_firsts`` (the same printed text, capsys), with
the plot flags run once each (PNGs into ``tmp_path``). Everything reads
committed files of ``experiments/`` and writes only under ``tmp_path``.
"""

import os

import numpy as np
import pytest

import torch_threads  # noqa: F401  (one torch thread a worker)
from amf_tpu.analysis import results as jresults
from amf_tpu.run import compare_firsts as jcompare
from amf_tpu.run import plot_aucs as jplot_aucs
from amf_tpu.run import plot_results as jplot_results
from amf_tpu_torch.analysis import results as tresults
from amf_tpu_torch.run import compare_firsts as tcompare
from amf_tpu_torch.run import plot_aucs as tplot_aucs
from amf_tpu_torch.run import plot_results as tplot_results

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D2 = os.path.join(ROOT, "experiments", "10x10_discrete2_d2")
DB = os.path.join(ROOT, "experiments", "drugbank-94x425")
TOL = 1e-12
SOURCES = [os.path.join(D2, "results_apmf.pkl")] + [
    os.path.join(D2, f"digest_{s}.json.gz")
    for s in ("apmf", "bayes", "mmmf", "rc", "stan", "stan_s400")] + [
    os.path.join(DB, f"digest_{s}.json.gz") for s in ("mmmf", "stan")]


def test_key_names_match_jax():
    assert list(tresults.KEY_NAMES.items()) == list(jresults.KEY_NAMES.items())
    assert tresults.KINDS == jresults.KINDS


def _crit_keys(res):
    return sorted(k for k, v in res.items()
                  if not k.startswith("_") and isinstance(v, list))


def _same_records(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        assert g[0] == w[0] and g[2] == w[2]
        assert g[1] == pytest.approx(w[1], rel=TOL, abs=TOL)
        for a, b in zip(g[3:], w[3:]):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("path", SOURCES,
                         ids=[os.path.relpath(p, ROOT) for p in SOURCES])
def test_load_curves_and_aucs_match_jax(path):
    got, want = tresults.load_results(path), jresults.load_results(path)
    assert sorted(got) == sorted(want)
    assert tresults.guess_kind(got) == jresults.guess_kind(want)
    np.testing.assert_array_equal(np.asarray(got["_real"]),
                                  np.asarray(want["_real"]))
    keys = _crit_keys(want)
    assert keys and _crit_keys(got) == keys
    for k in keys:
        _same_records(got[k], want[k])
        for a, b in zip(tresults.rmse_curve(got[k]),
                        jresults.rmse_curve(want[k])):
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
        fa, fb = (tresults.first_step_evals(got[k]),
                  jresults.first_step_evals(want[k]))
        assert (fa is None) == (fb is None)
        if fa is not None:
            np.testing.assert_allclose(fa, fb, rtol=TOL, atol=TOL)
    ta, ja = tresults.aucs(got), jresults.aucs(want)
    assert sorted(ta) == sorted(ja)
    for k in ja:
        assert ta[k] == pytest.approx(ja[k], rel=TOL, abs=TOL)


@pytest.mark.parametrize("names", [
    ("results_apmf.pkl", "digest_bayes.json.gz", "digest_stan.json.gz"),
    ("digest_apmf.json.gz", "results_apmf.pkl"),
])
def test_first_step_maps_and_taus_match_jax(names):
    paths = [os.path.join(D2, n) for n in names]
    got = [tresults.load_results(p) for p in paths]
    want = [jresults.load_results(p) for p in paths]
    keys = sorted({k for r in want for k in _crit_keys(r)})
    tm, jm = (tresults.first_step_maps(got, keys),
              jresults.first_step_maps(want, keys))
    assert sorted(tm) == sorted(jm) and len(jm) >= 2
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=TOL, atol=TOL)
    tt, jt = (tresults.compare_first_steps(got, keys),
              jresults.compare_first_steps(want, keys))
    assert sorted(tt) == sorted(jt) and jt
    for pair in jt:
        assert tt[pair] == pytest.approx(jt[pair], rel=TOL, abs=TOL,
                                         nan_ok=True)


def _printed(capsys, main, argv):
    main(argv)
    return capsys.readouterr().out


TEXT_RUNS = {
    "plot_results --aucs": (
        tplot_results.main, jplot_results.main,
        [os.path.join(D2, "results_apmf.pkl"),
         os.path.join(D2, "digest_bayes.json.gz"), "--aucs"]),
    "plot_results merged kinds": (
        tplot_results.main, jplot_results.main,
        [os.path.join(D2, f"digest_{s}.json.gz")
         for s in ("mmmf", "rc", "stan")] + ["--aucs"]),
    "plot_aucs": (
        tplot_aucs.main, jplot_aucs.main,
        [os.path.join(D2, "results_apmf.pkl")] + [
            os.path.join(D2, f"seed{k}", "digest_apmf.json.gz")
            for k in (1, 2, 3, 4)]),
    "plot_aucs --vs-random": (
        tplot_aucs.main, jplot_aucs.main,
        [os.path.join(D2, f"seed{k}", "digest_bayes.json.gz")
         for k in (1, 2, 3, 4)] + ["--vs-random"]),
    "compare_firsts": (
        tcompare.main, jcompare.main,
        [os.path.join(D2, "results_apmf.pkl"),
         os.path.join(D2, "digest_bayes.json.gz"),
         os.path.join(D2, "digest_stan.json.gz")]),
}


@pytest.mark.parametrize("name", sorted(TEXT_RUNS))
def test_text_cli_prints_what_jax_prints(capsys, name):
    tmain, jmain, argv = TEXT_RUNS[name]
    got = _printed(capsys, tmain, argv)
    want = _printed(capsys, jmain, argv)
    assert got == want
    assert got.count("\n") >= 3


def test_plot_flags_write_the_files_jax_writes(capsys, tmp_path):
    """The plot paths (matplotlib, imported only for them): every flag of
    plot_results, plot_aucs --outdir and compare_firsts' --grid-key mode
    write the files JAX's write and print the same lines."""
    apmf = os.path.join(D2, "results_apmf.pkl")
    seeds = [os.path.join(D2, f"seed{k}") for k in (1, 2, 3, 4)]
    runs = [
        ("plot_results", [apmf, os.path.join(D2, "digest_bayes.json.gz"),
                          "--rmses", "--criteria-firsts",
                          "--criteria-over-time", "--max-steps-plotted", "4",
                          "--ge-cutoff", "3.5", "--outdir", "{out}"]),
        ("plot_aucs", [apmf, "--outdir", "{out}"]),
        ("compare_firsts", seeds + [D2, "--grid-key", "pred-variance",
                                    "--names", "bayes", "stan",
                                    "--outdir", "{out}"]),
    ]
    mods = {"plot_results": (tplot_results, jplot_results),
            "plot_aucs": (tplot_aucs, jplot_aucs),
            "compare_firsts": (tcompare, jcompare)}
    for name, argv in runs:
        outs = {}
        for pkg, mod in zip(("torch", "jax"), mods[name]):
            out = str(tmp_path / pkg / name)
            text = _printed(capsys, mod.main,
                            [a.replace("{out}", out) for a in argv])
            outs[pkg] = (text.replace(out, "<out>"), sorted(os.listdir(out)))
        assert outs["torch"] == outs["jax"], name
        assert any(f.endswith(".png") for f in outs["torch"][1]), name
