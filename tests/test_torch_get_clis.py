"""The port's ``get_samples`` and ``get_criteria`` CLIs on the CPU.

Their random draws come from ``torch.Generator``s, which cannot replay the
JAX package's keys, so they are held by layout and by statistics:

* ``get_samples`` writes the JAX CLI's ``npz`` keys and shapes, and on the
  same 8 x 8 problem the posterior-mean prediction of its 2,000 draws (the
  CLI's default) lies within 0.25 (root mean square over the cells, rating
  units) of the JAX CLI's and correlates with it above 0.95; every
  ``--fit`` type runs;
* ``get_criteria`` writes the two results pickles of the JAX CLI's layout,
  which load through ``analysis.results.load_results``, and prints the
  pairwise Kendall-tau of their first-step maps.
"""

import os

import numpy as np
import pytest

import torch_threads  # noqa: F401  (one torch thread a worker)
from amf_tpu_torch.analysis import results as R
from amf_tpu_torch.data.loaders import save_npz_schema
from amf_tpu_torch.data.synthetic import make_fake_data
from amf_tpu_torch.run import get_criteria, get_samples

S = 2000  # the CLI's default


@pytest.fixture(scope="module")
def data_file(tmp_path_factory):
    rng = np.random.default_rng(5)
    real, known, vals = make_fake_data(
        num_users=8, num_items=8, rank=2, data_type=5, mask_type=0.45,
        rng=rng)
    path = str(tmp_path_factory.mktemp("samples") / "data.npz")
    save_npz_schema(path, {"_real": real, "_known": known,
                           "_rating_vals": np.asarray(vals, dtype=float)})
    return path


def _posterior_mean(f):
    return (np.einsum("snd,smd->nm", f["U"], f["V"]) / f["U"].shape[0]
            + float(f["mean_rating"]))


def test_get_samples_matches_jax_by_layout_and_posterior_mean(
        data_file, tmp_path):
    from amf_tpu.run import get_samples as jget_samples

    argv = ["--load-data", data_file, "-D", "2"]
    got_path, want_path = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    get_samples.main(argv + ["--device", "cpu", "--out", got_path])
    jget_samples.main(argv + ["--out", want_path])
    got, want = np.load(got_path), np.load(want_path)
    assert sorted(got.files) == sorted(want.files) == [
        "U", "V", "mean_rating"]
    for k in want.files:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
    assert got["U"].shape == (S, 8, 2) and got["V"].shape == (S, 8, 2)
    assert float(got["mean_rating"]) == pytest.approx(
        float(want["mean_rating"]), abs=1e-12)
    a, b = _posterior_mean(got), _posterior_mean(want)
    assert np.isfinite(a).all()
    assert np.sqrt(np.mean((a - b) ** 2)) < 0.25
    assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.95


# the mini-valid learning rate 0.01: at the default 0.2 SGD on this tiny
# problem diverges to NaN in float32, the JAX CLI's as the port's
@pytest.mark.parametrize("fit", ["lbfgs", "mini-valid,10,5,0.01", "batch"])
def test_get_samples_runs_every_fit_type(data_file, tmp_path, fit):
    out = str(tmp_path / "s.npz")
    get_samples.main(["--load-data", data_file, "-D", "2", "-S", "8",
                      "--fit", fit, "--float32", "--device", "cpu",
                      "--out", out])
    f = np.load(out)
    assert f["U"].shape == (8, 8, 2) and f["U"].dtype == np.float32
    assert np.isfinite(f["U"]).all() and np.isfinite(f["V"]).all()


def test_get_criteria_writes_loadable_results(tmp_path, capsys):
    outdir = str(tmp_path / "crit")
    get_criteria.main(["-N", "6", "-M", "6", "-s", "2", "--device", "cpu",
                       "--outdir", outdir])
    text = capsys.readouterr().out
    loaded = {}
    for kind, keys in (("apmf", ["pred-variance", "total-variance"]),
                       ("bayes", ["pred-variance", "prob-ge-3.5"])):
        res = R.load_results(os.path.join(outdir, f"results_{kind}.pkl"))
        assert res["_kind"] == kind and R.guess_kind(res) == kind
        names = [k if kind == "apmf" else f"bayes_{k}" for k in keys]
        assert sorted(k for k in res if not k.startswith("_")) == sorted(
            names)
        assert res["_real"].shape == (6, 6)
        for k in names:
            recs = res[k]
            # -s 2: the initial record and one query
            assert len(recs) == 2 and recs[0][2] is None
            assert all(np.isfinite(r[1]) for r in recs)
            ev = R.first_step_evals(recs)
            assert ev.shape == (6, 6) and np.isfinite(ev).any()
        loaded[kind] = res
    taus = R.compare_first_steps(
        list(loaded.values()),
        [k for r in loaded.values() for k in r if not k.startswith("_")])
    assert len(taus) == 6  # four maps, two of them pred-variance
    lines = [ln for ln in text.splitlines() if ln.startswith("kendall-tau")]
    assert len(lines) == len(taus)
