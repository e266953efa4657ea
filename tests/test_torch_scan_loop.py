"""The port's scan sweep (amf_tpu_torch/active/scan_loop.py) on the CPU.

``run_scan`` against the JAX package's ``run_scan`` driven by matched
deterministic callables (a fixed score map, a pool exhausted before the
last step, a pool with no finite score, a NaN on the pool): the same picks,
counts of rated cells, errors (to 1e-12) and ``valid`` flags, the refit
run on every step. The families' sweeps (``run_active_scan`` for vn and mn
with a direct and a lookahead criterion, ``run_gibbs_scan`` with
``pred-variance`` and a small-pool ``exp-variance``, ``run_stan_scan``)
against the port's own host loops from the same initial state and seeds:
the same records (picks and counts equal, errors to 1e-12, the recorded
criterion maps equal where the host loop recorded one), and
``record_evals`` NaN exactly off the then-queryable pool. The ``--scan``
paths of the three CLIs write the host paths' layout and records.
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a worker)
from amf_tpu import types as jtypes
from amf_tpu.active import scan_loop as jscan
from amf_tpu_torch import convert, types
from amf_tpu_torch.active import scan_loop
from amf_tpu_torch.active.gibbs_loop import run_active_gibbs
from amf_tpu_torch.active.loop import run_active_pmf
from amf_tpu_torch.active.stan_loop import run_active_stan
from amf_tpu_torch.data.loaders import save_npz_schema
from amf_tpu_torch.data.synthetic import make_fake_data

TOL = 1e-12


def _close(got, want, tol=TOL):
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    scale = np.abs(want[np.isfinite(want)]).max(initial=1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.fixture(scope="module")
def stub_case():
    rng = np.random.default_rng(0)
    real = rng.integers(1, 6, size=(4, 5)).astype(np.float64)
    known = rng.random((4, 5)) < 0.5
    score = rng.normal(size=(4, 5))
    jprob = jtypes.problem_from_dense(real, known, dtype=jnp.float64)
    tprob = convert.problem(jprob, device="cpu", dtype=torch.float64)
    return dict(real=real, score=score, jprob=jprob, tprob=tprob)


def _stub_sweeps(c, score_map, steps, maximize):
    """The JAX and the port sweep of one fixed score map; the state counts
    the refits and enters the error with the rated cells' sum."""
    sm = np.asarray(score_map, dtype=np.float64)

    def jerr(st, prob):
        return jnp.sum(jnp.where(prob.rated, prob.R_obs, 0.0)) + 0.5 * st

    def terr(st, prob):
        return torch.where(prob.rated, prob.R_obs, 0.0).sum() + 0.5 * st

    want, jst = jscan.run_scan(
        c["jprob"], jnp.asarray(c["real"]), jnp.float64(0.0),
        lambda st, prob, k: jnp.asarray(sm) + 0.0 * st,
        lambda st, prob, k: st + 1.0, jerr, steps, jax.random.PRNGKey(0),
        maximize, record_evals=True)
    got, tst = scan_loop.run_scan(
        c["tprob"], c["real"], torch.tensor(0.0, dtype=torch.float64),
        lambda st, prob, k: torch.as_tensor(sm) + 0.0 * st,
        lambda st, prob, k: st + 1.0, terr, steps, 0, maximize,
        record_evals=True)
    assert float(tst) == float(jst) == steps  # a refit every step
    return got, want


def _same_sweep(got, want):
    for name in ("n_rated", "picks_i", "picks_j", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    _close(got.rmse, want.rmse)
    _close(got.rmse0, want.rmse0)
    np.testing.assert_array_equal(np.isnan(got.evals.numpy()),
                                  np.isnan(np.asarray(want.evals)))
    _close(got.evals, want.evals)


@pytest.mark.parametrize("maximize", [True, False])
def test_run_scan_matches_jax_on_a_fixed_map(stub_case, maximize):
    n_q = int(stub_case["tprob"].queryable.sum())
    got, want = _stub_sweeps(stub_case, stub_case["score"], n_q - 2, maximize)
    _same_sweep(got, want)
    assert bool(got.valid.all())
    picks = list(zip(got.picks_i.tolist(), got.picks_j.tolist()))
    assert len(set(picks)) == len(picks)


def test_run_scan_matches_jax_after_the_pool_is_exhausted(stub_case):
    n_q = int(stub_case["tprob"].queryable.sum())
    got, want = _stub_sweeps(stub_case, stub_case["score"], n_q + 3, True)
    _same_sweep(got, want)
    assert got.valid.tolist() == [True] * n_q + [False] * 3
    assert got.n_rated[-1] == got.n_rated[n_q - 1]
    recs = scan_loop.result_to_records(stub_case["tprob"], got)
    assert len(recs) == n_q + 1 and recs[0][2] is None


@pytest.mark.parametrize("fill,maximize", [(np.inf, False), (-np.inf, True),
                                           (np.nan, True), (np.nan, False)])
def test_run_scan_matches_jax_with_no_finite_score(stub_case, fill, maximize):
    got, want = _stub_sweeps(stub_case, np.full((4, 5), fill), 3, maximize)
    _same_sweep(got, want)


def test_run_scan_matches_jax_with_a_nan_on_the_pool(stub_case):
    score = stub_case["score"].copy()
    q = stub_case["tprob"].queryable.numpy()
    i, j = np.argwhere(q)[2]
    score[i, j] = np.nan
    for maximize in (True, False):
        got, want = _stub_sweeps(stub_case, score, 3, maximize)
        _same_sweep(got, want)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    real, known, vals = make_fake_data(
        num_users=6, num_items=6, rank=2, data_type=5, mask_type=0.4,
        rng=rng)
    prob = types.problem_from_dense(real, known, dtype=torch.float64,
                                    device="cpu")
    return dict(real=real, known=known, vals=tuple(vals), prob=prob)


def _same_records(host, res, prob):
    """The sweep's records are the host loop's; its maps NaN off the
    then-queryable pool and equal to the host's where it recorded one."""
    recs = scan_loop.result_to_records(prob, res)
    assert len(recs) == len(host)
    assert [r[0] for r in recs] == [r[0] for r in host]
    assert [r[2] for r in recs] == [r[2] for r in host]
    _close([r[1] for r in recs], [r[1] for r in host])
    q = prob.queryable.numpy().copy()
    for rec, h in zip(recs[1:], host[1:]):
        ev = rec[3]
        assert np.isnan(ev[~q]).all() and not np.isnan(ev[q]).any()
        if h[3] is not None:
            np.testing.assert_array_equal(ev, h[3])
        q[rec[2]] = False


def test_gibbs_scan_matches_the_host_loop(case):
    kw = dict(latent_d=2, rating_values=case["vals"], num_samps=12,
              lookahead_samps=4, device="cpu")
    for kname, prob in (("pred-variance", case["prob"]),
                        ("exp-variance", _small_pool(case["prob"], 4))):
        host = run_active_gibbs(prob, case["real"], [kname], steps=4, seed=1,
                                **kw)[kname]
        res, (pst, stats) = scan_loop.run_gibbs_scan(
            prob, case["real"], kname, 3, seed=1, record_evals=True, **kw)
        _same_records(host, res, prob)
        assert stats.var.shape == prob.shape


def _small_pool(prob, k):
    q = prob.queryable.clone()
    keep = torch.nonzero(q.flatten())[:k, 0]
    pool = torch.zeros_like(q.flatten())
    pool[keep] = True
    return dataclasses.replace(prob, queryable=pool.view_as(q))


@pytest.mark.parametrize("model,kname", [("vn", "pred-variance"),
                                         ("vn", "total-variance"),
                                         ("mn", "pred-variance"),
                                         ("mn", "total-variance-approx")])
def test_active_scan_matches_the_host_loop(case, model, kname):
    kw = dict(latent_d=1, rating_values=case["vals"], lookahead_budget=30,
              device="cpu")
    prob = _small_pool(case["prob"], 6)
    host = run_active_pmf(prob, case["real"], [kname], steps=3, seed=2,
                          model=model, **kw)[kname]
    res, pst = scan_loop.run_active_scan(prob, case["real"], kname, 2,
                                         seed=2, model=model,
                                         record_evals=True, **kw)
    _same_records(host, res, prob)
    assert pst.U.shape == (6, 1)


def test_stan_scan_matches_the_host_loop(case):
    kw = dict(latent_d=2, rating_values=case["vals"], num_samps=10, warmup=5,
              device="cpu")
    host = run_active_stan(case["prob"], case["real"], ["pred-variance"],
                           steps=3, seed=3, **kw)["pred-variance"]
    res, _ = scan_loop.run_stan_scan(case["prob"], case["real"],
                                     "pred-variance", 2, seed=3,
                                     record_evals=True, **kw)
    _same_records(host, res, case["prob"])


def test_family_sweeps_refuse_unknown_criteria(case):
    with pytest.raises(ValueError, match="unknown Gibbs criterion"):
        scan_loop.run_gibbs_scan(case["prob"], case["real"], "nope", 1,
                                 device="cpu")
    with pytest.raises(ValueError, match="unknown stan criterion"):
        scan_loop.run_stan_scan(case["prob"], case["real"], "nope", 1,
                                device="cpu")
    with pytest.raises(ValueError, match="unknown criterion"):
        scan_loop.run_active_scan(case["prob"], case["real"], "nope", 1,
                                  device="cpu")


@pytest.fixture(scope="module")
def data_file(tmp_path_factory, case):
    path = str(tmp_path_factory.mktemp("torch_scan_cli") / "data.npz")
    save_npz_schema(path, {"_real": case["real"], "_known": case["known"],
                           "_rating_vals": np.asarray(case["vals"])})
    return path


@pytest.mark.parametrize("cli,extra", [
    ("bayes_pmf", ["-D", "2", "-S", "8", "--lookahead-samps", "3",
                   "pred-variance", "random"]),
    ("active_pmf", ["-D", "1", "pred-variance", "random"]),
    ("bpmf", ["-D", "2", "-S", "8", "-W", "4", "pred-variance", "random"]),
])
def test_cli_scan_writes_the_host_layout(data_file, tmp_path, cli, extra):
    import importlib

    mod = importlib.import_module(f"amf_tpu_torch.run.{cli}")
    out = {}
    for path, flags in (("host", []), ("scan", ["--scan", "--scan-evals"])):
        fn = str(tmp_path / f"{path}.pkl")
        mod.main(["--load-data", data_file, "--device", "cpu", "-s", "3",
                  "--no-verbose", "--save-results", fn] + flags + extra)
        with open(fn, "rb") as f:
            out[path] = pickle.load(f)
    host, scan = out["host"], out["scan"]
    assert set(scan) == set(host)
    assert scan["_kind"] == host["_kind"] and scan["_args"]["scan"]
    np.testing.assert_array_equal(scan["_ratings"], host["_ratings"])
    assert scan["_rating_vals"] == host["_rating_vals"]
    for k in extra[-2:]:
        assert [r[:3] for r in scan[k]] == [r[:3] for r in host[k]], k
        assert all(r[3] is not None for r in scan[k][1:])


def test_cli_scan_refuses_fit_sigmas_and_warm_adapt(data_file):
    from amf_tpu_torch.run import active_pmf, bpmf

    with pytest.raises(SystemExit):
        active_pmf.main(["--load-data", data_file, "--device", "cpu",
                         "--scan", "--fit-sigmas", "pred-variance"])
    with pytest.raises(SystemExit):
        bpmf.main(["--load-data", data_file, "--device", "cpu", "--scan",
                   "--warm-adapt", "pred-variance"])
