"""The port's Gibbs active loop and CLI (amf_tpu_torch/active, run) against
the JAX package's: the same results schema, picks inside the pool."""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a worker)
from amf_tpu import types as jtypes
from amf_tpu.active import gibbs_loop as jloop
from amf_tpu.data import make_fake_data
from amf_tpu_torch import types as ttypes
from amf_tpu_torch.active import gibbs_loop as tloop
from amf_tpu_torch.data.loaders import save_npz_schema

KEYS = ["exp-variance", "pred-variance"]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(4)
    real, known, vals = make_fake_data(num_users=6, num_items=5, rank=2,
                                       data_type=5, mask_type=0.4, rng=rng)
    return real, known, vals


def _check_records(recs, n_steps, pool, shape):
    assert len(recs) == n_steps
    n0, err0, pick0, ev0 = recs[0]
    assert isinstance(n0, int) and np.isfinite(err0)
    assert pick0 is None and ev0 is None
    picks = []
    for k, (n_rated, err, pick, evals) in enumerate(recs[1:], start=1):
        assert n_rated == n0 + k and np.isfinite(err)
        i, j = pick
        assert isinstance(i, int) and isinstance(j, int) and pool[i, j]
        assert isinstance(evals, np.ndarray) and evals.shape == shape
        picks.append(pick)
    assert len(set(picks)) == len(picks)


def test_run_active_gibbs_matches_jax_schema(data):
    """Both criteria through the port; the JAX loop runs pred-variance only
    (its records have the same schema for every criterion, and compiling
    its lookahead would double the test's time)."""
    real, known, vals = data
    kw = dict(latent_d=2, rating_values=vals, num_samps=12,
              lookahead_samps=4, lookahead_tile=8, steps=3, seed=0)
    jres = jloop.run_active_gibbs(
        jtypes.problem_from_dense(real, known, dtype=jnp.float64), real,
        ["pred-variance"], dtype=jnp.float64, **kw)
    tprob = ttypes.problem_from_dense(real, known, dtype=torch.float64,
                                      device="cpu")
    tres = tloop.run_active_gibbs(tprob, real, KEYS, device="cpu", **kw)
    assert set(tres) == set(jres) | set(KEYS)
    np.testing.assert_array_equal(tres["_real"], jres["_real"])
    np.testing.assert_array_equal(tres["_ratings"], jres["_ratings"])
    assert tres["_rating_vals"] == jres["_rating_vals"]
    pool = tprob.queryable.numpy()
    _check_records(jres["pred-variance"], 3, pool, real.shape)
    for k in KEYS:
        _check_records(tres[k], 3, pool, real.shape)
        assert ([r[0] for r in tres[k]]
                == [r[0] for r in jres["pred-variance"]])


@pytest.mark.parametrize("fit_type", [("mini-valid", 10, 4), ("lbfgs", 50)])
def test_run_active_gibbs_takes_every_fit_type(data, fit_type):
    """The loop's initial fit runs the 'mini-valid' and 'lbfgs' fit types
    on the CPU ('mini-valid' from a generator seeded by the step), and the
    same seed gives the same records."""
    real, known, vals = data
    prob = ttypes.problem_from_dense(real, known, dtype=torch.float64,
                                     device="cpu")
    kw = dict(latent_d=2, rating_values=vals, num_samps=6, steps=2, seed=1,
              fit_type=fit_type, device="cpu")
    first = tloop.run_active_gibbs(prob, real, ["pred-variance"], **kw)
    _check_records(first["pred-variance"], 2, prob.queryable.numpy(),
                   real.shape)
    again = tloop.run_active_gibbs(prob, real, ["pred-variance"], **kw)
    assert ([r[:3] for r in again["pred-variance"]]
            == [r[:3] for r in first["pred-variance"]])


@pytest.fixture(scope="module")
def data_file(tmp_path_factory, data):
    real, known, vals = data
    path = str(tmp_path_factory.mktemp("torch_cli") / "data.npz")
    save_npz_schema(path, {"_real": real, "_known": known,
                           "_rating_vals": np.asarray(vals, dtype=float)})
    return path


def test_bayes_pmf_cli(data_file, tmp_path):
    from amf_tpu_torch.run import bayes_pmf

    out = str(tmp_path / "g.pkl")
    bayes_pmf.main([
        "--load-data", data_file, "-D", "2", "-s", "2", "-S", "12",
        "--lookahead-samps", "4", "--device", "cpu", "--no-verbose",
        "--save-results", out, "pred-variance", "exp-variance",
    ])
    with open(out, "rb") as f:
        res = pickle.load(f)
    assert res["_kind"] == "bayes"
    assert len(res["pred-variance"]) == 2 and len(res["exp-variance"]) == 2
    assert res["_rating_vals"] == tuple(float(v) for v in range(6))
