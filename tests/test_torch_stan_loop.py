"""The port's NUTS BPMF lookahead, active loop and CLI (amf_tpu_torch/
models/bpmf_hmc.lookahead_scores, active/stan_loop.py, run/bpmf.py).

lookahead_scores agrees with the JAX package's to 1e-8 for both
statistics (exp-variance's total variance, exp-entropy-est's matrix-normal
entropy), with JAX's per-lane keys replayed into each lane
(tests/torch_nuts_replay.py); the loop and the CLI keep the JAX package's
results schema, pick inside the pool and record finite errors.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_nuts_replay as rp
import torch_threads  # noqa: F401  (one torch thread a worker)
from amf_tpu import types as jtypes
from amf_tpu.data import make_fake_data
from amf_tpu.models import bpmf_hmc as jh
from amf_tpu.utils.rng import lane_keys
from amf_tpu_torch import convert
from amf_tpu_torch import types as ttypes
from amf_tpu_torch.data.loaders import save_npz_schema
from amf_tpu_torch.models import bpmf_hmc as th
from amf_tpu_torch.models import sample_stats as tss

N, M, D = 6, 5, 2
DEPTH = 5
TOL = 1e-8
LA_SAMPS, LA_WARMUP = 6, 6


@pytest.fixture(scope="module")
def base():
    """A base chain (the port's, from a random state) on a 6 x 5 problem
    with 3 rating values and its statistics, in both packages' types."""
    from amf_tpu.models.bpmf_gibbs import PredStats

    rng = np.random.default_rng(2)
    real, known, vals = make_fake_data(num_users=N, num_items=M, rank=2,
                                       data_type=2, mask_type=0.5, rng=rng)
    jprob = jtypes.problem_from_dense(real, known, dtype=jnp.float64)
    tprob = convert.problem(jprob, device="cpu", dtype=torch.float64)
    tcfg = th.HMCConfig(latent_d=D, max_depth=DEPTH)
    st0 = th.init_state(tprob, tcfg, U=torch.tensor(rng.normal(size=(N, D))),
                        V=torch.tensor(rng.normal(size=(M, D))),
                        dtype=torch.float64)
    tst, samps = th.samples(1, st0, tprob, tcfg, 10, 10)
    tbase = tss.prediction_stats(samps["U"], samps["V"], tst.mean_rating,
                                 True, value_bounds=tuple(
                                     ttypes.rating_bounds(vals)))
    jst = jh.BPMFState(**{k: jnp.asarray(v)
                          for k, v in convert.to_numpy(tst).items()})
    jbase = PredStats(*(None if x is None else jnp.asarray(x.numpy())
                        for x in tbase))
    cand = np.nonzero(np.asarray(jprob.queryable).ravel())[0][:4]
    return dict(real=real, known=known, vals=vals, jprob=jprob, tprob=tprob,
                jcfg=jh.HMCConfig(latent_d=D, max_depth=DEPTH), tcfg=tcfg,
                jst=jst, tst=tst, jbase=jbase, tbase=tbase, cand=cand)


@pytest.mark.parametrize("stat", ["total-variance", "entropy-est"])
def test_lookahead_scores_match_jax(base, stat):
    """4 candidates x 3 rating values, num_samps 6: every lane's chain on
    its JAX key (utils.rng.lane_keys), in tiles of 3 candidates."""
    key = jax.random.PRNGKey(4)
    dim = jh.ParamShapes(N, M, D).dim
    want = jh.lookahead_scores(
        key, base["jst"], base["jprob"], base["jcfg"], base["jbase"],
        base["vals"], stat=stat, num_samps=LA_SAMPS, warmup=LA_WARMUP,
        cand=jnp.asarray(base["cand"], jnp.int32), n_base_samples=10)

    def lane_noise(cand, n_vals):
        keys = lane_keys(key, jnp.asarray(cand.numpy(), jnp.int32), n_vals)
        return rp.ReplayNoise(keys.reshape(-1, 2), dim, DEPTH, LA_WARMUP,
                              LA_SAMPS)

    got = th.lookahead_scores(
        0, base["tst"], base["tprob"], base["tcfg"], base["tbase"],
        base["vals"], stat=stat, num_samps=LA_SAMPS, warmup=LA_WARMUP,
        cand=torch.tensor(base["cand"]), n_base_samples=10,
        candidate_tile=3, lane_noise=lane_noise)
    want = np.asarray(want)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL,
                               atol=TOL * np.abs(want).max())


def test_lookahead_scores_do_not_depend_on_the_tile(base):
    """Default lane streams are keyed by the global candidate index: one
    tile or tiles of one candidate give the same scores; the continuous
    (trapezoid-grid) weighting scores finite too, and a cell off the pool
    scores NaN."""
    kw = dict(num_samps=4, warmup=4, n_base_samples=10)
    cand = torch.tensor(base["cand"][:3])
    args = (5, base["tst"], base["tprob"], base["tcfg"], base["tbase"])
    whole = th.lookahead_scores(*args, base["vals"], cand=cand, **kw)
    tiled = th.lookahead_scores(*args, base["vals"], cand=cand,
                                candidate_tile=1, **kw)
    np.testing.assert_array_equal(whole.numpy(), tiled.numpy())
    cont = th.lookahead_scores(*args, (), cand=cand, num_integration_pts=3,
                               **kw)
    assert torch.isfinite(cont).all()
    rated = int(np.nonzero(base["known"].ravel())[0][0])
    off = th.lookahead_scores(*args, base["vals"], cand=torch.tensor([rated]),
                              **kw)
    assert torch.isnan(off).all()


def _check_records(recs, n_steps, pool, shape):
    assert len(recs) == n_steps
    n0, err0, pick0, ev0 = recs[0]
    assert isinstance(n0, int) and np.isfinite(err0)
    assert pick0 is None and ev0 is None
    picks = []
    for k, (n_rated, err, pick, evals) in enumerate(recs[1:], start=1):
        assert n_rated == n0 + k and np.isfinite(err)
        i, j = pick
        assert pool[i, j]
        assert isinstance(evals, np.ndarray) and evals.shape == shape
        picks.append(pick)
    assert len(set(picks)) == len(picks)


LOOP_KW = dict(latent_d=D, num_samps=8, warmup=8, lookahead_samps=4,
               lookahead_warmup=4, steps=3, seed=0,
               cfg=th.HMCConfig(latent_d=D, max_depth=DEPTH))


def test_run_active_stan_records(base):
    from amf_tpu_torch.active.stan_loop import KEYS, run_active_stan

    keys = ["pred-variance", "exp-variance", "exp-entropy-est", "prob-ge-0",
            "random"]
    # a pool of 5 cells keeps the lookahead criteria's tiles small
    pool = base["tprob"].queryable.numpy().copy()
    pool.ravel()[np.nonzero(pool.ravel())[0][5:]] = False
    prob = ttypes.problem_from_dense(base["real"], base["known"],
                                     queryable=pool, dtype=torch.float64,
                                     device="cpu")
    res = run_active_stan(prob, base["real"], keys,
                          rating_values=base["vals"], lookahead_tile=4,
                          device="cpu", **LOOP_KW)
    assert set(res) == {"_real", "_ratings", "_rating_vals"} | set(keys)
    assert res["_rating_vals"] == tuple(sorted(base["vals"]))
    np.testing.assert_array_equal(res["_ratings"],
                                  jtypes.ratings_array(base["jprob"]))
    pool = prob.queryable.numpy()
    for k in keys:
        _check_records(res[k], 3, pool, base["real"].shape)
        assert res[k][0][:2] == res[keys[0]][0][:2]
    assert set(KEYS) == {"random", "pred-variance", "exp-variance",
                         "exp-entropy-est", "pred", "prob-ge-3.5",
                         "prob-ge-.5", "prob-ge-0"}


def test_run_active_stan_binary_chains_and_warm_adapt(base):
    """Binary data records misclassification; two chains pool; a carried
    adaptation runs the shorter warm warmup."""
    from amf_tpu_torch.active.stan_loop import run_active_stan

    real = np.where(base["real"] > 1, 1.0, -1.0)
    prob = ttypes.problem_from_dense(real, base["known"],
                                     dtype=torch.float64, device="cpu")
    res = run_active_stan(prob, real, ["pred"], chains=2, binary_acc=True,
                          warm_adapt=True, warm_warmup=4, model_init_map=False,
                          device="cpu", **LOOP_KW)
    errs = [r[1] for r in res["pred"]]
    assert all(0.0 <= e <= 1.0 for e in errs)


def test_run_active_stan_refuses_unknown_criteria(base):
    from amf_tpu_torch.active.stan_loop import run_active_stan

    prob = ttypes.problem_from_dense(base["real"], base["known"],
                                     dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="unknown stan criterion"):
        run_active_stan(prob, base["real"], ["nope"], device="cpu")


@pytest.fixture(scope="module")
def data_file(tmp_path_factory, base):
    path = str(tmp_path_factory.mktemp("torch_bpmf_cli") / "data.npz")
    save_npz_schema(path, {"_real": base["real"], "_known": base["known"],
                           "_rating_vals": np.asarray(base["vals"], float)})
    return path


def test_bpmf_cli_on_the_cpu_with_checkpoint(data_file, tmp_path, capsys):
    """The CLI runs with --device cpu, writes its results and a checkpoint
    stamped with the sampler era; a second run resumes from it."""
    from amf_tpu_torch.mcmc.nuts import SAMPLER_ERA
    from amf_tpu_torch.run import bpmf

    out, ck = str(tmp_path / "r.pkl"), str(tmp_path / "ck.pkl")
    argv = ["--load-data", data_file, "-D", "2", "-s", "2", "-S", "6",
            "-W", "6", "--lookahead-samps", "4", "--lookahead-warmup", "4",
            "--device", "cpu", "--checkpoint", ck, "--save-results", out,
            "--model-filename", "bpmf.stan", "pred-variance", "random"]
    first = bpmf.main(argv)
    with open(out, "rb") as f:
        res = pickle.load(f)
    assert res["_kind"] == "stan" and res["_sampler_era"] == SAMPLER_ERA
    assert all(len(res[k]) == 2 for k in ("pred-variance", "random"))
    with open(ck, "rb") as f:
        state = pickle.load(f)
    assert state["_era"] == SAMPLER_ERA and len(state["random"]) == 2
    capsys.readouterr()
    again = bpmf.main(argv[:-2] + ["--no-save-results", "random"])
    assert "resumed at step 1" in capsys.readouterr().out
    assert [r[:3] for r in again["random"]] == [r[:3] for r in first["random"]]
