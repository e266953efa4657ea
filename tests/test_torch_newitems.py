"""The port's cold-start BPMF and its CLI (amf_tpu_torch/models/newitems.py,
run/bpmf_newitems.py) against the JAX package's, in float64 on the CPU.

On 6 users x 4 new items (and 5 old), d = 2: the phase-2 log posterior
agrees to 1e-12 in both density variants, lanes on their own cells
included; with JAX's key stream replayed (tests/torch_nuts_replay.py) one
transition agrees to 1e-10, a chain through warmup to 1e-8, and the
lookahead scores, every (candidate, value) lane on its JAX key, to 1e-8;
phase 1 is the NUTS BPMF chain on the old columns. The CLI caches phase 1, resumes
from its checkpoint and reports picks in the original column ids.
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
from amf_tpu.data import make_fake_data, make_new_items_split
from amf_tpu.models import bpmf_hmc as jh
from amf_tpu.models import newitems as jn
from amf_tpu.models import sample_stats as jss
from amf_tpu.utils.rng import lane_keys
from amf_tpu_torch import convert
from amf_tpu_torch.data.loaders import save_npz_schema
from amf_tpu_torch.models import bpmf_hmc as th
from amf_tpu_torch.models import newitems as tn
from amf_tpu_torch.models import sample_stats as tss
from amf_tpu_torch.types import LaneCells

N, M, N_NEW, D = 6, 9, 4, 2
DEPTH = 5
RTOL, TRANSITION_TOL, CHAIN_TOL = 1e-12, 1e-10, 1e-8
WARMUP, DRAWS = 20, 8
LA_SAMPS, LA_WARMUP = 5, 5


def _close(got, want, tol):
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1.0))


@pytest.fixture(scope="module")
def case():
    """A cold-start split (4 of 9 columns new, their known cells a row and
    column cover) and a phase-2 state from random fixed factors."""
    rng = np.random.default_rng(11)
    real, _, vals = make_fake_data(num_users=N, num_items=M, rank=2,
                                   data_type=2, mask_type=0.6, rng=rng)
    # ratings 1..3: every cell knowable (0 marks an unknowable cell)
    real, vals = real + 1.0, tuple(v + 1.0 for v in vals)
    split = make_new_items_split(real, n_new=N_NEW, know_all_old=True,
                                 rng=rng)
    is_new = split["_is_new_item"]
    jprob = jtypes.problem_from_dense(real, split["_known"],
                                      dtype=jnp.float64)
    tprob = convert.problem(jprob, device="cpu", dtype=torch.float64)
    jnew = jn_problem(jprob, is_new)
    tnew = tn.new_item_problem(tprob, is_new)
    U_fixed = rng.normal(size=(N, D))
    V_fixed = rng.normal(size=(M - N_NEW, D))
    jcfg = jh.HMCConfig(latent_d=D, max_depth=DEPTH)
    tcfg = th.HMCConfig(latent_d=D, max_depth=DEPTH)
    mr = float(np.asarray(jprob.mean_rating()))
    jst = jn.init_state(jnew, jnp.asarray(U_fixed), jnp.asarray(V_fixed),
                        jcfg, mr)
    tst = convert.newitems_state(jst, device="cpu", dtype=torch.float64)
    return dict(real=real, vals=vals, split=split, is_new=is_new, jprob=jprob,
                tprob=tprob, jnew=jnew, tnew=tnew, jcfg=jcfg, tcfg=tcfg,
                jst=jst, tst=tst, rng=rng,
                s=jn.NewItemsShapes(N, N_NEW, D))


def jn_problem(jprob, is_new):
    cols = np.nonzero(is_new)[0]
    return jtypes.Problem(R_obs=jprob.R_obs[:, cols],
                          rated=jprob.rated[:, cols],
                          queryable=jprob.queryable[:, cols],
                          test=jprob.test[:, cols])


@pytest.mark.parametrize("model", ["w0identity", "bpmf"])
def test_log_posterior_matches_jax(case, model):
    """One vector and a batch of lanes, each on its own added cell."""
    s = case["s"]
    ts = tn.NewItemsShapes(*s)
    assert (ts.n_tri, ts.dim) == (s.n_tri, s.dim)
    q = case["rng"].normal(size=(3, s.dim)) * 0.4
    jcfg = case["jcfg"]._replace(model=model)
    tcfg = case["tcfg"]._replace(model=model)
    st = case["tst"]
    args = (st.U_fixed, st.V_fixed, st.mean_rating, tcfg, ts)
    jargs = (case["jst"].U_fixed, case["jst"].V_fixed,
             case["jst"].mean_rating, jcfg, s)
    want = [float(jn.log_posterior(jnp.asarray(qi), case["jnew"], *jargs))
            for qi in q]
    _close(tn.log_posterior(torch.tensor(q), case["tnew"], *args), want,
           RTOL)
    _close(tn.log_posterior(torch.tensor(q[0]), case["tnew"], *args),
           want[0], RTOL)
    cells = np.argwhere(np.asarray(case["jnew"].queryable))[:3]
    v = np.array([1.0, 0.0, 2.0])
    lanes = LaneCells(i=torch.tensor(cells[:, 0]), j=torch.tensor(cells[:, 1]),
                      v=torch.tensor(v))
    want = [float(jn.log_posterior(
        jnp.asarray(qi), case["jnew"].add_rating(int(i), int(j), vi), *jargs))
        for qi, (i, j), vi in zip(q, cells, v)]
    _close(tn.log_posterior(torch.tensor(q), case["tnew"], *args,
                            cells=lanes), want, RTOL)


def test_straightforward_raises(case):
    st = case["tst"]
    with pytest.raises(ValueError, match="straightforward"):
        tn.log_posterior(st.mode_q, case["tnew"], st.U_fixed, st.V_fixed,
                         st.mean_rating,
                         case["tcfg"]._replace(model="straightforward"),
                         tn.NewItemsShapes(*case["s"]))


def test_state_converts_and_invalidates(case):
    back = convert.to_numpy(case["tst"])
    for name in ("mode_q", "mode_lp", "mean_rating", "U_fixed", "V_fixed"):
        np.testing.assert_array_equal(back[name],
                                      np.asarray(getattr(case["jst"], name)))
    st = tn.invalidate_mode(tn.NewItemsState(**{
        k: torch.tensor(v) for k, v in back.items()}))
    assert float(st.mode_lp) == -np.inf


@pytest.mark.parametrize("warmup,draws,tol", [(0, 1, TRANSITION_TOL),
                                               (WARMUP, DRAWS, CHAIN_TOL)])
def test_samples_match_jax(case, warmup, draws, tol):
    """One transition (no warmup: the step-size search, then one draw) and
    a chain through warmup, on JAX's key stream; the mode and the
    statistics of the draws follow."""
    key = jax.random.PRNGKey(7)
    jst, jsamps = jax.jit(lambda k, st: jn.samples(
        k, st, case["jnew"], case["jcfg"], draws, warmup))(key, case["jst"])
    noise = rp.ReplayNoise(key[None], case["s"].dim, DEPTH, warmup, draws)
    tst, tsamps = tn.samples(0, case["tst"], case["tnew"], case["tcfg"],
                             draws, warmup, noise=noise)
    for name in ("V", "U", "lp__"):
        _close(tsamps[name], jsamps[name], tol)
    _close(tst.mode_q, jst.mode_q, tol)
    _close(tst.mode_lp, jst.mode_lp, tol)
    if warmup:
        mr = case["tst"].mean_rating
        got = tss.prediction_stats(tsamps["U"], tsamps["V"], mr, True)
        want = jss.prediction_stats(jsamps["U"], jsamps["V"],
                                    case["jst"].mean_rating, True)
        _close(got.var, want.var, tol)


def test_initial_full_fit_is_the_old_columns_chain(case):
    """Phase 1 is the NUTS BPMF chain (held to JAX's in
    tests/test_torch_bpmf_hmc.py) on the old columns from the zero init:
    its posterior means and the old columns' mean rating."""
    got = tn.initial_full_fit(4, case["tprob"], case["is_new"], case["tcfg"],
                              num_samps=4, warmup=6)
    old = np.nonzero(~case["is_new"])[0]
    prob_old = tn._columns(case["tprob"], old)
    st = th.init_state(prob_old, case["tcfg"], dtype=torch.float64)
    st, samps = th.samples(4, st, prob_old, case["tcfg"], 4, 6)
    assert got[0].shape == (N, D) and got[1].shape == (M - N_NEW, D)
    for g, w in zip(got, (samps["U"].mean(0), samps["V"].mean(0),
                          st.mean_rating)):
        assert torch.equal(g, w)
    _close(got[2], case["real"][:, old][case["split"]["_known"][:, old]]
           .mean(), RTOL)


@pytest.fixture(scope="module")
def base(case):
    """A short base chain of the port's and its statistics in both
    packages' types."""
    from amf_tpu.models.bpmf_gibbs import PredStats

    tst, samps = tn.samples(3, case["tst"], case["tnew"], case["tcfg"], 10,
                            10)
    tbase = tss.prediction_stats(
        samps["U"], samps["V"], tst.mean_rating, True,
        value_bounds=tuple(th_bounds(case["vals"])))
    jst = jn.NewItemsState(**{k: jnp.asarray(v)
                              for k, v in convert.to_numpy(tst).items()})
    jbase = PredStats(*(None if x is None else jnp.asarray(x.numpy())
                        for x in tbase))
    return dict(tst=tst, jst=jst, tbase=tbase, jbase=jbase)


def th_bounds(vals):
    from amf_tpu_torch.types import rating_bounds

    return rating_bounds(vals)


def test_lookahead_scores_match_jax(case, base):
    """exp-variance's total variance over the first 8 cells of the 6 x 4
    new-item block (3 rating values, 5 draws after 5): the queryable ones
    on their JAX lane keys (utils.rng.lane_keys) in tiles of 4 candidates,
    the rest NaN. (exp-entropy-est's matrix-normal fit needs more draws
    than cells; at this size both packages give NaN.)"""
    stat = "total-variance"
    key = jax.random.PRNGKey(4)
    dim = case["s"].dim
    cand = np.arange(8)
    want = np.asarray(jax.jit(lambda k, st, b: jn.lookahead_scores(
        k, st, case["jnew"], case["jcfg"], b, case["vals"], stat=stat,
        num_samps=LA_SAMPS, warmup=LA_WARMUP,
        cand=jnp.asarray(cand, jnp.int32), n_base_samples=10))(
            key, base["jst"], base["jbase"]))

    def lane_noise(c, n_vals):
        keys = lane_keys(key, jnp.asarray(c.numpy(), jnp.int32), n_vals)
        return rp.ReplayNoise(keys.reshape(-1, 2), dim, DEPTH, LA_WARMUP,
                              LA_SAMPS)

    got = tn.lookahead_scores(
        0, base["tst"], case["tnew"], case["tcfg"], base["tbase"],
        case["vals"], stat=stat, num_samps=LA_SAMPS, warmup=LA_WARMUP,
        cand=torch.tensor(cand), n_base_samples=10, candidate_tile=4,
        lane_noise=lane_noise).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    finite = np.isfinite(want)
    assert finite.sum() == int(case["tnew"].queryable.flatten()[:8].sum())
    _close(got[finite], want[finite], CHAIN_TOL)


def test_lookahead_scores_do_not_depend_on_the_tile(case, base):
    kw = dict(num_samps=3, warmup=3, n_base_samples=10,
              cand=torch.nonzero(case["tnew"].queryable.flatten())[:3, 0])
    args = (5, base["tst"], case["tnew"], case["tcfg"], base["tbase"],
            case["vals"])
    whole = tn.lookahead_scores(*args, **kw)
    tiled = tn.lookahead_scores(*args, candidate_tile=1, **kw)
    np.testing.assert_array_equal(whole.numpy(), tiled.numpy())


@pytest.fixture(scope="module")
def data_file(tmp_path_factory, case):
    path = str(tmp_path_factory.mktemp("torch_newitems_cli") / "data.npz")
    save_npz_schema(path, dict(case["split"],
                               _rating_vals=np.asarray(case["vals"], float)))
    return path


def test_bpmf_newitems_cli_caches_and_resumes(data_file, case, tmp_path,
                                              capsys):
    """Phase 1 is written to --initial-fit-file and read back by the second
    run, which resumes from the checkpoint (stamped with the sampler era)
    and reports picks in the original columns."""
    from amf_tpu_torch.mcmc.nuts import SAMPLER_ERA
    from amf_tpu_torch.run import bpmf_newitems

    out, ck = str(tmp_path / "r.pkl"), str(tmp_path / "ck.pkl")
    fit = str(tmp_path / "fit.npz")
    argv = ["--load-data", data_file, "-D", "2", "-s", "2", "-S", "6",
            "-W", "6", "--initial-fit-samps", "6", "--lookahead-samps", "3",
            "--lookahead-warmup", "3", "--device", "cpu",
            "--initial-fit-file", fit, "--checkpoint", ck,
            "--save-results", out, "exp-variance", "random"]
    first = bpmf_newitems.main(argv)
    assert "running initial full fit" in capsys.readouterr().out
    with open(out, "rb") as f:
        res = pickle.load(f)
    assert res["_kind"] == "stan" and res["_sampler_era"] == SAMPLER_ERA
    new_cols = set(np.nonzero(case["is_new"])[0])
    for k in ("exp-variance", "random"):
        assert len(res[k]) == 2 and res[k][1][2][1] in new_cols
    with open(ck, "rb") as f:
        assert pickle.load(f)["_era"] == SAMPLER_ERA
    again = bpmf_newitems.main(argv[:-3] + ["--no-save-results", "random"])
    said = capsys.readouterr().out
    assert "loaded initial fit" in said and "resumed at step 1" in said
    assert [r[:3] for r in again["random"]] == [r[:3] for r in first["random"]]
