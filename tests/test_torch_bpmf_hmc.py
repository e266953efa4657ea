"""The port's NUTS BPMF model (amf_tpu_torch/models/bpmf_hmc.py) and its
sample statistics (models/sample_stats.py) against the JAX package's, in
float64 on the CPU.

The log posterior and its gradient agree to 1e-10 relative in all three
density variants; the parameter layout and init exactly; a chain through a
mass switch, with JAX's key stream replayed (tests/torch_nuts_replay.py),
gives the same draws, mode and adaptation to 1e-8; the statistics of those
draws agree to 1e-10.
"""

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
from amf_tpu.models import sample_stats as jss
from amf_tpu_torch import convert
from amf_tpu_torch.models import bpmf_hmc as th
from amf_tpu_torch.models import sample_stats as tss
from amf_tpu_torch.types import LaneCells

N, M, D = 6, 5, 2
RTOL = 1e-10
CHAIN_TOL = 1e-8
DEPTH = 5
# a warmup whose windowed schedule switches the mass once (at step 35)
WARMUP, DRAWS = 40, 10


def _close(got, want, tol=RTOL):
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1.0))


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(7)
    real, known, vals = make_fake_data(num_users=N, num_items=M, rank=2,
                                       data_type=5, mask_type=0.5, rng=rng)
    jprob = jtypes.problem_from_dense(real, known, dtype=jnp.float64)
    tprob = convert.problem(jprob, device="cpu", dtype=torch.float64)
    return real, vals, jprob, tprob, rng


@pytest.fixture(scope="module")
def chain(case):
    """One chain of both packages through a mass switch from the same key:
    the JAX key stream replayed into the port."""
    _, _, jprob, tprob, _ = case
    jcfg = jh.HMCConfig(latent_d=D, max_depth=DEPTH)
    tcfg = th.HMCConfig(latent_d=D, max_depth=DEPTH)
    key = jax.random.PRNGKey(3)
    # factors away from the saddle at zero, as a MAP warm start puts them
    init = np.random.default_rng(5)
    jst0 = jh.init_state(jprob, jcfg, U=jnp.asarray(init.normal(size=(N, D))),
                         V=jnp.asarray(init.normal(size=(M, D))),
                         dtype=jnp.float64)
    jst, jsamps = jh.samples(key, jst0, jprob, jcfg, DRAWS, WARMUP,
                             carry_adapt=True)
    noise = rp.ReplayNoise(key[None], jh.ParamShapes(N, M, D).dim, DEPTH,
                           WARMUP, DRAWS)
    tst0 = convert.hmc_state(jst0, device="cpu", dtype=torch.float64)
    tst, tsamps = th.samples(0, tst0, tprob, tcfg, DRAWS, WARMUP,
                             carry_adapt=True, noise=noise)
    return jst, jsamps, tst, tsamps


def test_pack_unpack_and_init_params_match_jax(case):
    rng = case[4]
    s = jh.ParamShapes(4, 3, 2)
    ts = th.ParamShapes(4, 3, 2)
    assert (ts.n_tri, ts.dim) == (s.n_tri, s.dim)
    q = rng.normal(size=(3, s.dim))
    for row in q:
        want = jh.unpack(jnp.asarray(row), s)
        got = th.unpack(torch.tensor(row), ts)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    got = th.unpack(torch.tensor(q), ts)
    np.testing.assert_array_equal(th.pack(got).numpy(), q)
    assert got["U"].shape == (3, 4, 2)
    U = rng.normal(size=(4, 2))
    want = jh.pack(jh.init_params(s, jnp.float64, U=jnp.asarray(U)))
    got = th.pack(th.init_params(ts, torch.float64, U=torch.tensor(U)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert th.pack(th.init_params(ts, torch.float64, device="cpu")).abs().sum() == 0


def test_tri_from_matches_jax(case):
    rng = case[4]
    for d in (1, 2, 4):
        z = rng.normal(size=max(d * (d - 1) // 2, 1))
        c = np.abs(rng.normal(size=d)) + 0.1
        want = jh._tri_from(jnp.asarray(z), jnp.asarray(c), d)
        got = th._tri_from(torch.tensor(z), torch.tensor(c), d)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("model", ["w0identity", "bpmf", "straightforward",
                                   "general-args"])
def test_log_posterior_and_gradient_match_jax(case, model):
    """Value and gradient (jax.grad against torch autograd) of three
    lanes; "general-args" gives bpmf.stan's w_0, mu_0 and nu_0 as
    arguments."""
    _, _, jprob, tprob, rng = case
    kw_j, kw_t = {}, {}
    variant = model
    if model == "general-args":
        variant = "w0identity"
        a = rng.normal(size=(D, D))
        w0 = np.linalg.cholesky(a @ a.T + np.eye(D))
        mu0 = rng.normal(size=D)
        kw_j = dict(w0_chol=jnp.asarray(w0), mu_0=jnp.asarray(mu0), nu_0=3.5)
        kw_t = dict(w0_chol=torch.tensor(w0), mu_0=torch.tensor(mu0), nu_0=3.5)
    jcfg = jh.HMCConfig(latent_d=D, model=variant)
    tcfg = th.HMCConfig(latent_d=D, model=variant)
    s = jh.ParamShapes(N, M, D)
    q = rng.normal(size=(3, s.dim)) * 0.3
    mr = jprob.mean_rating()

    def f(x):
        return jh.log_posterior(x, jprob, mr, jcfg, s, **kw_j)

    want_v = np.asarray(jax.jit(jax.vmap(f))(jnp.asarray(q)))
    want_g = np.asarray(jax.jit(jax.vmap(jax.grad(f)))(jnp.asarray(q)))
    x = torch.tensor(q, requires_grad=True)
    got = th.log_posterior(x, tprob, tprob.mean_rating(), tcfg,
                           th.ParamShapes(N, M, D), **kw_t)
    (g,) = torch.autograd.grad(got.sum(), x)
    _close(got.detach(), want_v)
    _close(g, want_g)
    # one vector without a lane axis
    _close(th.log_posterior(torch.tensor(q[0]), tprob, tprob.mean_rating(),
                            tcfg, th.ParamShapes(N, M, D), **kw_t),
           want_v[0])


def test_lane_cells_give_each_lane_its_added_rating(case):
    """A lane on the base problem plus its cell has the log posterior of
    the problem with that rating added (a queryable cell and, overwritten,
    a rated one)."""
    _, _, _, tprob, rng = case
    cfg = th.HMCConfig(latent_d=D)
    s = th.ParamShapes(N, M, D)
    qi, qj = np.nonzero(tprob.queryable.numpy())
    ri, rj = np.nonzero(tprob.rated.numpy())
    cells = LaneCells(i=torch.tensor([qi[0], qi[1], ri[0]]),
                      j=torch.tensor([qj[0], qj[1], rj[0]]),
                      v=torch.tensor([4.0, 1.0, 2.5], dtype=torch.float64))
    q = torch.tensor(rng.normal(size=(3, s.dim)) * 0.3)
    mr = cells.mean_rating(tprob)
    got = th.log_posterior(q, tprob, mr, cfg, s, cells=cells)
    for lane in range(3):
        p2 = tprob.add_rating(int(cells.i[lane]), int(cells.j[lane]),
                              float(cells.v[lane]))
        want = th.log_posterior(q[lane], p2, p2.mean_rating(), cfg, s)
        _close(got[lane], want)


def test_init_state_and_invalidate_mode_match_jax(case):
    _, _, jprob, tprob, rng = case
    cfg = jh.HMCConfig(latent_d=D)
    U, V = rng.normal(size=(N, D)), rng.normal(size=(M, D))
    want = jh.init_state(jprob, cfg, U=jnp.asarray(U), V=jnp.asarray(V),
                         dtype=jnp.float64)
    got = th.init_state(tprob, th.HMCConfig(latent_d=D), U=torch.tensor(U),
                        V=torch.tensor(V), dtype=torch.float64)
    for k, v in convert.to_numpy(got).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(want, k)))
    i, j = np.nonzero(tprob.queryable.numpy())
    jp2 = jprob.add_rating(int(i[0]), int(j[0]), 5.0)
    tp2 = tprob.add_rating(int(i[0]), int(j[0]), 5.0)
    got = th.invalidate_mode(got, tp2)
    want = jh.invalidate_mode(want, jp2)
    assert float(got.mode_lp) == -np.inf
    _close(got.mean_rating, want.mean_rating)


def test_chain_through_mass_switch_matches_jax(chain):
    jst, jsamps, tst, tsamps = chain
    for k in ("U", "V", "lp__"):
        _close(tsamps[k], jsamps[k], CHAIN_TOL)
    for k, v in convert.to_numpy(tst).items():
        _close(v, getattr(jst, k), CHAIN_TOL)
    # the warmup switched the mass (a carried inverse mass away from 1)
    assert np.abs(convert.to_numpy(tst)["adapt_inv_mass"] - 1).max() > 1e-3


def test_hmc_state_converts_both_ways(chain):
    jst = chain[0]
    st = convert.hmc_state(jst, device="cpu")
    back = convert.to_numpy(st)
    for k in back:
        np.testing.assert_array_equal(back[k], np.asarray(getattr(jst, k)))
    again = convert.hmc_state(back, device="cpu", dtype=torch.float32)
    assert again.mode_q.dtype == torch.float32


def test_chains_are_lanes_pooled_chain_major(case):
    """chains = 2 runs the two chains as lanes of one run: the same draws
    as each chain alone on its own noise, pooled chain-major, and the mean
    of their adaptations."""
    _, _, _, tprob, _ = case
    cfg = th.HMCConfig(latent_d=D, max_depth=DEPTH)
    st0 = th.init_state(tprob, cfg, dtype=torch.float64)
    dim = th.ParamShapes(N, M, D).dim
    keys = jax.random.split(jax.random.PRNGKey(9), 2)
    both = th.samples(0, st0, tprob, cfg, 4, 12, chains=2, carry_adapt=True,
                      noise=rp.ReplayNoise(keys, dim, DEPTH, 12, 4))
    one = [th.samples(0, st0, tprob, cfg, 4, 12, carry_adapt=True,
                      noise=rp.ReplayNoise(k[None], dim, DEPTH, 12, 4))
           for k in keys]
    for k in ("U", "V", "lp__"):
        _close(both[1][k], torch.cat([o[1][k] for o in one]))
    _close(both[0].adapt_eps, (one[0][0].adapt_eps + one[1][0].adapt_eps) / 2)
    best = max(one, key=lambda o: float(o[0].mode_lp))[0]
    _close(both[0].mode_q, best.mode_q)


def test_prediction_stats_match_jax(case, chain):
    _, vals, _, _, _ = case
    jst, jsamps, tst, tsamps = chain
    bounds = tuple(jtypes.rating_bounds(vals))
    kw = dict(cutoffs=(3.5, 0.5), value_bounds=bounds)
    want = jss.prediction_stats(jsamps["U"], jsamps["V"], jst.mean_rating,
                                True, **kw)
    got = tss.prediction_stats(tsamps["U"], tsamps["V"], tst.mean_rating,
                               True, **kw)
    for g, w in zip(got, want):
        _close(g, w)
    # lanes: a stack of two draw sets gives each its own statistics
    lanes = tss.prediction_stats(
        torch.stack([tsamps["U"], tsamps["U"].flip(0)]),
        torch.stack([tsamps["V"], tsamps["V"].flip(0)]),
        torch.stack([tst.mean_rating, tst.mean_rating + 1]), False)
    alone = tss.prediction_stats(tsamps["U"], tsamps["V"], 0.0, False)
    _close(lanes.var[0], alone.var)
    _close(lanes.mean[1], alone.mean)


def test_matrix_normal_mle_and_entropy_match_jax(chain):
    jst, jsamps, tst, tsamps = chain
    want = jss.matrix_normal_mle_from_factors(
        jsamps["U"], jsamps["V"], jst.mean_rating, True)
    got = tss.matrix_normal_mle_from_factors(
        tsamps["U"], tsamps["V"], tst.mean_rating, True)
    for g, w in zip(got, want):
        _close(g, w)
    _close(tss.entropy_est_from_factors(tsamps["U"], tsamps["V"],
                                        tst.mean_rating, True),
           jss.entropy_est_from_factors(jsamps["U"], jsamps["V"],
                                        jst.mean_rating, True))


def test_samples_take_noise_or_a_chain_mesh_not_both(case):
    """Replayed noise covers every chain, so it cannot be split over ranks
    (the sharded chains are held to chains as lanes in
    test_torch_parallel.py)."""
    tprob = case[3]
    cfg = th.HMCConfig(latent_d=D)
    st = th.init_state(tprob, cfg, dtype=torch.float64)
    with pytest.raises(ValueError, match="not both"):
        th.samples(0, st, tprob, cfg, 4, chain_mesh=object(), noise=object())
