"""The port's PMF MAP model (amf_tpu_torch/models/pmf.py) against the JAX
package's, in float64 from identical parameters.

The deterministic pieces agree to rtol 1e-10 (the port uses the closed-form
gradient where JAX differentiates the value, so the sums differ in order
only). The fits agree on their accept/reject trajectory exactly and on the
final factors to rtol 1e-8; the 'lbfgs' fit type to 1e-8 (factors over 60
iterations, the log posterior over 500) and the 'mini-valid' one, on JAX's
replayed draws, to 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a worker)
from amf_tpu import types as jtypes
from amf_tpu.data import make_fake_data
from amf_tpu.models import pmf as jpmf
from amf_tpu_torch import convert
from amf_tpu_torch import types as ttypes
from amf_tpu_torch.models import pmf as tpmf

RTOL = 1e-10


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(5)
    real, known, _ = make_fake_data(num_users=12, num_items=9, rank=3,
                                    data_type=5, mask_type=0.4, rng=rng)
    jprob = jtypes.problem_from_dense(real, known, dtype=jnp.float64)
    jcfg = jpmf.PMFConfig(latent_d=3, subtract_mean=True)
    jst = jpmf.init_state(jax.random.PRNGKey(0), 12, 9, jcfg, jprob,
                          dtype=jnp.float64)
    tprob = convert.problem(jprob, device="cpu", dtype=torch.float64)
    tcfg = tpmf.PMFConfig(**jcfg._asdict())
    tst = convert.pmf_state(jst, device="cpu", dtype=torch.float64)
    return jprob, jcfg, jst, tprob, tcfg, tst


def test_convert_round_trip(case):
    """JAX state -> port (read by attribute) -> numpy dict -> port (read
    as a mapping) keeps every field exactly."""
    jprob, _, jst, tprob, _, tst = case
    back = convert.to_numpy(tst)
    for name in ("U", "V", "sigma_sq", "sigma_u_sq", "sigma_v_sq",
                 "mean_rating"):
        np.testing.assert_array_equal(back[name], np.asarray(getattr(jst, name)))
    again = convert.to_numpy(convert.pmf_state(back, device="cpu"))
    assert all(np.array_equal(again[k], back[k]) for k in back)
    np.testing.assert_array_equal(convert.to_numpy(tprob)["rated"],
                                  np.asarray(jprob.rated))
    chain = convert.chain_state({"U": back["U"], "V": back["V"],
                                 "mean_rating": back["mean_rating"]},
                                device="cpu")
    assert torch.equal(chain.U, tst.U)
    stats = convert.pred_stats({"mean": back["U"], "var": back["U"],
                                "prob_ge": back["V"], "bin_counts": None},
                               device="cpu", dtype=torch.float32)
    assert stats.bin_counts is None and stats.mean.dtype == torch.float32


def test_log_likelihood_gradient_and_quartic_match_jax(case):
    jprob, jcfg, jst, tprob, tcfg, tst = case
    np.testing.assert_allclose(
        float(tpmf.log_likelihood(tst, tprob, tcfg)),
        float(jpmf.log_likelihood(jst, jprob, jcfg)), rtol=RTOL)
    jg = jpmf.gradient(jst, jprob, jcfg)
    tg = tpmf.gradient(tst, tprob, tcfg)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL)
    want = jpmf._delta_poly(jst, jprob, jcfg, (jst.U, jst.V), jg)
    got = tpmf._delta_poly(tst, tprob, tcfg, (tst.U, tst.V), tg)
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), rtol=RTOL)


def test_lanes_match_jax_add_rating(case):
    """Each lane's patched cell equals JAX on problem.add_rating(i, j, v)."""
    jprob, jcfg, jst, tprob, tcfg, tst = case
    q = np.argwhere(np.asarray(jprob.queryable))[:3]
    vals = [1.0, 4.0, 2.5]
    lanes = ttypes.LaneCells(i=torch.as_tensor(q[:, 0]),
                             j=torch.as_tensor(q[:, 1]),
                             v=torch.tensor(vals, dtype=torch.float64))
    L = len(lanes)
    tl = tpmf.refresh_mean_rating(
        tpmf.PMFState(tst.U.expand(L, 12, 3), tst.V.expand(L, 9, 3),
                      tst.sigma_sq, tst.sigma_u_sq, tst.sigma_v_sq,
                      tst.mean_rating.expand(L)), tprob, lanes)
    ll = tpmf.log_likelihood(tl, tprob, tcfg, lanes=lanes)
    g = tpmf.gradient(tl, tprob, tcfg, lanes=lanes)
    poly = tpmf._delta_poly(tl, tprob, tcfg, (tl.U, tl.V), g, lanes)
    for l, ((i, j), v) in enumerate(zip(q, vals)):
        p2 = jprob.add_rating(int(i), int(j), v)
        s2 = jpmf.refresh_mean_rating(jst, p2)
        np.testing.assert_allclose(float(tl.mean_rating[l]),
                                   float(s2.mean_rating), rtol=RTOL)
        np.testing.assert_allclose(float(ll[l]),
                                   float(jpmf.log_likelihood(s2, p2, jcfg)),
                                   rtol=RTOL)
        jg = jpmf.gradient(s2, p2, jcfg)
        for a, b in zip(g, jg):
            np.testing.assert_allclose(a[l].numpy(), np.asarray(b), rtol=RTOL)
        want = jpmf._delta_poly(s2, p2, jcfg, (s2.U, s2.V), jg)
        for a, b in zip(poly, want):
            np.testing.assert_allclose(float(a[l]), float(b), rtol=RTOL)


@pytest.mark.parametrize("poly_ls", [False, True])
def test_fit_matches_jax_trajectory(case, poly_ls):
    jprob, jcfg, jst, tprob, tcfg, tst = case
    jfit, jinfo = jpmf.fit(jst, jprob, jcfg, poly_ls=poly_ls)
    tfit, tinfo = tpmf.fit(tst, tprob, tcfg, poly_ls=poly_ls)
    assert int(tinfo.n_iters) == int(jinfo.n_iters)
    assert int(tinfo.n_accepts) == int(jinfo.n_accepts)
    np.testing.assert_allclose(tfit.U.numpy(), np.asarray(jfit.U), rtol=1e-8)
    np.testing.assert_allclose(tfit.V.numpy(), np.asarray(jfit.V), rtol=1e-8)
    np.testing.assert_allclose(float(tinfo.final_value),
                               float(jinfo.final_value), rtol=1e-8)


def test_lane_fit_matches_jax_per_lane(case):
    """A tile of lane refits (budgeted, poly line search) in lockstep equals
    JAX's refit of each hypothesised problem on its own."""
    jprob, jcfg, jst, tprob, tcfg, tst = case
    jst, _ = jpmf.fit(jst, jprob, jcfg)
    tst = convert.pmf_state(jst, device="cpu", dtype=torch.float64)
    q = np.argwhere(np.asarray(jprob.queryable))[[0, 4]]
    vals = [5.0, 0.0]
    lanes = ttypes.LaneCells(i=torch.as_tensor(q[:, 0]),
                             j=torch.as_tensor(q[:, 1]),
                             v=torch.tensor(vals, dtype=torch.float64))
    tl = tpmf.refresh_mean_rating(
        tpmf.PMFState(tst.U.expand(2, 12, 3), tst.V.expand(2, 9, 3),
                      tst.sigma_sq, tst.sigma_u_sq, tst.sigma_v_sq,
                      tst.mean_rating.expand(2)), tprob, lanes)
    tfit, tinfo = tpmf.fit(tl, tprob, tcfg, max_steps=40, poly_ls=True,
                           lanes=lanes)
    for l, ((i, j), v) in enumerate(zip(q, vals)):
        p2 = jprob.add_rating(int(i), int(j), v)
        s2 = jpmf.refresh_mean_rating(jst, p2)
        jfit, jinfo = jpmf.fit(s2, p2, jcfg, max_steps=40, poly_ls=True)
        assert int(tinfo.n_iters[l]) == int(jinfo.n_iters)
        assert int(tinfo.n_accepts[l]) == int(jinfo.n_accepts)
        np.testing.assert_allclose(tfit.U[l].numpy(), np.asarray(jfit.U),
                                   rtol=1e-8)
        np.testing.assert_allclose(tfit.V[l].numpy(), np.asarray(jfit.V),
                                   rtol=1e-8)


def test_do_fit_batch_and_unported_fit_types(case):
    jprob, jcfg, jst, tprob, tcfg, tst = case
    got = tpmf.do_fit(tst, tprob, tcfg, fit_type=tpmf.parse_fit_type("batch"))
    want = jpmf.do_fit(jst, jprob, jcfg, fit_type=("batch",))
    np.testing.assert_allclose(got.U.numpy(), np.asarray(want.U), rtol=1e-8)
    np.testing.assert_allclose(
        float(tpmf.rmse(got, tprob, tcfg, tprob.R_obs, on=tprob.rated)),
        float(jpmf.rmse(want, jprob, jcfg, jprob.R_obs, on=jprob.rated)),
        rtol=1e-8)
    with pytest.raises(ValueError, match="unknown fit type"):
        tpmf.do_fit(tst, tprob, tcfg, fit_type=("nope",))


def test_lbfgs_fit_type_matches_jax(case):
    """'lbfgs' through both dispatchers: the closed-form gradient on the
    lane-batched L-BFGS against autodiff on JAX's. The MAP objective is flat
    along rotations (U R, V R), where each iteration amplifies the two
    sides' roundings, so U and V are held to 1e-8 over 60 iterations, and
    at the default 500 the log posterior to 1e-10."""
    jprob, jcfg, jst, tprob, tcfg, tst = case
    fit_type = tpmf.parse_fit_type("lbfgs,60")
    got = tpmf.do_fit(tst, tprob, tcfg, fit_type=fit_type)
    want = jpmf.do_fit(jst, jprob, jcfg, fit_type=fit_type)
    for name in ("U", "V"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-8, atol=1e-8)
    got = tpmf.do_fit(tst, tprob, tcfg, fit_type=("lbfgs",))
    want = jpmf.do_fit(jst, jprob, jcfg, fit_type=("lbfgs",))
    np.testing.assert_allclose(
        float(tpmf.log_likelihood(got, tprob, tcfg)),
        float(jpmf.log_likelihood(want, jprob, jcfg)), rtol=1e-10)


class _JaxMiniBatchNoise(tpmf.MiniBatchNoise):
    """The draws of the JAX package's 'mini-valid' fit from ``key``: the
    host validation subset from the first split, then one permutation an
    epoch (amf_tpu/models/pmf.py:562-584)."""

    def __init__(self, key):
        self.kv, self.key = jax.random.split(key)

    def valid_subset(self, rated_idx, size):
        seed = np.asarray(jax.random.key_data(self.kv)).ravel()[-1]
        return np.random.default_rng(seed).choice(rated_idx, size=size,
                                                  replace=False)

    def permutation(self, cap):
        self.key, kshuf = jax.random.split(self.key)
        return torch.as_tensor(np.array(jax.random.permutation(kshuf, cap)))


@pytest.mark.parametrize("batch_size", [20, 7])
def test_mini_valid_fit_type_matches_jax(case, batch_size):
    """'mini-valid' with JAX's permutations and validation cells replayed:
    the same epochs, every batch stepping (at 7 cells many batches hold no
    training cell and take the prior's step), U and V to 1e-10."""
    jprob, jcfg, jst, tprob, tcfg, tst = case
    key = jax.random.PRNGKey(5)
    fit_type = ("mini-valid", batch_size, 6, 0.05)
    want = jpmf.do_fit(jst, jprob, jcfg, fit_type=fit_type, key=key)
    got = tpmf.do_fit(tst, tprob, tcfg, fit_type=fit_type,
                      generator=_JaxMiniBatchNoise(key))
    for name in ("U", "V"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-10, atol=1e-10)
    assert not np.allclose(got.U.numpy(), tst.U.numpy())


def test_mini_valid_draws_from_a_generator(case):
    """On the default noise source the fit depends on the generator's seed
    alone, and leaves the caller's state untouched."""
    _, _, _, tprob, tcfg, tst = case
    U0 = tst.U.clone()

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return tpmf.do_fit(tst, tprob, tcfg, fit_type=("mini-valid", 16, 5),
                           generator=gen)

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a.U, b.U) and not torch.equal(a.U, c.U)
    assert torch.equal(tst.U, U0)
