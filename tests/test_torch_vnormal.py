"""The port's variational approximations (amf_tpu_torch/models/vnormal.py
and mnormal.py) against the JAX package's, in float64 from identical states.

The KL values and their (triangular-half) gradients agree to 1e-10
relative: the same einsums, autograd on both sides. The fits agree on
their accept/reject trajectory exactly and on the fitted state to 1e-8
relative, for both covariance parameterizations. A stack of lanes gives
each lane's own values.
"""

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a worker)
from amf_tpu_torch import convert
from amf_tpu_torch.models import mnormal as tmn
from amf_tpu_torch.models import pmf as tpmf
from amf_tpu_torch.models import vnormal as tvn

RTOL = 1e-10
FIT_RTOL = 1e-8
N, M, D = 5, 4, 2
K = (N + M) * D


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1.0))


@pytest.fixture(scope="module")
def case():
    """A fitted JAX PMF state on a 5 x 4 problem, a random VN approximation
    and a random-covariance MN one, and their port copies."""
    import jax
    import jax.numpy as jnp

    from amf_tpu import types as jtypes
    from amf_tpu.data import make_fake_data
    from amf_tpu.models import mnormal, pmf, vnormal

    rng = np.random.default_rng(0)
    real, known, _ = make_fake_data(num_users=N, num_items=M, rank=D,
                                    mask_type=0.4, data_type=5, rng=rng)
    jprob = jtypes.problem_from_dense(real, known, dtype=jnp.float64)
    jcfg = pmf.PMFConfig(latent_d=D, max_fit_steps=200)
    jst = pmf.init_state(jax.random.PRNGKey(0), N, M, jcfg, jprob,
                         dtype=jnp.float64)
    jst, _ = pmf.fit(jst, jprob, jcfg)
    vcfg = vnormal.VNConfig(latent_d=D, max_fit_steps=20)
    jvn = vnormal.initialize_approx(jax.random.PRNGKey(1), jst, vcfg)
    mcfg = mnormal.MNConfig(latent_d=D, max_fit_steps=20)
    jmn = mnormal.initialize_approx(jst, mcfg, key=jax.random.PRNGKey(2),
                                    random_cov=True)
    f64 = dict(device="cpu", dtype=torch.float64)
    return dict(
        jax=jax, jnp=jnp, vnormal=vnormal, mnormal=mnormal, jprob=jprob,
        jst=jst, vcfg=vcfg, jvn=jvn, mcfg=mcfg, jmn=jmn,
        prob=convert.problem(jprob, **f64), st=convert.pmf_state(jst, **f64),
        tvcfg=tvn.VNConfig(**vcfg._asdict()), vn=convert.vn_state(jvn, **f64),
        tmcfg=tmn.MNConfig(**mcfg._asdict()), mn=convert.mn_state(jmn, **f64))


def test_initialize_approx_from_injected_noise_matches_jax(case):
    """The JAX package's own (k, k) draw as the noise: the same state."""
    jax, jnp = case["jax"], case["jnp"]
    noise = jax.random.normal(jax.random.PRNGKey(1), (K, K), dtype=jnp.float64)
    got = tvn.initialize_approx(case["st"], case["tvcfg"],
                                noise=torch.as_tensor(np.array(noise)))
    _close(got.mean, case["jvn"].mean)
    _close(got.cov, case["jvn"].cov)
    mn = tmn.initialize_approx(case["st"], case["tmcfg"])
    want = case["mnormal"].initialize_approx(case["jst"], case["mcfg"])
    for f in ("mean", "cov_useritems", "cov_latents"):
        _close(getattr(mn, f), getattr(want, f))


def test_vn_kl_value_and_gradient_match_jax(case):
    jax, vnormal = case["jax"], case["vnormal"]
    jvn, jst, jprob, vcfg = case["jvn"], case["jst"], case["jprob"], case["vcfg"]
    f, (gm, gc) = jax.value_and_grad(
        lambda mu, c: vnormal.kl_divergence(jvn, jst, jprob, vcfg, mean=mu,
                                            cov=c), argnums=(0, 1))(
        jvn.mean, jvn.cov)
    got, (tgm, tgc) = tvn._value_and_grad(
        lambda t: tvn.kl_divergence(case["vn"], case["st"], case["prob"],
                                    case["tvcfg"], *t),
        (case["vn"].mean, case["vn"].cov))
    _close(float(got), float(f))
    _close(tgm, gm)
    _close(tvn._tri_symmetrize(tgc), vnormal._tri_symmetrize(gc))


def test_mn_kl_value_and_gradient_match_jax(case):
    jax, mnormal = case["jax"], case["mnormal"]
    jmn, jst, jprob, mcfg = case["jmn"], case["jst"], case["jprob"], case["mcfg"]
    f, grads = jax.value_and_grad(
        lambda a, b, c: mnormal.kl_divergence(
            jmn, jst, jprob, mcfg, mean=a, cov_useritems=b, cov_latents=c),
        argnums=(0, 1, 2))(jmn.mean, jmn.cov_useritems, jmn.cov_latents)
    mn = case["mn"]
    got, tgrads = tvn._value_and_grad(
        lambda t: tmn.kl_divergence(mn, case["st"], case["prob"],
                                    case["tmcfg"], *t),
        (mn.mean, mn.cov_useritems, mn.cov_latents))
    _close(float(got), float(f))
    _close(tgrads[0], grads[0])
    for g, w in zip(tgrads[1:], grads[1:]):
        _close(tvn._tri_symmetrize(g), mnormal._tri_symmetrize(w))


def test_lanes_give_each_lane_its_own_kl(case):
    """Two lanes (the state and a shifted copy) on their own problems: each
    lane's KL is the single-state KL of that lane."""
    vn, st, cfg = case["vn"], case["st"], case["tvcfg"]
    lanes = tvn.VNState(mean=torch.stack([vn.mean, vn.mean + 0.1]),
                        cov=torch.stack([vn.cov, 2.0 * vn.cov]))
    from amf_tpu_torch.types import LaneCells

    q = torch.nonzero(case["prob"].queryable)[:2]
    cells = LaneCells(i=q[:, 0], j=q[:, 1],
                      v=torch.tensor([1.0, 4.0], dtype=torch.float64))
    probs = cells.problems(case["prob"])
    got = tvn.kl_divergence(lanes, st, probs, cfg)
    for lane in range(2):
        one = tvn.VNState(mean=lanes.mean[lane], cov=lanes.cov[lane])
        prob = case["prob"].add_rating(int(q[lane, 0]), int(q[lane, 1]),
                                       float(cells.v[lane]))
        _close(float(got[lane]), float(tvn.kl_divergence(one, st, prob, cfg)))


@pytest.mark.parametrize("cov_param", ["psd-project", "chol"])
def test_vn_fit_normal_matches_jax(case, cov_param):
    jcfg = case["vcfg"]._replace(cov_param=cov_param)
    want, winfo = case["vnormal"].fit_normal(case["jvn"], case["jst"],
                                             case["jprob"], jcfg)
    got, info = tvn.fit_normal(case["vn"], case["st"], case["prob"],
                               tvn.VNConfig(**jcfg._asdict()))
    assert int(info.n_iters) == int(winfo.n_iters)
    assert int(info.n_accepts) == int(winfo.n_accepts)
    _close(float(info.final_value), float(winfo.final_value), FIT_RTOL)
    _close(got.mean, want.mean, FIT_RTOL)
    _close(got.cov, want.cov, FIT_RTOL)


def test_mn_fit_normal_matches_jax(case):
    want, winfo = case["mnormal"].fit_normal(case["jmn"], case["jst"],
                                             case["jprob"], case["mcfg"])
    got, info = tmn.fit_normal(case["mn"], case["st"], case["prob"],
                               case["tmcfg"])
    assert int(info.n_iters) == int(winfo.n_iters)
    assert int(info.n_accepts) == int(winfo.n_accepts)
    for f in ("mean", "cov_useritems", "cov_latents"):
        _close(getattr(got, f), getattr(want, f), FIT_RTOL)


def test_predictive_quantities_match_jax(case):
    vnormal, mnormal = case["vnormal"], case["mnormal"]
    jvn, jprob, vcfg = case["jvn"], case["jprob"], case["vcfg"]
    vn, prob, cfg = case["vn"], case["prob"], case["tvcfg"]
    for got, want in zip(tvn.approx_pred_means_vars(vn, prob, cfg),
                         vnormal.approx_pred_means_vars(jvn, jprob, vcfg)):
        _close(got, want)
    _close(tvn.approx_pred_covs(vn, prob, cfg),
           vnormal.approx_pred_covs(jvn, jprob, vcfg))
    _close(float(tvn.approx_entropy(vn)), float(vnormal.approx_entropy(jvn)))
    _close(float(tvn.mean_meandiff(vn, case["st"])),
           float(vnormal.mean_meandiff(jvn, case["jst"])))
    for got, want in zip(tmn.approx_pred_means_vars(case["mn"], prob),
                         mnormal.approx_pred_means_vars(case["jmn"], jprob)):
        _close(got, want)
    _close(float(tmn.approx_entropy(case["mn"], N, M)),
           float(mnormal.approx_entropy(case["jmn"], N, M)))
    _close(float(tmn.mean_meandiff(case["mn"], case["st"])),
           float(mnormal.mean_meandiff(case["jmn"], case["jst"])))


def test_convert_round_trip_of_the_approximations(case):
    for state, build in ((case["vn"], convert.vn_state),
                         (case["mn"], convert.mn_state)):
        back = convert.to_numpy(state)
        again = convert.to_numpy(build(back, device="cpu"))
        assert set(back) == set(again)
        assert all(np.array_equal(back[k], again[k]) for k in back)
    np.testing.assert_array_equal(convert.to_numpy(case["vn"])["cov"],
                                  np.asarray(case["jvn"].cov))


def test_pmf_sigma_updates_match_jax(case):
    """ll_prior_adjustment, update_sigma, update_sigma_uv (with and without
    the log-variance hyperprior) and fit_with_sigmas."""
    from amf_tpu.models import pmf

    jst, jprob = case["jst"], case["jprob"]
    st, prob = case["st"], case["prob"]
    for kw in ({}, dict(sig_u_var=2.0, sig_v_var=3.0, sig_u_mean=0.5)):
        jcfg = pmf.PMFConfig(latent_d=D, max_fit_steps=20, **kw)
        cfg = tpmf.PMFConfig(**jcfg._asdict())
        _close(float(tpmf.ll_prior_adjustment(st, prob, cfg)),
               float(pmf.ll_prior_adjustment(jst, jprob, jcfg)))
        got = tpmf.update_sigma_uv(tpmf.update_sigma(st, prob, cfg), prob, cfg)
        want = pmf.update_sigma_uv(pmf.update_sigma(jst, jprob, jcfg), jprob,
                                   jcfg)
        for f in ("sigma_sq", "sigma_u_sq", "sigma_v_sq"):
            _close(float(getattr(got, f)), float(getattr(want, f)))
    got = tpmf.fit_with_sigmas(st, prob, cfg, max_outer=4)
    want = pmf.fit_with_sigmas(jst, jprob, jcfg, max_outer=4)
    for f in ("U", "V", "sigma_sq", "sigma_u_sq", "sigma_v_sq"):
        _close(getattr(got, f), getattr(want, f), FIT_RTOL)
