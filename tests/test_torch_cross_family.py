"""Cross-implementation consistency on the port (a port of
``tests/test_cross_family.py``): the port's three inference engines,
variational normal (analytic Var[R_ij]), Gibbs and NUTS (both from
posterior samples), score pred-variance on one 8 x 8 problem and must
rank-agree as the JAX package's engines must, with JAX's thresholds and
draw counts: tau(gibbs, stan) > 0.4, tau(apmf, .) > -0.1, and the two
samplers' posterior means correlated above 0.9 with a median gap under
half a rating step. Float64 on the CPU; the port's generators replace JAX's
keys, so the maps are the port's own draws, not JAX's.
"""

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a worker)
from amf_tpu_torch import types
from amf_tpu_torch.analysis.metrics import kendall_tau
from amf_tpu_torch.data.synthetic import make_fake_data
from amf_tpu_torch.models import bpmf_gibbs, bpmf_hmc, pmf, sample_stats, vnormal
from amf_tpu_torch.utils.rng import generator

DEV, F64 = "cpu", torch.float64


@pytest.fixture(scope="module")
def shared_problem():
    rng = np.random.default_rng(21)
    real, known, vals = make_fake_data(
        num_users=8, num_items=8, rank=2, data_type=5, mask_type=0.45, rng=rng
    )
    prob = types.problem_from_dense(real, known, dtype=F64, device=DEV)
    return real, prob, vals


def _map_fit(prob, d, subtract_mean):
    pcfg = pmf.PMFConfig(latent_d=d, subtract_mean=subtract_mean)
    pst = pmf.init_state(generator(0, DEV), *prob.shape, pcfg, prob,
                         dtype=F64, device=DEV)
    return pmf.fit(pst, prob, pcfg)[0]


def _nuts_stats(prob, pst, d, subtract_mean, seed):
    hcfg = bpmf_hmc.HMCConfig(latent_d=d, subtract_mean=subtract_mean,
                              max_depth=7)
    st = bpmf_hmc.init_state(prob, hcfg, U=pst.U, V=pst.V, dtype=F64)
    st, samps = bpmf_hmc.samples(seed, st, prob, hcfg, 300, 200)
    return sample_stats.prediction_stats(samps["U"], samps["V"],
                                         st.mean_rating, subtract_mean)


@pytest.fixture(scope="module")
def criterion_maps(shared_problem):
    real, prob, vals = shared_problem
    d = 2
    q = prob.queryable.numpy()
    maps = {}
    # MAP fit shared by all (subtract_mean=False so predictions line up
    # with the variational path)
    pst = _map_fit(prob, d, False)

    vcfg = vnormal.VNConfig(latent_d=d, max_fit_steps=2000)
    vn = vnormal.initialize_approx(pst, vcfg, generator=generator(1, DEV))
    vn, _ = vnormal.fit_normal(vn, pst, prob, vcfg)
    _, pv = vnormal.approx_pred_means_vars(vn, prob, vcfg)
    maps["apmf"] = np.where(q, pv.numpy(), np.nan)

    gcfg = bpmf_gibbs.GibbsConfig(latent_d=d, subtract_mean=False)
    _, stats, _ = bpmf_gibbs.run_chain(
        bpmf_gibbs.init_chain(pst), prob, gcfg, 400,
        generator=generator(2, DEV))
    maps["gibbs"] = np.where(q, stats.var.numpy(), np.nan)

    hstats = _nuts_stats(prob, pst, d, False, 3)
    maps["stan"] = np.where(q, hstats.var.numpy(), np.nan)
    return maps


def test_pred_variance_rank_agreement(criterion_maps):
    taus = {
        (a, b): kendall_tau(criterion_maps[a], criterion_maps[b])
        for a, b in [("apmf", "gibbs"), ("apmf", "stan"), ("gibbs", "stan")]
    }
    # the two MCMC engines target the same posterior: strong agreement
    assert taus[("gibbs", "stan")] > 0.4, taus
    # the variational path is a different model (fixed priors against
    # Gaussian-Wishart hyperpriors): only not anti-correlated
    assert taus[("apmf", "gibbs")] > -0.1, taus
    assert taus[("apmf", "stan")] > -0.1, taus


def test_gibbs_stan_posterior_mean_agreement(shared_problem):
    """Posterior-mean predictions of the two samplers agree cell-wise."""
    real, prob, vals = shared_problem
    d = 2
    pst = _map_fit(prob, d, True)
    gcfg = bpmf_gibbs.GibbsConfig(latent_d=d, subtract_mean=True)
    _, gstats, _ = bpmf_gibbs.run_chain(
        bpmf_gibbs.init_chain(pst), prob, gcfg, 400,
        generator=generator(1, DEV))
    hstats = _nuts_stats(prob, pst, d, True, 2)
    g = gstats.mean.numpy()
    h = hstats.mean.numpy()
    assert np.corrcoef(g.ravel(), h.ravel())[0, 1] > 0.9
    assert np.median(np.abs(g - h)) < 0.5
