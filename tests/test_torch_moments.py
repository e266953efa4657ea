"""The port's Gaussian moments, quadrature weights and PSD projection
(amf_tpu_torch/ops/moments.py, quadrature.py, psd.py) against the JAX
package's, in float64 on the same numpy inputs, to 1e-10 relative (the same
formulas; the sums differ in order only). The batched versions take lanes:
a stack of states gives each state's own moments."""

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a worker)
from amf_tpu_torch.ops import moments as tm
from amf_tpu_torch.ops import psd as tpsd
from amf_tpu_torch.ops import quadrature as tq
from amf_tpu_torch.types import rating_bounds

RTOL = 1e-10
N, M, D = 4, 3, 2
K = (N + M) * D


@pytest.fixture(scope="module")
def jax_ops():
    """The JAX package's moments, quadrature and psd modules."""
    import jax.numpy as jnp

    from amf_tpu.ops import moments, psd, quadrature

    return jnp, moments, quadrature, psd


@pytest.fixture(scope="module")
def states():
    """Two full-covariance states (mean (K,), cov (K, K) SPD) and two
    Kronecker ones, float64."""
    rng = np.random.default_rng(11)
    A = rng.normal(size=(2, K, K))
    cov = A @ np.swapaxes(A, 1, 2) / K + 0.1 * np.eye(K)
    mean = rng.normal(size=(2, K))
    a = rng.normal(size=(2, N + M, N + M))
    b = rng.normal(size=(2, D, D))
    return dict(mean=mean, cov=cov, mn_mean=rng.normal(size=(2, N + M, D)),
                rows=a @ np.swapaxes(a, 1, 2) + np.eye(N + M),
                cols=b @ np.swapaxes(b, 1, 2) + np.eye(D))


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=rtol * np.abs(np.asarray(want)).max())


def test_vn_moments_match_jax_per_lane(jax_ops, states):
    jnp, jm, _, _ = jax_ops
    mean, cov = (torch.as_tensor(states[k]) for k in ("mean", "cov"))
    pm, pv = tm.vn_pred_mean_var(mean, cov, N, M, D)
    covs = tm.vn_pred_covs(mean, cov, N, M, D)
    sq = tm.vn_exp_dotprod_sq(mean, cov, N, M, D)
    assert pm.shape == (2, N, M) and covs.shape == (2, N * M, N * M)
    for lane in range(2):
        jmean, jcov = jnp.asarray(states["mean"][lane]), jnp.asarray(
            states["cov"][lane])
        want_m, want_v = jm.vn_pred_mean_var(jmean, jcov, N, M, D)
        _close(pm[lane], want_m)
        _close(pv[lane], want_v)
        _close(covs[lane], jm.vn_pred_covs(jmean, jcov, N, M, D))
        _close(sq[lane], jm.vn_exp_dotprod_sq(jmean, jcov, N, M, D))


def test_mn_moments_match_jax_per_lane(jax_ops, states):
    jnp, jm, _, _ = jax_ops
    args = [torch.as_tensor(states[k]) for k in ("mn_mean", "rows", "cols")]
    pm, pv = tm.mn_pred_mean_var(*args, N, M)
    sq = tm.mn_exp_dotprod_sq(*args, N, M)
    for lane in range(2):
        jargs = [jnp.asarray(states[k][lane])
                 for k in ("mn_mean", "rows", "cols")]
        want_m, want_v = jm.mn_pred_mean_var(*jargs, N, M)
        _close(pm[lane], want_m)
        _close(pv[lane], want_v)
        _close(sq[lane], jm.mn_exp_dotprod_sq(*jargs, N, M))


def test_scalar_moments_match_jax(jax_ops, states):
    jnp, jm, _, _ = jax_ops
    mean, cov = states["mean"][0], states["cov"][0]
    jmean, jcov = jnp.asarray(mean), jnp.asarray(cov)
    tmean, tcov = torch.as_tensor(mean), torch.as_tensor(cov)
    for idx in [(0, 3, 5), (2, 2, 7), (1, 4, 4)]:
        _close(float(tm.tripexpect(tmean, tcov, *idx)),
               float(jm.tripexpect(jmean, jcov, *idx)))
        _close(float(tm.exp_a2bc(tmean, tcov, *idx)),
               float(jm.exp_a2bc(jmean, jcov, *idx)))
        _close(float(tm.quadexpect(tmean, tcov, *idx, 6)),
               float(jm.quadexpect(jmean, jcov, *idx, 6)))
        _close(float(tm.exp_squared(tmean, tcov, *idx[:2])),
               float(jm.exp_squared(jmean, jcov, *idx[:2])))


def test_quadrature_weights_match_jax(jax_ops):
    jnp, _, jq, _ = jax_ops
    rng = np.random.default_rng(2)
    mean = rng.normal(3.0, 1.0, size=(5,))
    std = rng.uniform(0.2, 1.5, size=(5,))
    tmean, tstd = torch.as_tensor(mean), torch.as_tensor(std)
    jmean, jstd = jnp.asarray(mean), jnp.asarray(std)
    for values in [(1.0, 2.0, 3.0, 4.0, 5.0), (0.0, 1.0, 2.5, 3.0)]:
        bounds = rating_bounds(values)
        _close(tq.discrete_weights(tmean, tstd, bounds),
               jq.discrete_weights(jmean, jstd, bounds))
        _close(tq.simpson_weights(tmean, tstd, np.asarray(values)),
               jq.simpson_weights(jmean, jstd, np.asarray(values)))
    for nodes in (8, 16):
        for got, want in zip(tq.gauss_legendre_nodes(tmean, tstd, nodes),
                             jq.gauss_legendre_nodes(jmean, jstd, nodes)):
            _close(got, want)
    z, w = tq.normal_trapezoid_grid(7)
    jz, jw = jq.normal_trapezoid_grid(7)
    np.testing.assert_array_equal(z, jz)
    np.testing.assert_array_equal(w, jw)


def test_project_psd_matches_jax_per_lane(jax_ops):
    """An indefinite stack: every lane projected as JAX projects it alone,
    the spectrum clamped at min_eig."""
    jnp, _, _, jpsd = jax_ops
    rng = np.random.default_rng(4)
    mats = rng.normal(size=(3, 9, 9))
    got = tpsd.project_psd(torch.as_tensor(mats), min_eig=1e-3)
    for lane in range(3):
        _close(got[lane], jpsd.project_psd(jnp.asarray(mats[lane]),
                                           min_eig=1e-3))
    assert float(torch.linalg.eigvalsh(got).min()) >= 1e-3 * (1 - 1e-8)
    assert torch.equal(got, got.mT)
