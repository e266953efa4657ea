"""The port's native host kernels (amf_tpu_torch/_native) against the JAX
package's (amf_tpu/_native) and against the port's maxent sums.

On the same numpy inputs the five functions give what the JAX package's
give (the sparse products and sums to 1e-12, the packer exactly, the
clamp at 1e128), and what numpy gives. ``sprowsumprod`` and
``sprowcolsum`` over a problem's query cells equal the per-row and
per-column expected-feature sums that ``models/ratingconc.py`` folds into
the dual's gradient, lane by lane, to 1e-10.
"""

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a worker)
from amf_tpu import _native as jnative
from amf_tpu_torch import _native as tnative
from amf_tpu_torch import types as ttypes
from amf_tpu_torch.models import ratingconc as trc

TIGHT = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _built():
    if not (tnative.available() and jnative.available()):
        pytest.skip("no C++ toolchain: neither native library builds")


@pytest.fixture
def coo(rng):
    n, m, nnz = 12, 9, 40
    ii = rng.integers(0, n, nnz).astype(np.int64)
    jj = rng.integers(0, m, nnz).astype(np.int64)
    return n, m, ii, jj


def test_library_is_built_under_the_port_build_directory():
    path = tnative.library_path()
    assert path.exists() and path.parent.name == "amf_tpu_torch"
    assert path.parent.parent.name == "build"


def test_spouterprod_matches_jax_and_numpy(coo, rng):
    n, m, ii, jj = coo
    u, v = rng.normal(size=n), rng.normal(size=m)
    got = tnative.spouterprod(ii, jj, u, v)
    np.testing.assert_allclose(got, jnative.spouterprod(ii, jj, u, v),
                               rtol=TIGHT)
    np.testing.assert_allclose(got, u[ii] * v[jj], rtol=TIGHT)
    big_u, big_v = np.abs(u) * 1e200, np.abs(v) * 1e200
    clamped = tnative.spouterprod(ii, jj, big_u, big_v, clamp=1e128)
    assert (clamped <= 1e128).all()
    np.testing.assert_array_equal(
        clamped, jnative.spouterprod(ii, jj, big_u, big_v, clamp=1e128))


def test_sprowsumprod_matches_jax_and_numpy(coo, rng):
    n, m, ii, jj = coo
    p, F = rng.random((ii.size, 5)), rng.normal(size=(5, 17))
    rs, cs = tnative.sprowsumprod(ii, jj, p, F, n, m)
    jrs, jcs = jnative.sprowsumprod(ii, jj, p, F, n, m)
    np.testing.assert_allclose(rs, jrs, rtol=TIGHT, atol=TIGHT)
    np.testing.assert_allclose(cs, jcs, rtol=TIGHT, atol=TIGHT)
    want_rs, want_cs = np.zeros((n, 17)), np.zeros((m, 17))
    np.add.at(want_rs, ii, p @ F)
    np.add.at(want_cs, jj, p @ F)
    np.testing.assert_allclose(rs, want_rs, rtol=TIGHT, atol=TIGHT)
    np.testing.assert_allclose(cs, want_cs, rtol=TIGHT, atol=TIGHT)


def test_sprowcolsum_matches_jax_and_numpy(coo, rng):
    n, m, ii, jj = coo
    E = rng.normal(size=(ii.size, 7))
    rs, cs = tnative.sprowcolsum(ii, jj, E, n, m)
    jrs, jcs = jnative.sprowcolsum(ii, jj, E, n, m)
    np.testing.assert_allclose(rs, jrs, rtol=TIGHT, atol=TIGHT)
    np.testing.assert_allclose(cs, jcs, rtol=TIGHT, atol=TIGHT)
    want_rs, want_cs = np.zeros((n, 7)), np.zeros((m, 7))
    np.add.at(want_rs, ii, E)
    np.add.at(want_cs, jj, E)
    np.testing.assert_allclose(rs, want_rs, rtol=TIGHT, atol=TIGHT)
    np.testing.assert_allclose(cs, want_cs, rtol=TIGHT, atol=TIGHT)


def test_coo_to_dense_matches_jax(rng):
    n, m = 8, 6
    ratings = np.array([[0, 0, 1.0], [1, 2, 2.0], [1, 2, 3.0], [7, 5, 4.0]])
    values, mask, dups = tnative.coo_to_dense(ratings, n, m)
    jvalues, jmask, jdups = jnative.coo_to_dense(ratings, n, m)
    np.testing.assert_array_equal(values, jvalues)
    np.testing.assert_array_equal(mask, jmask)
    assert dups == jdups == 1  # (1, 2) written twice, the last wins
    assert values[1, 2] == 3.0 and mask.sum() == 3
    wide = np.column_stack([rng.integers(0, n, 30), rng.integers(0, m, 30),
                            rng.normal(size=30)]).astype(float)
    for got, want in zip(tnative.coo_to_dense(wide, n, m),
                         jnative.coo_to_dense(wide, n, m)):
        np.testing.assert_array_equal(got, want)


def test_masked_rmse_matches_jax_and_the_port_metric(rng):
    from amf_tpu_torch.analysis import metrics

    pred, target = rng.normal(size=(10, 8)), rng.normal(size=(10, 8))
    mask = rng.random((10, 8)) < 0.5
    got = tnative.masked_rmse(pred, target, mask)
    assert got == pytest.approx(jnative.masked_rmse(pred, target, mask),
                                rel=TIGHT)
    want = float(metrics.rmse_on(torch.as_tensor(pred),
                                 torch.as_tensor(target),
                                 torch.as_tensor(mask)))
    assert got == pytest.approx(want, rel=TIGHT)


@pytest.mark.parametrize("bad", ["index", "shape"])
def test_inputs_are_checked_before_the_call(coo, rng, bad):
    n, m, ii, jj = coo
    E = rng.normal(size=(ii.size, 3))
    if bad == "index":
        ii = ii.copy()
        ii[0] = n
    else:
        E = E[1:]
    with pytest.raises(ValueError):
        tnative.sprowcolsum(ii, jj, E, n, m)


def test_sums_equal_the_port_maxent_sums_lane_by_lane(rng):
    """Over the query cells of a 7 x 6 problem, native row and column sums
    of P F equal the sums that the dual's gradient holds, for each of three
    lanes of multipliers."""
    real = rng.integers(1, 6, size=(7, 6)).astype(float)
    known = rng.random((7, 6)) < 0.5
    known[0], known[:, 0] = True, True
    prob = ttypes.problem_from_dense(real, known, dtype=torch.float64,
                                     device="cpu")
    data = trc.prepare(prob, trc.RCConfig(), dtype=torch.float64)
    n, k = data.mu.shape
    m = data.nu.shape[0]
    L = 3
    x = torch.as_tensor(rng.random((L, 2 * (n + m) * k)) * 0.3)
    _, g = trc.dual_value_and_grad(x, data)
    eps = torch.finfo(x.dtype).eps
    cc = torch.clamp(data.c, min=eps)[:, None]
    dd = torch.clamp(data.d, min=eps)[:, None]
    # d/dg+ = -mu + alpha + rowsum / c; d/dl+ = -nu + beta + colsum / d
    row = (g[:, :n * k].reshape(L, n, k) + data.mu - data.alpha) * cc
    col = (g[:, 2 * n * k:2 * n * k + m * k].reshape(L, m, k) + data.nu
           - data.beta) * dd

    P = trc.cell_probs(x, data, data.qmask).numpy()  # (L, n, m, V)
    ii, jj = np.nonzero(data.qmask.numpy())
    F = data.F.numpy()
    for lane in range(L):
        p = P[lane, ii, jj]
        rs, cs = tnative.sprowsumprod(ii, jj, p, F, n, m)
        np.testing.assert_allclose(rs, row[lane].numpy(), rtol=1e-10,
                                   atol=1e-10)
        np.testing.assert_allclose(cs, col[lane].numpy(), rtol=1e-10,
                                   atol=1e-10)
        rs2, cs2 = tnative.sprowcolsum(ii, jj, p @ F, n, m)
        np.testing.assert_allclose(rs2, rs, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(cs2, cs, rtol=1e-12, atol=1e-12)
