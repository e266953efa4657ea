"""The port's batched lookahead refit (models/pmf.fit_lookahead_batch)
against the JAX package's, from the same fitted base state.

Tolerances are those of tests/test_pallas_kernels.py:219-223, which holds
the JAX paths to each other at max_steps=5: the value to rtol 1e-4, the
factors to rtol 1e-3 with atol 1e-5 (float32 sums in other orders; an
accept decided by a near-tie may differ). The poly-LS path runs at
max_steps=25, as tests/test_pallas_kernels.py:298-307 runs it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a worker)
from amf_tpu import types as jtypes
from amf_tpu.models import pmf as jpmf
from amf_tpu.ops import pallas_kernels as jpk
from amf_tpu_torch import convert
from amf_tpu_torch.models import pmf as tpmf

STEPS = 5
CELLS = ([0, 5, 12], [1, 8, 0], [3.0, 1.0, 5.0])


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(3)
    n, m, d = 13, 9, 3
    R = rng.integers(1, 6, size=(n, m)).astype(np.float32)
    rated = rng.random((n, m)) < 0.5
    jprob = jtypes.Problem(R_obs=jnp.asarray(np.where(rated, R, 0.0)),
                           rated=jnp.asarray(rated),
                           queryable=jnp.asarray(~rated),
                           test=jnp.asarray(rated))
    jcfg = jpmf.PMFConfig(latent_d=d)
    jst = jpmf.init_state(jax.random.PRNGKey(0), n, m, jcfg, jprob,
                          dtype=jnp.float32)
    jst, _ = jpmf.fit(jst, jprob, jcfg)
    tst = convert.pmf_state(jst, device="cpu", dtype=torch.float32)
    tprob = convert.problem(jprob, device="cpu", dtype=torch.float32)
    return jprob, jcfg, jst, tprob, tpmf.PMFConfig(**jcfg._asdict()), tst


def _cells(lib):
    di, dj, dv = CELLS
    if lib == "jax":
        return (jnp.asarray(di, jnp.int32), jnp.asarray(dj, jnp.int32),
                jnp.asarray(dv, jnp.float32))
    return (torch.tensor(di), torch.tensor(dj),
            torch.tensor(dv, dtype=torch.float32))


@pytest.mark.parametrize("path", [
    dict(use_pallas=False),
    dict(block_rows=8),
    dict(lane_block=2, bf16=False, block_rows=8),
    dict(lane_block=2, bf16=False, block_rows=8, poly_ls=True, max_steps=25),
    dict(lane_block=2, bf16=False, block_rows=8, fused=True),
])
def test_matches_jax(case, monkeypatch, path):
    """The plain path, the (L, rows, d) kernel path, the lane-blocked
    (L, d, rows) proposal loop, its poly-LS epoch loop and the fused line
    search; the JAX kernels run in interpret mode."""
    jprob, jcfg, jst, tprob, tcfg, tst = case
    path = dict(path)
    steps = path.pop("max_steps", STEPS)
    orig_call = jpk.pl.pallas_call

    def interp_call(*args, **kw):
        kw["interpret"] = True
        return orig_call(*args, **kw)

    monkeypatch.setattr(jpk.pl, "pallas_call", interp_call)
    jU, jV, jf = jpmf.fit_lookahead_batch(
        jst, jprob, *_cells("jax"), jcfg, max_steps=steps, **path)
    tU, tV, tf = tpmf.fit_lookahead_batch(
        tst, tprob, *_cells("torch"), tcfg, max_steps=steps, **path)
    assert tU.shape == (3, 13, 3) and tV.shape == (3, 9, 3)
    assert tU.dtype == tV.dtype == tf.dtype == torch.float32
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-4)
    np.testing.assert_allclose(tU.numpy(), np.asarray(jU), rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(tV.numpy(), np.asarray(jV), rtol=1e-3,
                               atol=1e-5)


def test_bf16_lane_blocked_path_is_finite_and_near_f32(case):
    """bf16 keeps 8 mantissa bits, so the refit is held to its float32 twin
    on the value to 1e-2 relative (a scoring-grade path, not a trajectory
    match: ROADMAP queue C, 'bf16 changes trajectories')."""
    _, _, _, tprob, tcfg, tst = case
    kw = dict(max_steps=STEPS, lane_block=2, block_rows=8)
    U16, V16, f16 = tpmf.fit_lookahead_batch(
        tst, tprob, *_cells("torch"), tcfg, bf16=True, **kw)
    _, _, f32 = tpmf.fit_lookahead_batch(
        tst, tprob, *_cells("torch"), tcfg, bf16=False, **kw)
    assert U16.dtype == V16.dtype == torch.float32
    assert bool(torch.isfinite(f16).all())
    np.testing.assert_allclose(f16.numpy(), f32.numpy(), rtol=1e-2)


def test_poly_ls_without_lane_block_raises(case):
    _, _, _, tprob, tcfg, tst = case
    with pytest.raises(ValueError, match="lane_block"):
        tpmf.fit_lookahead_batch(tst, tprob, *_cells("torch"), tcfg,
                                 max_steps=STEPS, poly_ls=True)


def test_fused_without_lane_block_takes_the_proposal_loop(case):
    """As the JAX package's ``if fused and lane_block``: with no lane block
    ``fused`` changes nothing."""
    _, _, _, tprob, tcfg, tst = case
    for kw in (dict(), dict(use_pallas=False)):
        got = tpmf.fit_lookahead_batch(tst, tprob, *_cells("torch"), tcfg,
                                       max_steps=STEPS, fused=True, **kw)
        want = tpmf.fit_lookahead_batch(tst, tprob, *_cells("torch"), tcfg,
                                        max_steps=STEPS, **kw)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
