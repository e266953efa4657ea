"""The port's add_rmse_boosts CLI (amf_tpu_torch/run/add_rmse_boosts.py)
against the JAX package's (amf_tpu/run/add_rmse_boosts.py).

The tile RMSEs are held to the JAX CLI's computation (plain refit, einsum,
masked RMSE) from the same fitted state to rtol 1e-4: both refits run in
float32 and agree on the factors to the tolerance of
tests/test_torch_lookahead_batch.py; the RMSE averages that error out.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amf_tpu import types as jtypes
from amf_tpu.data import make_fake_data
from amf_tpu.models import pmf as jpmf
from amf_tpu_torch import convert
from amf_tpu_torch.data.loaders import save_npz_schema
from amf_tpu_torch.models import pmf as tpmf
from amf_tpu_torch.run import add_rmse_boosts as tcli

STEPS = 20


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    real, known, _ = make_fake_data(num_users=12, num_items=9, rank=2,
                                    data_type=5, mask_type=0.4, rng=rng)
    test = (rng.random(real.shape) < 0.25) & ~known
    return real, known, test


def test_tile_rmses_match_jax(data):
    real, known, test = data
    ratings = np.argwhere(known)
    ratings = np.column_stack([ratings, real[known]])
    jprob = jtypes.problem_from_ratings(ratings, real=real, test=test,
                                        dtype=jnp.float32)
    jcfg = jpmf.PMFConfig(latent_d=2)
    jst = jpmf.init_state(jax.random.PRNGKey(0), *real.shape, jcfg, jprob,
                          dtype=jnp.float32)
    jst, _ = jpmf.fit(jst, jprob, jcfg)
    q = np.flatnonzero(np.asarray(jprob.queryable).ravel())[:10]
    assert len(q) == 10  # more lanes than one RMSE chunk
    m = real.shape[1]
    real32 = jnp.asarray(real, jnp.float32)
    di, dj = jnp.asarray(q // m, jnp.int32), jnp.asarray(q % m, jnp.int32)
    U, V, _ = jpmf.fit_lookahead_batch(jst, jprob, di, dj, real32[di, dj],
                                       jcfg, max_steps=STEPS,
                                       use_pallas=False)
    pred = jnp.einsum("lnd,lmd->lnm", U, V)
    err = jnp.where(jprob.test[None], pred - real32[None], 0.0)
    want = jnp.sqrt(jnp.sum(err * err, axis=(1, 2))
                    / jnp.maximum(jnp.sum(jprob.test), 1))

    tprob = convert.problem(jprob, dtype=torch.float32)
    real_t = torch.as_tensor(real, dtype=torch.float32)
    ti, tj = torch.as_tensor(q // m), torch.as_tensor(q % m)
    got = tcli.tile_rmses(
        convert.pmf_state(jst, dtype=torch.float32), tprob,
        tpmf.PMFConfig(**jcfg._asdict()), real_t, ti, tj, real_t[ti, tj],
        STEPS, use_pallas=False)
    assert got.shape == (10,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)


def test_cli_on_cpu_writes_the_jax_schema(data, tmp_path):
    """The pickle has the keys the JAX CLI writes (amf_tpu/run/
    add_rmse_boosts.py:95), with a boost on every queryable cell and NaN
    everywhere else; with --no-pallas the same cells are scored."""
    real, known, test = data
    path = str(tmp_path / "data.npz")
    save_npz_schema(path, {"_real": real, "_known": known, "_test_on": test})
    pool = ~known & ~test & (real != 0)
    outs = []
    for extra in ([], ["--no-pallas"]):
        out = str(tmp_path / f"boosts{len(extra)}.pkl")
        tcli.main(["--load-data", path, "-D", "2", "--tile", "4",
                   "--refit-steps", str(STEPS), "--device", "cpu",
                   "--out", out, *extra])
        with open(out, "rb") as f:
            res = pickle.load(f)
        assert set(res) == {"_real", "base_rmse", "boosts"}
        np.testing.assert_array_equal(res["_real"], real)
        assert np.isfinite(res["base_rmse"])
        assert res["boosts"].shape == real.shape
        np.testing.assert_array_equal(np.isfinite(res["boosts"]), pool)
        outs.append(res["boosts"])
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-7)
