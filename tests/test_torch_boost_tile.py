"""``add_rmse_boosts.boost_tile`` (amf_tpu_torch/run/add_rmse_boosts.py),
the CLI's tile, which the benchmark's ``pmf_refit`` family runs.

In float64 on the CPU it is held to the benchmark's plain reference
(``portbench/models/pmf_refit/reference.py``: dense masks, the same
accept/reject rule): both take the same steps, so only summation order
may differ. The CLI's pickle is held bit for bit to its tile loop as it
was before the loop's body became ``boost_tile`` (the lanes' refit by
``fit_lookahead_batch`` and the RMSE chunks, spelled out here). A traced
tile is one tree of spans."""

import pickle

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a worker)
from amf_tpu_torch import types
from amf_tpu_torch.data.loaders import save_npz_schema
from amf_tpu_torch.models import pmf
from amf_tpu_torch.run import add_rmse_boosts as cli
from amf_tpu_torch.utils import profiling
from amf_tpu_torch.utils.rng import generator
from portbench.models.pmf_refit import reference as ref

STEPS = 200


def _problem(seed, dtype, n=30, m=40, d=3, fit_steps=None):
    rng = np.random.default_rng(seed)
    real = np.clip(np.round(rng.standard_normal((n, d))
                            @ rng.standard_normal((m, d)).T * 0.7 + 3), 1, 5)
    known = rng.random((n, m)) < 0.3
    test = ~known & (rng.random((n, m)) < 0.2)
    ratings = np.column_stack([np.argwhere(known), real[known]])
    prob = types.problem_from_ratings(ratings, real=real, test=test,
                                      dtype=dtype, device="cpu")
    cfg = pmf.PMFConfig(latent_d=d)
    st = pmf.init_state(generator(seed, "cpu"), n, m, cfg, prob,
                        dtype=dtype, device="cpu")
    st, _ = pmf.fit(st, prob, cfg, max_steps=fit_steps)
    return real, known, test, prob, cfg, st


@pytest.mark.parametrize("seed", [0, 1])
def test_boost_tile_matches_the_reference_in_float64(seed):
    # a MAP cut short, so that every lane's refit has many steps to take
    real, known, test, prob, cfg, st = _problem(seed, torch.float64,
                                                fit_steps=30)
    cand = np.flatnonzero(prob.queryable.numpy().ravel())[5:13]
    assert len(cand) == 8
    profiling.spans(reset=True)
    with profiling.tracing():
        got = cli.boost_tile(st, prob, cfg, torch.as_tensor(real),
                             torch.as_tensor(cand), STEPS)
    refit, = (s for s in profiling.spans(reset=True)
              if s.name == "pmf.refit_batch")
    # long trajectories, past many host reads
    assert refit.attrs["passes"] > 20
    data = ref.Data.build(real, known, test, torch.float64, "cpu")
    cells = ref.Cells.true_values(data, cand)
    U, V, f = ref.refit(data, st.U, st.V, cells,
                        ref.Rule(cfg.learning_rate, cfg.stop_thresh,
                                 cfg.min_learning_rate, STEPS))
    rmse = ref.heldout_rmse(data, U, V)
    for a, b in ((got.rmse, rmse), (got.neg_ll, f), (got.U, U), (got.V, V)):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9)


def test_the_cli_pickle_is_the_tile_loops_as_it_was(tmp_path):
    real, known, test, *_ = _problem(2, torch.float32, n=12, m=9, d=2)
    path = str(tmp_path / "data.npz")
    save_npz_schema(path, {"_real": real, "_known": known, "_test_on": test})
    out = str(tmp_path / "boosts.pkl")
    cli.main(["--load-data", path, "-D", "2", "--tile", "4", "--refit-steps",
              "30", "--device", "cpu", "--out", out])
    with open(out, "rb") as f:
        got = pickle.load(f)

    # the loop before boost_tile, line for line
    ratings = np.column_stack([np.argwhere(known), real[known]])
    prob = types.problem_from_ratings(ratings, real=real, test=test,
                                      dtype=torch.float32, device="cpu")
    n, m = prob.shape
    cfg = pmf.PMFConfig(latent_d=2)
    st = pmf.init_state(generator(0, "cpu"), n, m, cfg, prob,
                        dtype=torch.float32, device="cpu")
    st, _ = pmf.fit(st, prob, cfg)
    real_t = torch.as_tensor(real, dtype=torch.float32)
    r0 = float(cli.masked_rmse(pmf.predicted_matrix(st, cfg), real_t,
                               prob.test))
    qq = np.nonzero(prob.queryable.numpy().ravel())[0]
    pad = (-len(qq)) % 4
    cand = np.concatenate([qq, np.zeros(pad, qq.dtype)])
    boosts = np.full((n, m), np.nan)
    for t in range(len(cand) // 4):
        s = slice(t * 4, (t + 1) * 4)
        di = torch.as_tensor(cand[s] // m)
        dj = torch.as_tensor(cand[s] % m)
        U, V, _ = pmf.fit_lookahead_batch(st, prob, di, dj, real_t[di, dj],
                                          cfg, max_steps=30)
        rmses = torch.cat([cli.masked_rmse(U[k:k + 8] @ V[k:k + 8].mT,
                                           real_t, prob.test)
                           for k in range(0, 4, 8)]).numpy()
        for k, c in enumerate(cand[s][:max(0, len(qq) - t * 4)]):
            boosts[c // m, c % m] = r0 - rmses[k]
    assert set(got) == {"_real", "base_rmse", "boosts"}
    assert got["base_rmse"] == r0
    np.testing.assert_array_equal(got["_real"], real)
    np.testing.assert_array_equal(got["boosts"], boosts)


def test_a_traced_tile_is_one_tree_of_spans():
    real, _, _, prob, cfg, st = _problem(0, torch.float32)
    cand = torch.as_tensor(np.flatnonzero(prob.queryable.numpy().ravel())[:8])
    profiling.spans(reset=True)
    with profiling.tracing():
        got = cli.boost_tile(st, prob, cfg, torch.as_tensor(real).float(),
                             cand, STEPS)
    recs = profiling.spans(reset=True)
    tile, refit, rmse = recs
    assert (tile.name, refit.name, rmse.name) == (
        "boost.tile", "pmf.refit_batch", "boost.rmse")
    assert tile.parent is None and refit.parent == rmse.parent == tile.id
    assert {s.root for s in recs} == {tile.id}
    assert tile.attrs == {"lanes": 8} and rmse.attrs == {"lanes": 8}
    a = refit.attrs
    assert {k: a[k] for k in ("lanes", "route", "max_steps")} == {
        "lanes": 8, "route": "value_grad", "max_steps": STEPS}
    assert isinstance(a["passes"], int) and 0 < a["passes"] <= STEPS
    # the lanes' means, read as floats when the spans are read
    assert isinstance(a["proposals"], float) and isinstance(a["accepts"],
                                                            float)
    assert 1 <= a["accepts"] <= a["proposals"] <= a["passes"]
    assert got.rmse.shape == got.neg_ll.shape == (8,)


def test_a_float64_refit_refuses_the_lane_blocked_routes():
    real, _, _, prob, cfg, st = _problem(0, torch.float64)
    cells = [torch.tensor([0, 1]), torch.tensor([1, 2]),
             torch.tensor([3.0, 4.0], dtype=torch.float64)]
    with pytest.raises(ValueError, match="float64 refit"):
        pmf.fit_lookahead_batch(st, prob, *cells, cfg, 10, lane_block=8)
