"""The port's maxent model, its loop and CLI (amf_tpu_torch/models/
ratingconc.py, active/rc_loop.py, run/active_rc.py) against the JAX
package's, in float64 on the CPU.

On a 5 x 4 problem with 3 rating values: the feature map is equal;
``prepare`` and the dual with its closed-form gradient agree to 1e-12 (the
gradient also with torch.autograd of the dual); the fit's multipliers and
dual value to 1e-8; the predictions to 1e-8; the entropy lookahead scores
to 1e-8, tiled or not; the active loop picks the same cells under
``entropy``, ``ge-1`` and ``ge-4`` with errors to 1e-8. The CLI keeps the
JAX package's results layout and resumes from its checkpoint.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a worker)
from amf_tpu import types as jtypes
from amf_tpu.active import rc_loop as jloop
from amf_tpu.models import ratingconc as jrc
from amf_tpu_torch import convert
from amf_tpu_torch.active.rc_loop import run_active_rc
from amf_tpu_torch.data.loaders import save_npz_schema
from amf_tpu_torch.models import ratingconc as trc

TIGHT, TOL = 1e-12, 1e-8
# three values, none of them the cutoffs, so that P(>= 1) and P(>= 4) are
# both non-trivial
VALS = (0.5, 2.0, 4.5)
LA_ITERS, FIT_ITERS = 25, 200


def _close(got, want, tol):
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.nanmax(np.abs(want)), 1.0))


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(3)
    real = np.asarray(VALS)[rng.integers(0, 3, size=(5, 4))]
    known = rng.random((5, 4)) < 0.4
    known[0] = True
    known[:, 0] = True
    jprob = jtypes.problem_from_dense(real, known, dtype=jnp.float64)
    tprob = convert.problem(jprob, device="cpu", dtype=torch.float64)
    jcfg = jrc.RCConfig(rating_values=VALS, max_iters=FIT_ITERS)
    tcfg = trc.RCConfig(**jcfg._asdict())
    jx, jdata, jit = jrc.fit(jprob, jcfg)
    tx, tdata, tit = trc.fit(tprob, tcfg)
    return dict(real=real, known=known, jprob=jprob, tprob=tprob, jcfg=jcfg,
                tcfg=tcfg, jx=jx, jdata=jdata, jit=jit, tx=tx, tdata=tdata,
                tit=tit, rng=rng)


@pytest.mark.parametrize("values", [(1, 2, 3, 4, 5), (1, 2), VALS])
def test_feature_map_equals_jax(values):
    np.testing.assert_array_equal(trc.feature_map(values),
                                  jrc.feature_map(values))


def test_prepare_matches_jax(case):
    jdata = jrc.prepare(case["jprob"], case["jcfg"])
    x, tdata = convert.rc_state(np.zeros(1), jdata, device="cpu",
                                dtype=torch.float64)
    got = trc.prepare(case["tprob"], case["tcfg"])
    for name in ("F", "prior", "log_prior", "mu", "nu", "alpha", "beta", "c",
                 "d"):
        _close(getattr(got, name), getattr(tdata, name), TIGHT)
    assert torch.equal(got.qmask, tdata.qmask)


def test_dual_and_closed_form_gradient_match_jax_and_autograd(case):
    data = case["tdata"]
    n, k = data.mu.shape
    m = data.nu.shape[0]
    x = case["rng"].random(2 * (n + m) * k) * 0.5
    jf, jg = jax.value_and_grad(
        lambda z: jrc.dual_objective(z, case["jdata"]))(jnp.asarray(x))
    f, g = trc.dual_value_and_grad(torch.tensor(x), data)
    _close(f, jf, TIGHT)
    _close(g, jg, TIGHT)
    _close(trc.dual_objective(torch.tensor(x), data), jf, TIGHT)
    xt = torch.tensor(x, requires_grad=True)
    (auto,) = torch.autograd.grad(trc.dual_objective(xt, data), xt)
    _close(g, auto, TIGHT)


def test_fit_matches_jax(case):
    _close(case["tx"], case["jx"], TOL)
    _close(trc.dual_objective(case["tx"], case["tdata"]),
           jrc.dual_objective(case["jx"], case["jdata"]), TOL)
    assert int(case["tit"]) > 0
    P = trc.cell_probs(case["tx"], case["tdata"], case["tdata"].qmask)
    _close(P, jrc.cell_probs(case["jx"], case["jdata"], case["jdata"].qmask),
           TOL)


def test_predictions_match_jax(case):
    E, P = trc.predictions(case["tx"], case["tdata"], case["tprob"],
                           case["tcfg"])
    jE, jP = jrc.predictions(case["jx"], case["jdata"], case["jprob"],
                             case["jcfg"])
    _close(E, jE, TOL)
    _close(P, jP, TOL)


@pytest.fixture(scope="module")
def jax_scores(case):
    return np.asarray(jax.jit(lambda x, data: jrc.entropy_lookahead_scores(
        x, data, case["jprob"], case["jcfg"], lookahead_iters=LA_ITERS))(
            case["jx"], case["jdata"]))


@pytest.mark.parametrize("tile", [0, 3])
def test_entropy_lookahead_scores_match_jax(case, jax_scores, tile):
    """Every cell a candidate: the rated ones score NaN, the queryable ones
    refit their three value lanes together, all at once or 3 candidates
    a tile."""
    want = jax_scores
    got = trc.entropy_lookahead_scores(
        case["tx"], case["tdata"], case["tprob"], case["tcfg"],
        lookahead_iters=LA_ITERS, candidate_tile=tile).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isfinite(want).sum() == int(case["tprob"].queryable.sum())
    _close(got, want, TOL)


LOOP_KEYS = ["entropy", "ge-1", "ge-4"]
LOOP_KW = dict(steps=3, seed=0, max_iters=FIT_ITERS,
               lookahead_iters=LA_ITERS, rating_values=VALS)


def test_run_active_rc_picks_match_jax(case):
    want = jloop.run_active_rc(case["jprob"], case["real"], LOOP_KEYS,
                               **LOOP_KW)
    got = run_active_rc(case["tprob"], case["real"], LOOP_KEYS + ["random"],
                        device="cpu", lookahead_tile=2, **LOOP_KW)
    assert got["_rating_vals"] == want["_rating_vals"]
    for k in LOOP_KEYS:
        assert [r[2] for r in got[k]] == [r[2] for r in want[k]], k
        assert [r[0] for r in got[k]] == [r[0] for r in want[k]]
        _close([r[1] for r in got[k]], [r[1] for r in want[k]], TOL)
        for g, w in zip(got[k][1:], want[k][1:]):
            _close(g[3], w[3], TOL)
    pool = case["tprob"].queryable.numpy()
    picks = [r[2] for r in got["random"][1:]]
    assert len(got["random"]) == 3 and len(set(picks)) == 2
    assert all(pool[i, j] for i, j in picks)


def test_run_active_rc_refuses_unknown_keys(case):
    with pytest.raises(ValueError, match="unknown RC selector"):
        run_active_rc(case["tprob"], case["real"], ["nope"], device="cpu")


@pytest.fixture(scope="module")
def data_file(tmp_path_factory, case):
    """Ratings 1..5 (the CLI's default value set), no zeros."""
    real = np.clip(np.round(case["real"]), 1, 5)
    path = str(tmp_path_factory.mktemp("torch_rc_cli") / "data.npz")
    save_npz_schema(path, {"_real": real, "_known": case["known"]})
    return path


def test_active_rc_cli_with_checkpoint(data_file, tmp_path, capsys):
    """The CLI runs with --device cpu and writes the JAX package's layout
    (rc_ prefixes, _kind); a second run resumes from its checkpoint."""
    from amf_tpu_torch.run import active_rc

    out, ck = str(tmp_path / "r.pkl"), str(tmp_path / "ck.pkl")
    argv = ["--load-data", data_file, "-s", "2", "--max-iters", "60",
            "--lookahead-iters", "5", "--device", "cpu", "--checkpoint", ck,
            "--any-vals", "--save-results", out, "ge-4", "random"]
    first = active_rc.main(argv)
    with open(out, "rb") as f:
        res = pickle.load(f)
    assert res["_kind"] == "rc" and {"rc_ge-4", "rc_random"} <= set(res)
    assert len(res["rc_random"]) == 2
    with open(ck, "rb") as f:
        assert len(pickle.load(f)["random"]) == 2
    capsys.readouterr()
    again = active_rc.main(argv[:-3] + ["--no-save-results", "random"])
    assert "resumed at step 1" in capsys.readouterr().out
    assert [r[:3] for r in again["random"]] == [r[:3] for r in first["random"]]
