"""The port's MMMF (amf_tpu_torch/models/mmmf.py, models/sdpa_io.py,
active/mmmf_loop.py, run/active_mmmf.py) against the JAX package's, in
float64 on the CPU, on small problems made from a numpy seed.

Tolerances: the SVT (both Gram sides), the hinge prox, the isotonic
projection, the ordinal losses and gradients, the selector maps (all but
``random``), the factors' product and singular values and the objectives
agree to 1e-12 (scaled by the largest entry); ADMM trajectories of a fixed
number of iterations (tol = 0) to 1e-9 scaled, on both SVT sides, with and
without residual balancing and with over-relaxation; converged solves (tol
1e-6) by the objective to 1e-7 relative and by X to 1e-5 scaled, cold and
warm-started, with the JAX package's optimality certificate on the port's
solution; the max-norm and ordinal solvers from the same start to 1e-9
scaled. A poisoned warm start (NaN in X, Z or W) re-solves cold without
raising. The active loop picks the same cells as JAX's under the four
margin selectors in both modes (``max`` from injected factors), with the
misclassification to 1e-8; ``random`` picks finite queryable cells; a
resumed run replays its checkpoint; the CLI writes the JAX CLI's keys and
records; ``write_sdpa`` writes JAX's bytes but for the header line.
"""

import io
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a worker)
from amf_tpu import types as jtypes
from amf_tpu.active import mmmf_loop as jloop
from amf_tpu.models import mmmf as jm
from amf_tpu.models import sdpa_io as jsdpa
from amf_tpu_torch import convert
from amf_tpu_torch.active import mmmf_loop as tloop
from amf_tpu_torch.data.loaders import save_npz_schema
from amf_tpu_torch.models import mmmf as tm
from amf_tpu_torch.models import sdpa_io as tsdpa

TIGHT, TRAJ, OBJ, XTOL, LOOP = 1e-12, 1e-9, 1e-7, 1e-5, 1e-8


def _close(got, want, tol):
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    scale = np.abs(want[np.isfinite(want)]).max(initial=1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _labels(seed, n, m, rank=2, frac=0.6):
    rng = np.random.default_rng(seed)
    y = np.sign(rng.normal(size=(n, rank)) @ rng.normal(size=(m, rank)).T)
    y[y == 0] = 1
    return y, np.where(rng.random((n, m)) < frac, y, 0.0)


def _ordinal(seed, n=10, m=8, R=4, frac=0.7):
    rng = np.random.default_rng(seed)
    score = rng.normal(size=(n, 2)) @ rng.normal(size=(m, 2)).T
    edges = np.quantile(score, np.linspace(0, 1, R + 1)[1:-1])
    y = 1 + np.searchsorted(edges, score.ravel()).reshape(n, m)
    return np.where(rng.random((n, m)) < frac, y, 0).astype(np.float64)


@pytest.mark.parametrize("shape", [(17, 11), (11, 17), (13, 13)])
def test_svt_matches_jax_on_both_sides(shape):
    a = np.random.default_rng(1).normal(size=shape) * 3
    for tau in (0.3, 1.0, 4.0):
        _close(tm._svt(_t(a), tau), jm._svt(jnp.asarray(a), tau), TIGHT)


def test_eigh_of_a_non_finite_gram_gives_nan_without_raising():
    g = torch.eye(4, dtype=torch.float64)
    for bad in (torch.nan, torch.inf):
        g2 = g.clone()
        g2[1, 2] = bad
        w, V = tm._eigh(g2)
        assert torch.isnan(w).all() and torch.isnan(V).all()
    w, V = tm._eigh(g)
    assert torch.equal(w, torch.ones(4, dtype=torch.float64))


def test_hinge_prox_and_selectors_match_jax():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(6, 7)) * 2
    y = np.sign(rng.normal(size=(6, 7)))
    obs = rng.random((6, 7)) < 0.6
    for c in (0.3, 2.0):
        _close(tm._hinge_prox(_t(a), _t(y), torch.as_tensor(obs), c),
               jm._hinge_prox(jnp.asarray(a), jnp.asarray(y),
                              jnp.asarray(obs), c), TIGHT)
    X = rng.normal(size=(6, 7))
    X[0, 0] = 0.0
    for name in tm.MMMF_KEYS:
        if name == "random":
            continue
        got, gmax = tm.selector_evals(name, _t(X), torch.as_tensor(obs))
        want, wmax = jm.selector_evals(name, jnp.asarray(X), jnp.asarray(obs))
        assert gmax == wmax
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    gen = torch.Generator().manual_seed(0)
    ev, choose_max = tm.selector_evals("random", _t(X), torch.as_tensor(obs),
                                       gen)
    assert choose_max and torch.isnan(ev[~torch.as_tensor(obs)]).all()
    assert ((ev[torch.as_tensor(obs)] >= 0) & (ev[torch.as_tensor(obs)] < 1)).all()
    with pytest.raises(ValueError, match="unknown MMMF selector"):
        tm.selector_evals("nope", _t(X), torch.as_tensor(obs))


@pytest.mark.parametrize("R", [2, 3, 6])
def test_isotonic_matches_jax(R):
    v = np.random.default_rng(R).normal(size=(5, R)) * 3
    _close(tm._isotonic(_t(v)), jm._isotonic(jnp.asarray(v)), TIGHT)
    _close(tm._isotonic(_t(v[0])), jm._isotonic(jnp.asarray(v[0])), TIGHT)


@pytest.mark.parametrize("all_thr,per_row", [(False, False), (True, False),
                                             (False, True), (True, True)])
def test_ordinal_loss_grads_and_objective_match_jax(all_thr, per_row):
    Y = _ordinal(3, R=4)
    rng = np.random.default_rng(4)
    X = rng.normal(size=Y.shape) * 2
    theta = (np.sort(rng.normal(size=(10, 3)) * 2, -1) if per_row
             else np.array([-1.0, 0.3, 1.2]))
    kw = dict(C=1.5, all_thresholds=all_thr, per_row_thresh=per_row)
    got = tm.ordinal_loss_grads(_t(X), _t(theta), _t(Y).to(torch.int32),
                                _t(Y) > 0, 4, tm.OrdinalConfig(**kw))
    want = jm.ordinal_loss_grads(jnp.asarray(X), jnp.asarray(theta),
                                 jnp.asarray(Y, jnp.int32),
                                 jnp.asarray(Y) > 0, 4, jm.OrdinalConfig(**kw))
    for g, w in zip(got, want):
        _close(g, w, TIGHT)
    _close(tm.ordinal_objective(_t(X), _t(theta), _t(Y), 4,
                                tm.OrdinalConfig(**kw)),
           jm.ordinal_objective(jnp.asarray(X), jnp.asarray(theta),
                                jnp.asarray(Y), 4, jm.OrdinalConfig(**kw)),
           TIGHT)
    np.testing.assert_array_equal(
        tm.predict_ordinal(_t(X), _t(theta), 10).numpy(),
        np.asarray(jm.predict_ordinal(jnp.asarray(X), jnp.asarray(theta), 10)))


@pytest.mark.parametrize("shape", [(12, 15), (15, 12)])
@pytest.mark.parametrize("cfg", [
    dict(adapt_rho=True), dict(adapt_rho=False),
    dict(adapt_rho=True, over_relax=1.6, C=0.7),
    dict(adapt_rho=True, rho=0.05), dict(adapt_rho=True, rho=20.0)])
def test_admm_trajectory_matches_jax(shape, cfg):
    """tol = 0 runs exactly max_iters iterations on both sides. From rho
    0.05 and 20 the residual balancing moves rho (to 0.8 and 1.25 on the
    12 x 15 problem), so W's exit rescale is held too."""
    _, y_obs = _labels(5, *shape)
    kw = dict(max_iters=150, tol=0.0, **cfg)
    jst, jit_ = jm.solve(jnp.asarray(y_obs), jm.MMMFConfig(**kw))
    tst, tit = tm.solve(_t(y_obs), tm.MMMFConfig(**kw))
    assert tit == int(jit_) == 150
    for name in ("X", "Z", "W"):
        _close(getattr(tst, name), getattr(jst, name), TRAJ)


@pytest.fixture(scope="module")
def converged():
    y, y_obs = _labels(6, 12, 10)
    cfg = dict(C=1.0, max_iters=2000, tol=1e-6)
    jst, jit_ = jm.solve(jnp.asarray(y_obs), jm.MMMFConfig(**cfg))
    tst, tit = tm.solve(_t(y_obs), tm.MMMFConfig(**cfg))
    return dict(y=y, y_obs=y_obs, cfg=cfg, jst=jst, tst=tst, jit=int(jit_),
                tit=tit)


def _same_optimum(tst, jst, y_obs, C):
    f_t = float(tm.objective(tst.X, _t(y_obs), C))
    f_j = float(jm.objective(jst.X, jnp.asarray(y_obs), C))
    assert f_t == pytest.approx(f_j, rel=OBJ)
    _close(tst.X, jst.X, XTOL)


def test_converged_solve_matches_jax_cold_and_warm(converged):
    c = converged
    assert 0 < c["tit"] < c["cfg"]["max_iters"]
    _same_optimum(c["tst"], c["jst"], c["y_obs"], 1.0)
    # warm start from the solution of a problem with one more label
    y_obs2 = c["y_obs"].copy()
    i, j = np.argwhere(y_obs2 == 0)[0]
    y_obs2[i, j] = c["y"][i, j]
    jst2, _ = jm.solve(jnp.asarray(y_obs2), jm.MMMFConfig(**c["cfg"]),
                       c["jst"])
    tst2, tit2 = tm.solve(_t(y_obs2), tm.MMMFConfig(**c["cfg"]),
                          convert.mmmf_state(c["jst"], device="cpu"))
    assert tit2 < c["tit"]
    _same_optimum(tst2, jst2, y_obs2, 1.0)


def test_port_solution_passes_the_optimality_certificate():
    """tests/test_mmmf.py's KKT certificate on the port's solution: rho*W
    is a nuclear-norm subgradient at X and in C * d(hinge)."""
    _, y_obs = _labels(0, 12, 10)
    cfg = tm.MMMFConfig(C=1.0, max_iters=6000, tol=1e-9)
    st, _ = tm.solve(_t(y_obs), cfg)
    X, G = st.X.numpy(), st.W.numpy() * cfg.rho
    assert np.linalg.svd(G, compute_uv=False).max() <= 1.0 + 1e-4
    nuc = np.linalg.svd(X, compute_uv=False).sum()
    assert np.vdot(-G, X) == pytest.approx(nuc, rel=1e-3, abs=1e-4)
    obs = y_obs != 0
    assert np.abs(G[~obs]).max() < 1e-4
    s = -(G * y_obs)
    assert (s[obs] >= -1e-4).all() and (s[obs] <= cfg.C + 1e-4).all()
    active = obs & (y_obs * X < 1 - 1e-3)
    assert np.allclose(s[active], cfg.C, atol=1e-3)


@pytest.mark.parametrize("field", ["X", "Z", "W"])
def test_poisoned_warm_start_resolves_cold(converged, field):
    c = converged
    cfg = tm.MMMFConfig(**c["cfg"])
    bad = dict(X=c["tst"].X, Z=c["tst"].Z, W=c["tst"].W)
    bad[field] = bad[field].clone()
    bad[field][0, 0] = torch.nan
    healed, it = tm.solve(_t(c["y_obs"]), cfg, tm.MMMFState(**bad))
    assert torch.isfinite(healed.X).all() and torch.isfinite(healed.W).all()
    if field == "X":  # X is not read by the iteration: a plain warm start
        assert it < c["tit"]
    else:  # the cold solve's own state and count
        assert it == c["tit"]
        for name in ("X", "Z", "W"):
            assert torch.equal(getattr(healed, name),
                               getattr(c["tst"], name))
    _same_optimum(healed, c["jst"], c["y_obs"], cfg.C)


def test_factors_match_jax(converged):
    X = converged["tst"].X
    for rank in (None, 3):
        xu, xv = tm.factors(X, rank)
        ju, jv = jm.factors(jnp.asarray(X.numpy()), rank)
        _close(xu @ xv.T, np.asarray(ju @ jv.T), TIGHT)
        _close((xu * xu).sum(0), np.asarray((ju * ju).sum(0)), TIGHT)
        _close((xv * xv).sum(0), np.asarray((jv * jv).sum(0)), TIGHT)
    xu, xv = tm.factors(X)
    _close(xu @ xv.T, X, 1e-10)


def test_maxnorm_and_ordinal_solvers_match_jax():
    _, y_obs = _labels(7, 8, 6, frac=0.7)
    rng = np.random.default_rng(8)
    U0, V0 = 0.1 * rng.normal(size=(8, 6)), 0.1 * rng.normal(size=(6, 6))
    cfg = dict(C=10.0, max_iters=300, lr0=0.2)
    jst, jobj = jm.solve_maxnorm(jnp.asarray(y_obs), jm.MaxNormConfig(**cfg),
                                 jm.MaxNormState(U=jnp.asarray(U0),
                                                 V=jnp.asarray(V0)))
    tst, tobj = tm.solve_maxnorm(_t(y_obs), tm.MaxNormConfig(**cfg),
                                 convert.maxnorm_state(dict(U=U0, V=V0),
                                                       device="cpu"))
    _close(tst.U, jst.U, TRAJ)
    _close(tst.V, jst.V, TRAJ)
    _close(tst.X, np.asarray(jst.X), TRAJ)
    _close(tobj, jobj, TRAJ)
    # the generator's start: finite, and a warm restart does not get worse
    st, obj = tm.solve_maxnorm(_t(y_obs), tm.MaxNormConfig(**cfg))
    st2, obj2 = tm.solve_maxnorm(_t(y_obs), tm.MaxNormConfig(**cfg), st)
    assert torch.isfinite(obj) and float(obj2) <= float(obj) * 1.05

    Y = _ordinal(9, n=8, m=6, R=3)
    for kw in (dict(C=2.0), dict(C=2.0, all_thresholds=True,
                                 per_row_thresh=True)):
        jxy, jX, jth = jm.solve_ordinal(jnp.asarray(Y), R=3,
                                        cfg=jm.OrdinalConfig(max_iters=150,
                                                             **kw))
        txy, tX, tth = tm.solve_ordinal(_t(Y), R=3,
                                        cfg=tm.OrdinalConfig(max_iters=150,
                                                             **kw))
        _close(tX, jX, TRAJ)
        _close(tth, jth, TRAJ)
        np.testing.assert_array_equal(txy.numpy(), np.asarray(jxy))


def test_binarize_matches_jax():
    real = np.array([[1.0, 3.0, 5.0], [2.0, 0.0, np.nan]])
    np.testing.assert_array_equal(tloop.binarize(real, 3.0),
                                  jloop.binarize(real, 3.0))
    already = np.array([[1.0, -1.0], [0.0, 1.0]])
    np.testing.assert_array_equal(tloop.binarize(already, None), already)
    with pytest.raises(ValueError, match="cutoff"):
        tloop.binarize(real, None)


MARGIN_KEYS = ["min-margin", "max-margin", "min-margin-pos", "max-margin-pos"]
LOOP_CFG = dict(C=1.0, max_iters=200, tol=0.0)


@pytest.fixture(scope="module")
def loop_case():
    y, _ = _labels(10, 8, 10, rank=2)
    known = np.random.default_rng(11).random(y.shape) < 0.3
    jprob = jtypes.problem_from_dense(y, known, dtype=jnp.float64)
    tprob = convert.problem(jprob, device="cpu", dtype=torch.float64)
    return dict(y=y, known=known, jprob=jprob, tprob=tprob)


def _injected_maxnorm(mod, monkeypatch, U0, V0, arr):
    inner = mod.solve_maxnorm

    def solve_maxnorm(Y, cfg, state=None, **kw):
        if state is None:
            state = mod.MaxNormState(U=arr(U0), V=arr(V0))
        return inner(Y, cfg, state, **kw)

    monkeypatch.setattr(mod, "solve_maxnorm", solve_maxnorm)


@pytest.mark.parametrize("mode", ["avg", "max"])
def test_run_active_mmmf_picks_match_jax(loop_case, mode, monkeypatch):
    c = loop_case
    if mode == "max":
        rng = np.random.default_rng(12)
        U0, V0 = 0.1 * rng.normal(size=(8, 8)), 0.1 * rng.normal(size=(10, 8))
        _injected_maxnorm(jm, monkeypatch, U0, V0, jnp.asarray)
        _injected_maxnorm(tm, monkeypatch, U0, V0, _t)
    want = jloop.run_active_mmmf(c["jprob"], c["y"], MARGIN_KEYS, steps=4,
                                 cfg=jm.MMMFConfig(**LOOP_CFG), mode=mode)
    got = tloop.run_active_mmmf(c["tprob"], c["y"], MARGIN_KEYS + ["random"],
                                steps=4, cfg=tm.MMMFConfig(**LOOP_CFG),
                                mode=mode, device="cpu",
                                keep_predictions=True)
    assert got["_rating_vals"] == want["_rating_vals"] == (-1.0, 1.0)
    for k in MARGIN_KEYS:
        assert [r[2] for r in got[k]] == [r[2] for r in want[k]], k
        assert [r[0] for r in got[k]] == [r[0] for r in want[k]], k
        _close([r[1] for r in got[k]], [r[1] for r in want[k]], LOOP)
        for g, w in zip(got[k][1:], want[k][1:]):
            np.testing.assert_array_equal(np.isnan(g[3]), np.isnan(w[3]))
            _close(g[3], w[3], TRAJ)
        assert all(len(r) == 5 and r[4].shape == c["y"].shape for r in got[k])
    pool = c["tprob"].queryable.numpy()
    picks = [r[2] for r in got["random"][1:]]
    assert len(got["random"]) == 4 and len(set(picks)) == 3
    assert all(pool[i, j] for i, j in picks)
    assert all(np.isfinite(r[1]) for r in got["random"])


def test_misclassification_counts_sign_zero_wrong(loop_case):
    """A zero-iteration solve leaves X = 0: every test cell is wrong."""
    c = loop_case
    res = tloop.run_active_mmmf(c["tprob"], c["y"], ["min-margin"], steps=1,
                                cfg=tm.MMMFConfig(max_iters=0), device="cpu")
    assert res["min-margin"][0][1] == 1.0


def test_run_active_mmmf_resumes_from_its_checkpoint(loop_case, tmp_path,
                                                     capsys):
    c = loop_case
    ck = str(tmp_path / "ck.pkl")
    kw = dict(cfg=tm.MMMFConfig(**LOOP_CFG), device="cpu",
              checkpoint_path=ck, verbose=True)
    first = tloop.run_active_mmmf(c["tprob"], c["y"], ["min-margin"],
                                  steps=2, **kw)
    with open(ck, "rb") as f:
        saved = pickle.load(f)
    assert saved["_era"] == tm.SOLVER_ERA and len(saved["min-margin"]) == 2
    capsys.readouterr()
    again = tloop.run_active_mmmf(c["tprob"], c["y"], ["min-margin"],
                                  steps=3, **kw)
    assert "resumed at step 1" in capsys.readouterr().out
    recs = again["min-margin"]
    assert [r[:3] for r in recs[:2]] == [r[:3] for r in first["min-margin"]]
    assert len(recs) == 3 and recs[2][2] not in [r[2] for r in recs[:2]]
    assert c["tprob"].queryable.numpy()[recs[2][2]]


def test_active_mmmf_cli_writes_the_jax_layout(loop_case, tmp_path):
    from amf_tpu.run import active_mmmf as jcli
    from amf_tpu_torch.run import active_mmmf as tcli

    c = loop_case
    data = str(tmp_path / "data.npz")
    save_npz_schema(data, {"_real": c["y"], "_known": c["known"]})
    argv = ["--load-data", data, "-s", "3", "--admm-iters", "150",
            "--admm-tol", "1e-30", "--no-verbose", "min-margin",
            "max-margin-pos"]
    jout, tout = str(tmp_path / "j.pkl"), str(tmp_path / "t.pkl")
    jcli.main(argv + ["--save-results", jout])
    tcli.main(argv + ["--save-results", tout, "--device", "cpu"])
    with open(jout, "rb") as f:
        want = pickle.load(f)
    with open(tout, "rb") as f:
        got = pickle.load(f)
    assert set(got) == set(want)
    assert got["_kind"] == "mmmf" and got["_solver_era"] == want["_solver_era"]
    assert set(got["_args"]) - set(want["_args"]) == {"device"}
    for k in ("mmmf_min-margin", "mmmf_max-margin-pos"):
        assert [r[2] for r in got[k]] == [r[2] for r in want[k]]
        _close([r[1] for r in got[k]], [r[1] for r in want[k]], LOOP)
    with pytest.raises(SystemExit):
        tcli.main(["--load-data", data, "--device", "cpu", "nope"])


def test_sdpa_writer_matches_jax_and_reader_round_trips(tmp_path):
    rng = np.random.default_rng(7)
    Y = np.sign(rng.normal(size=(5, 2)) @ rng.normal(size=(4, 2)).T)
    Y[rng.random((5, 4)) > 0.7] = 0.0
    n, m = Y.shape
    p = int((Y != 0).sum())
    for mode, C in (("a", 1.5), ("m", 1.5), ("a", float("inf"))):
        got, want = io.StringIO(), io.StringIO()
        tsdpa.write_sdpa(got, Y, mode, C=C, comment="x")
        jsdpa.write_sdpa(want, Y, mode, C=C, comment="x")
        g, w = got.getvalue().splitlines(), want.getvalue().splitlines()
        assert "amf_tpu_torch.models.sdpa_io" in g[2]
        assert g[:2] + g[3:] == w[:2] + w[3:] and len(g) == len(w)
    fn = tsdpa.write_sdpa(str(tmp_path / "prob"), Y, "a", C=1.5)
    assert fn.endswith("prob.avg_1.5.dat-s")

    st, _ = tm.solve(_t(Y), tm.MMMFConfig(C=1.5, max_iters=500))
    X = st.X.numpy()
    xu, xv = (a.numpy() for a in tm.factors(st.X))
    G = np.block([[xu @ xu.T, X], [X.T, xv @ xv.T]])
    sol = tmp_path / "prob.sol"
    with open(sol, "w") as f:
        f.write(" ".join(["0.0"] * p) + "\n")
        for i in range(n + m):
            for j in range(i, n + m):
                if G[i, j] != 0:
                    f.write(f"2 1 {i + 1} {j + 1} {G[i, j]:.12f}\n")
    x2, xu2, xv2, q = tsdpa.read_sdpa_solution(str(sol), n)
    np.testing.assert_allclose(x2, X, atol=1e-9)
    np.testing.assert_allclose(xu2 @ xv2.T, X, atol=1e-6)
    assert q.shape == (p,)
