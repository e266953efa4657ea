"""The port's ActivePMF loop, its command line and its flagship step
(amf_tpu_torch/active/loop.py, run/active_pmf.py, entry.py) against the JAX
package's, in float64 on a 5 x 4 problem, d = 2, budgets of 12.

Both loops start from the same initial state (the JAX package's, carried
across by ``convert``), so every criterion without random draws picks the
same cells, and the RMSEs and criterion maps agree to 1e-8 relative. The
carried numpy/scipy metrics give the JAX package's numbers exactly.
"""

import pickle

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a worker)
from amf_tpu_torch import convert
from amf_tpu_torch import types as ttypes
from amf_tpu_torch.active import loop as tloop

RTOL = 1e-8
N, M, D = 5, 4, 2
BUDGET = 12


@pytest.fixture(scope="module")
def case():
    import jax
    import jax.numpy as jnp

    from amf_tpu import types as jtypes
    from amf_tpu.active import loop
    from amf_tpu.data import make_fake_data
    from amf_tpu.models import mnormal, pmf, vnormal

    rng = np.random.default_rng(3)
    real, known, vals = make_fake_data(num_users=N, num_items=M, rank=D,
                                       mask_type=0.4, data_type=4, rng=rng)
    jprob = jtypes.problem_from_dense(real, known, dtype=jnp.float64)
    pcfg = pmf.PMFConfig(latent_d=D)
    jst = pmf.init_state(jax.random.PRNGKey(0), N, M, pcfg, jprob,
                         dtype=jnp.float64)
    jst, _ = pmf.fit(jst, jprob, pcfg)
    vcfg = vnormal.VNConfig(latent_d=D)
    jvn, _ = vnormal.fit_normal(
        vnormal.initialize_approx(jax.random.PRNGKey(1), jst, vcfg), jst,
        jprob, vcfg)
    mcfg = mnormal.MNConfig(latent_d=D)
    jmn, _ = mnormal.fit_normal(mnormal.initialize_approx(jst, mcfg), jst,
                                jprob, mcfg)
    return dict(jnp=jnp, loop=loop, real=real, known=known, vals=vals,
                jprob=jprob, jst=jst, jvn=jvn, jmn=jmn)


def _compare(got, want, keys):
    for k in keys:
        assert len(got[k]) == len(want[k])
        for g, w in zip(got[k], want[k]):
            assert g[0] == w[0] and g[2] == w[2], (k, g[:3], w[:3])
            np.testing.assert_allclose(g[1], float(w[1]), rtol=RTOL)
            if w[3] is None:
                assert g[3] is None
                continue
            assert np.array_equal(np.isnan(g[3]), np.isnan(w[3]))
            ok = ~np.isnan(w[3])
            np.testing.assert_allclose(g[3][ok], w[3][ok], rtol=RTOL)


@pytest.mark.parametrize("model,keys,steps", [
    ("vn", ["pred-variance", "prob-ge-3.5", "total-variance"], 3),
    ("mn", ["pred", "uv-entropy-approx"], 2),
])
def test_loop_matches_jax_from_the_same_initial_state(case, model, keys,
                                                      steps):
    jax_ast = case["jvn"] if model == "vn" else case["jmn"]
    kw = dict(latent_d=D, rating_values=case["vals"], discrete_exp=True,
              steps=steps, seed=0, model=model, lookahead_budget=BUDGET)
    want = case["loop"].run_active_pmf(
        case["jprob"], case["real"], keys, initial_state=(case["jst"], jax_ast),
        dtype=case["jnp"].float64, **kw)
    to_port = convert.vn_state if model == "vn" else convert.mn_state
    init = (convert.pmf_state(case["jst"], device="cpu"),
            to_port(jax_ast, device="cpu"))
    got = tloop.run_active_pmf(
        convert.problem(case["jprob"], device="cpu"), case["real"], keys,
        initial_state=init, dtype=torch.float64, device="cpu", **kw)
    _compare(got, want, keys)
    assert got["_rating_vals"] == tuple(case["vals"])
    np.testing.assert_array_equal(got["_ratings"], want["_ratings"])


def test_loop_from_its_own_fit_runs_every_kind_of_criterion(case):
    """No initial state: the port's own MAP and KL fits; a random, a
    direct and a lookahead criterion with the refit on, the Cholesky
    descent; records in the reference schema."""
    prob = ttypes.problem_from_dense(case["real"], case["known"],
                                     dtype=torch.float64, device="cpu")
    keys = ["random", "prob-ge-.5", "1step-ge-.5-approx"]
    res = tloop.run_active_pmf(
        prob, case["real"], keys, latent_d=D, rating_values=case["vals"],
        discrete_exp=True, refit_lookahead=True, fit_sigmas=True, steps=3,
        lookahead_budget=BUDGET, lookahead_tile=2, cov_param="chol",
        device="cpu")
    pool = np.asarray(prob.queryable)
    for k in keys:
        recs = res[k]
        assert [r[0] for r in recs] == [recs[0][0] + s for s in range(3)]
        assert recs[0][2] is None and recs[0][3] is None
        for n_rated, err, (i, j), evals in recs[1:]:
            assert np.isfinite(err) and evals.shape == (N, M)
            assert np.isnan(evals[~pool]).all() and pool[i, j]
        assert len({r[2] for r in recs[1:]}) == 2
    with pytest.raises(ValueError, match="unknown criterion"):
        tloop.run_active_pmf(prob, case["real"], ["pred-entropy-bound"],
                             model="mn", device="cpu")


def test_cli_runs_on_the_cpu_saves_and_reloads_its_model(tmp_path, capsys):
    from amf_tpu_torch.run import active_pmf

    out = tmp_path / "res.pkl"
    argv = ["--device", "cpu", "-N", str(N), "-M", str(M), "-D", str(D),
            "-R", str(D), "--mask", "0.4", "--type", "4", "-s", "2",
            "--lookahead-budget", str(BUDGET), "--discrete-integration",
            "--save-results", str(out), "pred-variance", "total-variance"]
    first = active_pmf.main(argv)
    with open(out, "rb") as f:
        saved = pickle.load(f)
    assert saved["_kind"] == "apmf"
    assert {"pred-variance", "total-variance", "_real", "_ratings",
            "_rating_vals", "_initial_state", "_args"} <= set(saved)
    pst, ast = saved["_initial_state"]
    assert set(pst) == {"U", "V", "sigma_sq", "sigma_u_sq", "sigma_v_sq",
                        "mean_rating"} and set(ast) == {"mean", "cov"}
    assert all(len(saved[k]) == 2 for k in ("pred-variance", "total-variance"))
    again = active_pmf.main(argv[:-2] + ["--load-model", str(out),
                                         "--no-save-results", "pred-variance"])
    assert "reusing initial model" in capsys.readouterr().out
    # the reloaded initial state gives the first run's records
    assert [r[:3] for r in again["pred-variance"]] == [
        r[:3] for r in first["pred-variance"]]


def test_entry_step_matches_the_jax_step_on_converted_inputs():
    """``__graft_entry__.entry()``'s step and the port's, both in float64
    on the JAX package's inputs; and the port's own entry on the CPU."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__
    from amf_tpu_torch import entry

    fn, (jpst, jast, jprob) = __graft_entry__.entry()

    def f64(x):
        return x.astype(jnp.float64) if jnp.issubdtype(
            x.dtype, jnp.floating) else x

    jpst, jast, jprob = (jax.tree.map(f64, x) for x in (jpst, jast, jprob))
    want = np.asarray(fn(jpst, jast, jprob))
    got = entry.step(convert.pmf_state(jpst, device="cpu"),
                     convert.vn_state(jast, device="cpu"),
                     convert.problem(jprob, device="cpu")).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=RTOL)

    step, args = entry.entry("cpu")
    scores = step(*args)
    queryable = args[2].queryable
    assert scores.shape == (16, 12) and scores.dtype == torch.float32
    assert bool(torch.isfinite(scores[queryable]).all())
    assert bool((scores[~queryable] == -torch.inf).all())


def test_carried_metrics_give_the_jax_package_numbers():
    from amf_tpu.analysis import metrics as jm

    from amf_tpu_torch.analysis import metrics as tm

    rng = np.random.default_rng(8)
    scores = np.round(rng.normal(size=40), 1)  # ties
    labels = rng.random(40) < 0.4
    draws = rng.normal(size=(3, 50, 2)).cumsum(axis=1)
    assert tm.auc_roc(scores, labels) == jm.auc_roc(scores, labels)
    assert tm.kendall_tau(scores, -scores + labels) == jm.kendall_tau(
        scores, -scores + labels)
    xs = np.arange(10.0)
    assert tm.area_under_curve(xs, xs ** 2) == jm.area_under_curve(xs, xs ** 2)
    np.testing.assert_array_equal(tm.split_rhat(draws), jm.split_rhat(draws))
    np.testing.assert_array_equal(tm.ess(draws), jm.ess(draws))
    assert tm.split_rhat(draws[..., 0]) == jm.split_rhat(draws[..., 0])
