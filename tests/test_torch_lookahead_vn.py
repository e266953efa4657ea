"""The port's variational lookahead (amf_tpu_torch/active/lookahead.py)
against the JAX package's ``lookahead_scores``, in float64 on a 5 x 4
problem, d = 2, three candidates (one of them rated: NaN), budgets of 12.

Every statistic (total variance, U/V entropy, the prediction-entropy
bound, 1-step >= cutoff), both expectations (MAP and approximation), the
three integrations (sum, simps, continuous) and the lookahead refit off and
on are held to 1e-8 relative; with the refit on, each lane's fresh
covariance starts from the JAX package's own lane noise (``lane_keys``).
Tiling the candidates changes nothing, also with the port's own lane noise.
"""

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a worker)
from amf_tpu_torch import convert
from amf_tpu_torch.active import criteria as tcrit
from amf_tpu_torch.active import lookahead as tla
from amf_tpu_torch.models import mnormal as tmn
from amf_tpu_torch.models import pmf as tpmf
from amf_tpu_torch.models import vnormal as tvn

RTOL = 1e-8
N, M, D = 5, 4, 2
BUDGET, NODES = 12, 4


@pytest.fixture(scope="module")
def case():
    """Fitted JAX PMF, VN and MN states, their port copies, and three
    candidates: two queryable cells and one rated cell."""
    import jax
    import jax.numpy as jnp

    from amf_tpu import types as jtypes
    from amf_tpu.active import lookahead
    from amf_tpu.data import make_fake_data
    from amf_tpu.models import mnormal, pmf, vnormal
    from amf_tpu.utils.rng import lane_keys

    rng = np.random.default_rng(7)
    real, known, vals = make_fake_data(num_users=N, num_items=M, rank=D,
                                       mask_type=0.4, data_type=4, rng=rng)
    jprob = jtypes.problem_from_dense(real, known, dtype=jnp.float64)
    pcfg = pmf.PMFConfig(latent_d=D, max_fit_steps=200)
    jst = pmf.init_state(jax.random.PRNGKey(0), N, M, pcfg, jprob,
                         dtype=jnp.float64)
    jst, _ = pmf.fit(jst, jprob, pcfg)
    vcfg = vnormal.VNConfig(latent_d=D, max_fit_steps=30)
    jvn = vnormal.initialize_approx(jax.random.PRNGKey(1), jst, vcfg)
    jvn, _ = vnormal.fit_normal(jvn, jst, jprob, vcfg)
    mcfg = mnormal.MNConfig(latent_d=D, max_fit_steps=30)
    jmn, _ = mnormal.fit_normal(mnormal.initialize_approx(jst, mcfg), jst,
                                jprob, mcfg)
    flat_q = np.flatnonzero(np.asarray(jprob.queryable).ravel())
    flat_r = np.flatnonzero(np.asarray(jprob.rated).ravel())
    cand = np.asarray([flat_q[0], flat_r[0], flat_q[-1]], np.int32)
    f64 = dict(device="cpu", dtype=torch.float64)

    def lane_noise(key, n_vals):
        k = (N + M) * D
        keys = lane_keys(key, jnp.asarray(cand), n_vals)
        draw = jax.vmap(jax.vmap(
            lambda kk: jax.random.normal(kk, (k, k), dtype=jnp.float64)))
        return torch.as_tensor(np.array(draw(keys)))

    return dict(
        jax=jax, jnp=jnp, lookahead=lookahead, vals=vals, jprob=jprob,
        pcfg=pcfg, jst=jst, vcfg=vcfg, jvn=jvn, mcfg=mcfg, jmn=jmn,
        cand=cand, lane_noise=lane_noise, prob=convert.problem(jprob, **f64),
        st=convert.pmf_state(jst, **f64), vn=convert.vn_state(jvn, **f64),
        mn=convert.mn_state(jmn, **f64))


def _configs(case, discretize, refit):
    from amf_tpu.active.lookahead import LookaheadConfig

    jl = LookaheadConfig(
        rating_values=tuple(case["vals"]) if discretize != "continuous" else (),
        refit_lookahead=refit, discretize=discretize,
        n_integration_nodes=NODES, pmf_refit_steps=BUDGET,
        approx_refit_steps=BUDGET)
    return jl, tla.LookaheadConfig(**jl._asdict())


def _compare(got, want):
    want = np.asarray(want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[1]), "a rated candidate scores NaN"
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=RTOL)


@pytest.mark.parametrize("name,discretize,refit", [
    ("total-variance", "sum", False),
    ("uv-entropy", "sum", False),
    ("uv-entropy-approx", "simps", False),
    ("pred-entropy-bound", "sum", False),
    ("pred-entropy-bound-approx", "continuous", False),
    ("1step-ge-3.5", "sum", False),
    ("1step-ge-3.5-approx", "sum", True),
    ("total-variance", "continuous", True),
    ("total-variance-approx", "simps", True),
])
def test_vn_lookahead_matches_jax(case, name, discretize, refit):
    jax = case["jax"]
    from amf_tpu.active.criteria import KEY_FUNCS

    jl, tl = _configs(case, discretize, refit)
    key = jax.random.PRNGKey(5)
    want = case["lookahead"].lookahead_scores(
        KEY_FUNCS[name], case["jst"], case["jvn"], case["jprob"], key,
        case["pcfg"], case["lookahead"].vn_adapter(case["vcfg"]), jl,
        cand=case["jnp"].asarray(case["cand"]))
    noise = None
    if refit:
        n_vals = NODES if discretize == "continuous" else len(case["vals"])
        noise = case["lane_noise"](key, n_vals)
    got = tla.lookahead_scores(
        tcrit.KEY_FUNCS[name], case["st"], case["vn"], case["prob"], 5,
        tpmf.PMFConfig(**case["pcfg"]._asdict()),
        tla.vn_adapter(tvn.VNConfig(**case["vcfg"]._asdict())), tl,
        cand=torch.as_tensor(case["cand"]), noise=noise)
    _compare(got.numpy(), want)


@pytest.mark.parametrize("name,refit", [("uv-entropy", True)])
def test_mn_lookahead_matches_jax(case, name, refit):
    from amf_tpu.active.criteria import MN_KEY_FUNCS

    jl, tl = _configs(case, "sum", refit)
    want = case["lookahead"].lookahead_scores(
        MN_KEY_FUNCS[name], case["jst"], case["jmn"], case["jprob"],
        case["jax"].random.PRNGKey(5), case["pcfg"],
        case["lookahead"].mn_adapter(case["mcfg"]), jl,
        cand=case["jnp"].asarray(case["cand"]))
    got = tla.lookahead_scores(
        tcrit.MN_KEY_FUNCS[name], case["st"], case["mn"], case["prob"], 5,
        tpmf.PMFConfig(**case["pcfg"]._asdict()),
        tla.mn_adapter(tmn.MNConfig(**case["mcfg"]._asdict())), tl,
        cand=torch.as_tensor(case["cand"]))
    _compare(got.numpy(), want)


@pytest.mark.parametrize("cov_param", ["psd-project", "chol"])
def test_tiles_and_lane_streams_do_not_change_the_scores(case, cov_param):
    """With the refit on and the port's own lane noise (keyed by each lane's
    global candidate index), tiles of one candidate give the scores of one
    tile of all, and scoring all cells gives the same on the candidates."""
    _, tl = _configs(case, "sum", True)
    args = (tcrit.KEY_FUNCS["total-variance"], case["st"], case["vn"],
            case["prob"], 9, tpmf.PMFConfig(**case["pcfg"]._asdict()),
            tla.vn_adapter(tvn.VNConfig(latent_d=D, cov_param=cov_param)))
    cand = torch.as_tensor(case["cand"])
    whole = tla.lookahead_scores(*args, tl, cand=cand)
    tiled = tla.lookahead_scores(*args, tl._replace(candidate_tile=1),
                                 cand=cand)
    every = tla.lookahead_scores(*args, tl._replace(candidate_tile=7))
    assert whole.shape == (3,) and every.shape == (N * M,)
    np.testing.assert_allclose(tiled.numpy(), whole.numpy(), rtol=1e-12)
    np.testing.assert_allclose(every[cand].numpy(), whole.numpy(), rtol=1e-12)
    assert bool(torch.isfinite(whole[[0, 2]]).all())
