"""Checkpoint/resume and replay in the port (amf_tpu_torch/utils/
checkpoint.py, active/driver.py), mirroring
tests/test_quadrature_checkpoint.py for the JAX package.

The checkpointer round-trips, guards the problem's fingerprint (the JAX
package's fingerprint of the same problem) and the sampler era, and strips
eval matrices. A run resumed from a checkpoint draws the uninterrupted
run's step seeds, so its picks equal that run's for a criterion whose
picks follow from the seeds (``random``), in the Gibbs, ActivePMF and
NUTS loops; a replay of a run's picks reproduces its err trace.
"""

import os

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a worker)
from amf_tpu_torch import types as ttypes
from amf_tpu_torch.data.synthetic import make_fake_data
from amf_tpu_torch.utils.checkpoint import LoopCheckpointer, problem_fingerprint


def _problem(real, known):
    return ttypes.problem_from_dense(real, known, dtype=torch.float64,
                                     device="cpu")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return make_fake_data(num_users=6, num_items=6, rank=2, data_type=5,
                          mask_type="diag", rng=rng)


def test_checkpointer_roundtrip(tmp_path):
    path = str(tmp_path / "ck.pkl")
    real = np.arange(16, dtype=float).reshape(4, 4) + 1
    prob = _problem(real, np.eye(4, dtype=bool))
    ck = LoopCheckpointer(path, every=1)
    records = [(4, 1.0, None, None), (5, 0.9, (0, 1), None),
               (6, 0.8, (2, 3), None)]
    ck.update("pred-variance", records, force=True)

    prob2, recs = LoopCheckpointer(path).replay("pred-variance", prob, real)
    assert len(recs) == 3
    assert bool(prob2.rated[0, 1]) and bool(prob2.rated[2, 3])
    assert float(prob2.R_obs[0, 1]) == real[0, 1]
    assert int(prob2.n_rated) == 6
    prob3, recs3 = LoopCheckpointer(path).replay("random", prob, real)
    assert recs3 == [] and int(prob3.n_rated) == 4
    with pytest.raises(ValueError, match="out of bounds"):
        LoopCheckpointer(path).replay("pred-variance",
                                      _problem(real[:2, :2], np.eye(2) > 0),
                                      real)


def test_fingerprint_matches_jax_and_guards_the_problem(tmp_path):
    """The port's fingerprint of a Problem of tensors is the JAX package's
    of the same arrays, so either package resumes the other's files."""
    from amf_tpu.utils import checkpoint as jck

    real_a = np.arange(16, dtype=float).reshape(4, 4) + 1
    rated = np.eye(4, dtype=bool)
    test = ~rated
    prob = ttypes.problem_from_dense(real_a, rated, test=test,
                                     device="cpu")
    fa = problem_fingerprint(real_a, prob.rated, prob.test)
    assert fa == jck.problem_fingerprint(real_a, rated, test)
    path = str(tmp_path / "fp.pkl")
    ck = LoopCheckpointer.for_problem(path, prob, real_a)
    assert ck.fingerprint == fa
    ck.update("random", [(4, 1.0, None, None)], force=True)
    LoopCheckpointer(path, fingerprint=fa)
    with pytest.raises(ValueError, match="different problem"):
        LoopCheckpointer(
            path, fingerprint=problem_fingerprint(real_a + 1.0, rated, test))
    with pytest.raises(ValueError, match="different problem"):
        LoopCheckpointer(path, fingerprint=problem_fingerprint(
            real_a, rated, np.roll(test, 1, axis=0)))
    assert LoopCheckpointer.for_problem(None, prob, real_a).fingerprint is None


def test_checkpoint_era_guard(tmp_path):
    """A checkpoint of another sampler era is moved aside and the run
    re-records; era-less checkpoints count as 'pre-era'."""
    from amf_tpu_torch.mcmc.nuts import SAMPLER_ERA

    path = str(tmp_path / "era.pkl")
    ck = LoopCheckpointer(path, era=SAMPLER_ERA)
    ck.update("random", [(4, 1.0, None, None)], force=True)
    assert LoopCheckpointer(path, era=SAMPLER_ERA).completed_records("random")
    assert LoopCheckpointer(path).completed_records("random")
    ck2 = LoopCheckpointer(path, era=SAMPLER_ERA + "-next")
    assert ck2.completed_records("random") is None
    assert not os.path.exists(path) and os.path.exists(path + ".stale-era")

    legacy = str(tmp_path / "legacy.pkl")
    LoopCheckpointer(legacy).update("random", [(4, 1.0, None, None)],
                                    force=True)
    assert LoopCheckpointer(legacy, era=SAMPLER_ERA).completed_records(
        "random") is None
    assert os.path.exists(legacy + ".stale-era")


def test_checkpoint_strips_eval_matrices_and_writes_every_k(tmp_path):
    path = str(tmp_path / "slim.pkl")
    ck = LoopCheckpointer(path, every=2)
    big = np.ones((50, 50))
    ck.update("k", [(4, 1.0, None, None), (5, 0.9, (0, 1), big)])
    assert not os.path.exists(path)  # step 1 of every 2
    ck.update("k", [(4, 1.0, None, None), (5, 0.9, (0, 1), big),
                    (6, 0.8, (1, 1), big)])
    recs = LoopCheckpointer(path).completed_records("k")
    assert len(recs) == 3 and recs[1][3] is None and recs[2][3] is None


def _resume_case(run, tmp_path, name, **kw):
    """(uninterrupted run, run stopped at step 3 and resumed to 5)."""
    full = run(steps=5, **kw)["random"]
    ck = str(tmp_path / f"{name}.pkl")
    run(steps=3, checkpoint_path=ck, **kw)
    resumed = run(steps=5, checkpoint_path=ck, **kw)["random"]
    return full, resumed


def _same_trace(full, resumed):
    assert [r[2] for r in resumed] == [r[2] for r in full]
    assert [r[0] for r in resumed] == [r[0] for r in full]
    # the replayed records are the interrupted run's own
    assert [r[1] for r in resumed[:3]] == [r[1] for r in full[:3]]
    assert all(np.isfinite(r[1]) for r in resumed)


def test_gibbs_resume_continues_the_seed_stream(tmp_path, data):
    from amf_tpu_torch.active.gibbs_loop import run_active_gibbs

    real, known, vals = data

    def run(**kw):
        return run_active_gibbs(_problem(real, known), real, ["random"],
                                latent_d=2, rating_values=vals, num_samps=8,
                                seed=0, device="cpu", **kw)

    _same_trace(*_resume_case(run, tmp_path, "gibbs"))


def test_active_pmf_resume_continues_the_seed_stream(tmp_path, data):
    from amf_tpu_torch.active.loop import run_active_pmf

    real, known, vals = data

    def run(**kw):
        return run_active_pmf(_problem(real, known), real, ["random"],
                              latent_d=2, rating_values=vals, seed=0,
                              device="cpu", **kw)

    full, resumed = _resume_case(run, tmp_path, "apmf")
    _same_trace(full, resumed)
    # a resume asking for fewer steps than the checkpoint holds stops there
    small = run(steps=2, checkpoint_path=str(tmp_path / "apmf.pkl"))
    assert [r[2] for r in small["random"]] == [r[2] for r in full[:2]]


def test_stan_resume_continues_the_seed_stream(tmp_path, data):
    from amf_tpu_torch.active.stan_loop import run_active_stan
    from amf_tpu_torch.models.bpmf_hmc import HMCConfig

    real, known, vals = data

    def run(**kw):
        return run_active_stan(
            _problem(real, known), real, ["random"], latent_d=2,
            rating_values=vals, num_samps=6, warmup=6, seed=0,
            cfg=HMCConfig(latent_d=2, max_depth=4), device="cpu", **kw)

    _same_trace(*_resume_case(run, tmp_path, "stan"))


def test_finished_criterion_resumes_without_a_refit(tmp_path, data):
    """A checkpoint that holds the whole budget gives its records back and
    runs no refit (the state would otherwise draw a new chain)."""
    from amf_tpu_torch.active import driver

    real, known, _ = data
    prob = _problem(real, known)
    calls = []
    family = driver.Family(
        nice_name=str,
        score=lambda k, st, p, s: (torch.rand(p.shape, dtype=torch.float64,
                                              generator=torch.Generator()
                                              .manual_seed(s)), True),
        refit=lambda st, p, s: calls.append(s) or st,
        err=lambda st, p: float(p.n_rated))
    ck = str(tmp_path / "done.pkl")
    first = driver.drive_active(prob, real, ["a"], family, None, 0, steps=4,
                                ckpt=LoopCheckpointer(ck))
    n_refits = len(calls)
    again = driver.drive_active(prob, real, ["a"], family, None, 0, steps=4,
                                ckpt=LoopCheckpointer(ck))
    assert len(calls) == n_refits == 3
    assert [r[:3] for r in again["a"]] == [r[:3] for r in first["a"]]


def test_replay_reproduces_a_runs_err_trace(data):
    """Replaying a run's picks skips scoring and refits under the original
    step seeds: the same err trace, exactly, on the same device."""
    from amf_tpu_torch.active.gibbs_loop import run_active_gibbs

    real, known, vals = data
    kw = dict(latent_d=2, rating_values=vals, num_samps=8, steps=4, seed=3,
              device="cpu")
    first = run_active_gibbs(_problem(real, known), real, ["pred-variance"],
                             **kw)["pred-variance"]
    picks = [r[2] for r in first]
    again = run_active_gibbs(_problem(real, known), real, ["pred-variance"],
                             replay={"pred-variance": picks},
                             **kw)["pred-variance"]
    assert [r[:3] for r in again] == [r[:3] for r in first]
    assert all(r[3] is None for r in again)
