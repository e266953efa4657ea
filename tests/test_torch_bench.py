"""The port's bench (``amf_tpu_torch/bench.py``) against the JAX package's
``bench.py`` and the JAX package, on the CPU.

- The problem (ratings, known and queryable masks, R_obs) and the headline's
  and the refit row's candidates equal what the JAX path builds, bit for
  bit, at a small shape and at ``bench.py``'s host shape; the vn problem
  too.
- The numpy pool lane equals ``bench.py``'s ``_pool_gibbs_lane`` bit for
  bit (both at 2 samples).
- Every row runs at a tiny shape and gives finite, positive rates; the line
  ``main`` prints has ``bench.py``'s keys plus ``device``, a consistent
  ``vs_baseline`` and, on the CPU, no refit row.
- A non-finite score refuses its row: the headline raises, a vn row lands
  in ``secondary_bench_faults``.
- Without a card and without ``--device cpu`` the bench exits non-zero and
  prints no line; the pool's module (and the bench's) import no torch.
"""

import ast
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a worker)
from amf_tpu import types as jtypes
from amf_tpu.data import make_fake_data as jax_make_fake_data
from amf_tpu_torch import bench, bench_pool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
# every row at a tiny shape: the headline on 20 x 30 with 2 candidates, the
# vn rows on 6 x 6, the refit row on 16 candidates in tiles of 8
TINY = dataclasses.replace(
    bench.CARD, n=20, m=30, d=3, known=120.0, n_cand=2, tile=2,
    base_samps=8, la_samps=3, pk_n_cand=16, pk_tile=8, vn_n=6,
    vn_pmf_steps=20, vn_fit_steps=10, vn_refit_steps=5, vn_nodes=2,
    vn_tile=4)
POOL_PROCS = 2


def _jax_bench():
    """The root ``bench.py`` as a module (it imports numpy alone at import
    time; JAX only inside its row functions)."""
    spec = importlib.util.spec_from_file_location(
        "_jax_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_problem(n, m, d):
    """``bench.py:340-352`` through the JAX package."""
    rng = np.random.default_rng(0)
    real, known, _ = jax_make_fake_data(
        num_users=n, num_items=m, rank=d, noise=0.5,
        mask_type=0.05 * 100000 / (n * m), rng=rng)
    real = np.clip(np.round(real - real.mean() + 3.0), 1.0, 5.0)
    prob = jtypes.problem_from_dense(real, known)
    return real, known, prob


# ---------------------------------------------------------------------------
# (a) the problem and the candidates


@pytest.mark.parametrize("shape", [(60, 120), (189, 336)])
def test_problem_and_candidates_equal_the_jax_path(shape):
    n, m = shape
    w = dataclasses.replace(bench.HOST, n=n, m=m)
    real, known, prob = bench.make_problem(w, CPU)
    jreal, jknown, jprob = _jax_problem(n, m, w.d)
    assert np.array_equal(real, jreal)
    assert np.array_equal(known, jknown)
    queryable = prob.queryable.numpy()
    jq = np.asarray(jprob.queryable)
    assert np.array_equal(queryable, jq)
    assert np.array_equal(prob.rated.numpy(), np.asarray(jprob.rated))
    # bench.py casts every float leaf to float32
    jr = np.asarray(jprob.R_obs).astype(np.float32)
    assert prob.R_obs.dtype == torch.float32
    assert np.array_equal(prob.R_obs.numpy().view(np.int32), jr.view(np.int32))
    # the headline's cells (bench.py:132-133), the refit row's (:259-260)
    assert np.array_equal(bench.headline_cells(queryable, w.n_cand),
                          np.flatnonzero(jq.ravel())[:w.n_cand])
    assert np.array_equal(
        bench.refit_cells(queryable, w.pk_n_cand),
        np.argsort(~jq.ravel(), kind="stable")[:w.pk_n_cand])
    assert len(bench.headline_cells(queryable, w.n_cand)) == w.n_cand


def test_vn_problem_equals_the_jax_path():
    """``bench.py:196-200``: 24 x 24, rank 2, mask 0.2, default_rng(1)."""
    w = bench.CARD
    real, prob = bench.vn_problem(w, CPU)[:2]
    rng = np.random.default_rng(1)
    jreal, jknown, _ = jax_make_fake_data(
        num_users=24, num_items=24, rank=2, mask_type=0.2, rng=rng)
    jprob = jtypes.problem_from_dense(jreal, jknown)
    assert np.array_equal(real, jreal)
    assert np.array_equal(prob.rated.numpy(), np.asarray(jprob.rated))
    assert np.array_equal(prob.queryable.numpy(),
                          np.asarray(jprob.queryable))


# ---------------------------------------------------------------------------
# (b) the pool lane


def test_pool_lane_equals_bench_py(monkeypatch):
    jb = _jax_bench()
    monkeypatch.setattr(jb, "LA_SAMPS", 2)
    monkeypatch.setattr(bench_pool, "LA_SAMPS", 2)
    monkeypatch.setattr(bench_pool, "_G", {})
    n, m, d = 12, 15, 3
    rng = np.random.default_rng(5)
    U0, V0 = rng.normal(size=(n, d)), rng.normal(size=(m, d))
    rated = rng.random((n, m)) < 0.3
    r_obs = np.where(rated, rng.integers(1, 6, (n, m)), 0).astype(np.float64)
    for mod in (jb, bench_pool):
        mod._pool_init(U0, V0, rated, r_obs, 2.0)
    for args in ((0, 0, 1.0, 0), (3, 7, 4.0, 5), (11, 14, 5.0, 9)):
        want = jb._pool_gibbs_lane(args)
        got = bench_pool._pool_gibbs_lane(args)
        assert isinstance(got, float) and got == want, (args, got, want)


# ---------------------------------------------------------------------------
# (c), (d) the rows and the line


@pytest.fixture(scope="module")
def cpu_run():
    """``main(["--device", "cpu"])`` with the host workload cut to TINY and
    the pool to two processes: (the printed line, the line ``run`` gave,
    its rows, the workload)."""
    kept = {}
    inner = bench.run

    def run(w, device, **kw):
        line, rows = inner(w, device, procs=POOL_PROCS, **kw)
        kept.update(w=w, line=line, rows=rows)
        return line, rows

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "HOST", TINY)
        mp.setattr(bench, "run", run)
        with contextlib.redirect_stdout(out):
            rc = bench.main(["--device", "cpu"])
    assert rc == 0
    printed = out.getvalue().strip().splitlines()
    assert len(printed) == 1
    return json.loads(printed[0]), kept["line"], kept["rows"], kept["w"]


def _bench_py_keys():
    """The keys of the JSON object ``bench.py``'s main prints: (always,
    when a secondary row faulted)."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    line = next(n for n in ast.walk(main) if isinstance(n, ast.Dict)
                and any(isinstance(k, ast.Constant) and k.value == "metric"
                        for k in n.keys))
    always = {k.value for k in line.keys if k is not None}
    faults = {k.value for n in ast.walk(line) if isinstance(n, ast.Dict)
              and n is not line for k in n.keys if k is not None}
    return always, faults


def test_rows_give_finite_positive_rates(cpu_run):
    _, _, rows, w = cpu_run
    head = rows["gibbs"]
    assert head["value"] > 0 and head["device_only"] > 0
    # a warm tile, the timed tiles, one tile and three
    chunks = -(-w.n_cand // w.tile)
    assert head["tiles_run"] == 1 + chunks + 1 + 3
    assert len(head["scores"]) == chunks
    for s in head["scores"]:
        assert bool(torch.isfinite(s).all()) and bool((s > 0).all())
    pool = rows["pool"]
    assert pool["rate"] > 0 and pool["procs"] == POOL_PROCS
    assert pool["lanes"] == min(POOL_PROCS, w.n_cand)
    assert np.isfinite(pool["var"]).all()
    for cov_param in ("psd-project", "chol"):
        row = rows[cov_param]
        assert row["rate"] > 0
        assert row["candidates"] == len(row["scores"]) > w.vn_tile
        assert row["tiles"] == -(-row["candidates"] // w.vn_tile)
        assert bool(torch.isfinite(row["scores"]).all())
    assert "refit" not in rows


def test_refit_row_on_the_cpu():
    """The refit row's own function runs on the CPU (through the kernel's
    plain version); only the line leaves it out there."""
    _, _, prob = bench.make_problem(TINY, CPU)
    row = bench.refit_row(prob, TINY, CPU)
    assert row["rate"] > 0 and row["tiles"] == 2
    assert row["neg_ll"].shape == (TINY.pk_n_cand,)
    assert bool(torch.isfinite(row["neg_ll"]).all())


def test_psd_cap_cuts_the_row_to_one_tile():
    row = bench.vn_row(TINY, CPU, "psd-project", cap=3)
    assert row["candidates"] == 3 and row["tiles"] == 1 and row["tile"] == 3


def test_line_has_bench_py_keys_plus_device(cpu_run):
    printed, line, _, w = cpu_run
    assert printed == line
    always, faults = _bench_py_keys()
    assert faults == {"secondary_bench_faults"}
    assert set(printed) == always | {"device"}
    assert printed["platform"] == "cpu" and printed["device"] == "cpu"
    assert printed["pmf_refit_kernel_scores_per_sec"] is None
    assert printed["workload"] == w.describe() == (
        "20x30 d=3 5-value lookahead, 3-sample chains")
    for key in ("value", "pool_scores_per_sec", "device_only_scores_per_sec",
                "vn_total_variance_scores_per_sec",
                "vn_total_variance_chol_scores_per_sec", "vs_baseline"):
        assert printed[key] > 0, key
    assert printed["pool_procs"] == POOL_PROCS


def test_vs_baseline_is_value_over_the_pool(cpu_run):
    printed, _, rows, _ = cpu_run
    value, pool = printed["value"], printed["pool_scores_per_sec"]
    exact = rows["gibbs"]["value"] / rows["pool"]["rate"]
    assert printed["vs_baseline"] == round(exact, 1)
    # from the printed numbers, to their rounding
    slack = 0.05 + value / pool * (0.005 / value + 0.00005 / pool) + 1e-9
    assert abs(printed["vs_baseline"] - value / pool) <= slack


def test_host_workload_is_bench_py_host_constants():
    """bench.py:334-338 shrinks to these on the host, and the port runs
    them only when the CPU is named."""
    jb = _jax_bench()
    assert (bench.CARD.n, bench.CARD.m, bench.CARD.d) == (jb.N, jb.M, jb.D)
    assert (bench.CARD.n_cand, bench.CARD.tile, bench.CARD.base_samps,
            bench.CARD.la_samps) == (jb.N_CAND, jb.TILE, jb.BASE_SAMPS,
                                     jb.LA_SAMPS)
    assert (bench.CARD.pk_n_cand, bench.CARD.pk_tile, bench.CARD.pk_steps,
            bench.CARD.pk_lane_block, bench.CARD.pk_block_rows) == (
        jb.PK_N_CAND, jb.PK_TILE, jb.PK_REFIT_STEPS, jb.PK_LANE_BLOCK,
        jb.PK_BLOCK_ROWS)
    assert bench.CARD.known == 0.05 * 100000
    assert (bench.HOST.n, bench.HOST.m, bench.HOST.n_cand, bench.HOST.tile,
            bench.HOST.base_samps, bench.HOST.pk_n_cand) == (
        189, 336, 8, 8, 64, 128)
    assert bench_pool.LA_SAMPS == jb.LA_SAMPS


# ---------------------------------------------------------------------------
# (e) a non-finite score refuses its row


def test_non_finite_headline_raises(monkeypatch):
    from amf_tpu_torch.models import bpmf_gibbs

    def nan_scores(*a, cand, **kw):
        return torch.full((len(cand),), float("nan"))

    monkeypatch.setattr(bpmf_gibbs, "exp_variance_scores", nan_scores)
    _, _, prob = bench.make_problem(TINY, CPU)
    with pytest.raises(RuntimeError, match="non-finite"):
        bench.gibbs_row(prob, TINY, CPU)


def test_non_finite_vn_row_is_a_secondary_fault(monkeypatch):
    from amf_tpu_torch.active import lookahead

    inner = lookahead.lookahead_scores

    def one_nan(*a, **kw):
        s = inner(*a, **kw).clone()
        s[0] = float("nan")
        return s

    monkeypatch.setattr(lookahead, "lookahead_scores", one_nan)
    line, rows = bench.run(TINY, CPU, procs=POOL_PROCS)
    faults = line["secondary_bench_faults"]
    assert set(faults) == {"vn_total_variance", "vn_total_variance_chol"}
    assert all("non-finite" in v for v in faults.values())
    assert line["vn_total_variance_scores_per_sec"] is None
    assert line["vn_total_variance_chol_scores_per_sec"] is None
    assert line["value"] > 0 and "psd-project" not in rows


# ---------------------------------------------------------------------------
# (f) no card, no silent fallback; (g) the pool's module stays light


def _python(*args, timeout=120):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_no_card_exits_non_zero_and_prints_no_line():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the bench would run for real")
    proc = _python("-m", "amf_tpu_torch.bench")
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert not [ln for ln in proc.stdout.splitlines()
                if ln.lstrip().startswith("{")]


def test_pool_module_and_bench_import_no_torch():
    """A pool worker imports the lane's module and the main module (the
    bench, under ``python -m``): neither may pull in torch or JAX."""
    proc = _python("-c", (
        "import sys, amf_tpu_torch.bench_pool\n"
        "assert not {'torch', 'jax'} & set(sys.modules), 'pool'\n"
        "import amf_tpu_torch.bench\n"
        "assert not {'torch', 'jax'} & set(sys.modules), 'bench'\n"))
    assert proc.returncode == 0, proc.stderr
