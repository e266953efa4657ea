"""The port's candidate and chain sharding (amf_tpu_torch/parallel/)
against the JAX package's helpers and against its own unsharded paths, in
float64 on the CPU over gloo processes.

- ``pad_to_multiple`` and ``best_candidate`` equal the JAX package's on the
  same numpy inputs (maximize and minimize; finite, NaN, inf and no finite
  score); the shard split covers every cell once.
- One launch of the dry run on two ranks (``run_dryrun(2, "cpu")``) gives
  what ``dryrun_step`` gives in this process without a mesh, to 1e-10 with
  the same pick: the vn, Gibbs, NUTS, cold-start and RC lookahead scores,
  the NUTS chains split over the ranks (draws, mode, adaptation) and two
  steps of ``run_active_pmf(mesh=...)``; the sharded Gibbs tile that the
  card's smoke times rank by rank equals the unsharded tile.
- Each of the five command lines with ``--shard-candidates 2 --device
  cpu`` records what its unsharded run records; ``--scan`` runs unsharded.
- The refusals: a mesh of size 0, more ranks than cards, nccl on the CPU,
  a world of several ranks without a launcher, and a rank's exception.

Every rank is a process started by the port's own entry points, so no
child imports this module (or JAX).
"""

import pickle

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a worker)
from amf_tpu.parallel import mesh as jmesh
from amf_tpu.parallel import sharding as jsharding
from amf_tpu_torch.data.loaders import save_npz_schema
from amf_tpu_torch.parallel import dryrun, mesh, sharding
from amf_tpu_torch.utils import profiling

TOL = 1e-10


# ---------------------------------------------------------------------------
# helpers against the JAX package's


@pytest.mark.parametrize("shape,multiple,axis,fill", [
    ((5,), 2, 0, 0), ((6,), 3, 0, 0), ((5, 3), 4, 0, -1), ((2, 5), 3, 1, 7),
    ((1,), 4, 0, 0)])
def test_pad_to_multiple_matches_jax(shape, multiple, axis, fill):
    x = np.arange(int(np.prod(shape)), dtype=np.float64).reshape(shape)
    want, wsize = jmesh.pad_to_multiple(x, multiple, axis=axis, fill=fill)
    got, size = mesh.pad_to_multiple(torch.as_tensor(x), multiple, dim=axis,
                                     fill=fill)
    assert size == wsize
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _scores(kind, rng):
    s = rng.normal(size=12)
    if kind == "nan":
        s[[2, 7]] = np.nan
    elif kind == "inf":
        s[4], s[9] = np.inf, -np.inf
    elif kind == "none-finite":
        s[:] = np.nan
    return s


@pytest.mark.parametrize("maximize", [True, False])
@pytest.mark.parametrize("kind", ["finite", "nan", "inf", "none-finite"])
def test_best_candidate_matches_jax(kind, maximize, rng):
    scores = _scores(kind, rng)
    queryable = rng.random(12) < 0.6
    queryable[[3, 7, 9]] = True
    want = int(jsharding.best_candidate(scores, queryable, maximize))
    got = sharding.best_candidate(torch.as_tensor(scores),
                                  torch.as_tensor(queryable), maximize)
    assert int(got) == want and queryable[want]


@pytest.mark.parametrize("size", [1, 2, 3, 4])
def test_shards_cover_every_cell_once(size):
    for n_cells in (1, 2, 3, 5, 8, 13):
        seen = []
        for rank in range(size):
            start, stop = sharding.shard_range(n_cells, size, rank)
            assert stop - start == -(-n_cells // size)  # equal shards
            seen += [min(i, n_cells - 1) for i in range(start, stop)]
        real = [i for i in seen[:n_cells]]
        assert real == list(range(n_cells))  # the gather keeps these
        assert set(seen) == set(range(n_cells))  # padding repeats a cell


def test_world_of_one_scores_as_unsharded():
    m1 = mesh.make_mesh(1, device="cpu")
    try:
        assert (m1.size, m1.rank, m1.backend) == (1, 0, "gloo")
        cand = torch.tensor([1, 4, 6])

        def score(c, seed):
            return c.double() * 0.5 + seed

        profiling.spans(reset=True)
        with profiling.tracing():
            got = sharding.sharded_candidate_scores(score, 8, m1, cand)(3)
        want = sharding.sharded_candidate_scores(score, 8, None, cand)(3)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        assert np.isnan(got.numpy()[[0, 2, 3, 5, 7]]).all()
        # the mesh's scoring and gather are spans, recorded while tracing
        assert [s.name for s in profiling.spans(reset=True)] == [
            "parallel.score", "parallel.gather"]
    finally:
        m1.close()
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# the dry run: two gloo ranks against this process


@pytest.fixture(scope="module")
def dry():
    sharded = dryrun.run_dryrun(2, device="cpu")
    plain = dryrun.dryrun_step(None, chains=4, device="cpu")
    return sharded, plain


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("family,maximize", [
    ("vn", True), ("gibbs", False), ("nuts", False), ("newitems", False),
    ("rc", False)])
def test_sharded_scores_equal_unsharded(dry, family, maximize):
    sharded, plain = dry
    got, want = sharded[family]["scores"], plain[family]["scores"]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isfinite(want).sum() >= 2
    _close(got, want)
    pick = np.nanargmax if maximize else np.nanargmin
    assert pick(got) == pick(want)


def test_sharded_vn_step_equals_unsharded(dry):
    sharded, plain = dry
    assert sharded["vn"]["pick"] == plain["vn"]["pick"]
    for key in ("pred", "approx_mean"):
        _close(sharded["vn"][key], plain["vn"][key])


@pytest.mark.parametrize("key", ["U", "lp__", "mode_q", "mode_lp",
                                 "adapt_eps", "adapt_inv_mass"])
def test_sharded_chains_equal_chains_as_lanes(dry, key):
    sharded, plain = dry
    assert sharded["chains"][key].shape == plain["chains"][key].shape
    _close(sharded["chains"][key], plain["chains"][key])


def test_run_active_pmf_with_a_mesh_records_as_without(dry):
    sharded, plain = dry
    assert len(plain["loop"]) == 3
    assert [r[2] for r in sharded["loop"]] == [r[2] for r in plain["loop"]]
    _close([r[1] for r in sharded["loop"]], [r[1] for r in plain["loop"]])


def test_run_dryrun_checks_and_reports(dry):
    sharded, _ = dry
    dryrun.check_dryrun(sharded)
    assert sharded["setup_s"] > 0


def test_gibbs_tile_on_ranks_equals_the_unsharded_tile():
    """The sharded Gibbs tile that the card's smoke times rank by rank: two
    ranks, each one of the unsharded run's tiles of 3 candidates."""
    from amf_tpu_torch import types
    from amf_tpu_torch.models import bpmf_gibbs, pmf
    from amf_tpu_torch.utils.rng import generator

    rng = np.random.default_rng(6)
    real = rng.integers(1, 6, size=(7, 6)).astype(float)
    known = rng.random((7, 6)) < 0.4
    known[0], known[:, 0] = True, True
    prob = types.problem_from_dense(real, known, dtype=torch.float64,
                                    device="cpu")
    pcfg = pmf.PMFConfig(latent_d=2)
    gcfg = bpmf_gibbs.GibbsConfig(latent_d=2)
    vals = (1.0, 2.0, 3.0, 4.0, 5.0)
    pst = pmf.init_state(generator(1, "cpu"), 7, 6, pcfg, prob,
                         dtype=torch.float64, device="cpu")
    pst, _ = pmf.fit(pst, prob, pcfg)
    _, stats, _ = bpmf_gibbs.run_chain(
        bpmf_gibbs.init_chain(pst), prob, gcfg, 8,
        generator=generator(2, "cpu"), value_bounds=(0.5, 1.5, 2.5, 3.5,
                                                     4.5, 5.5))
    cand = torch.nonzero(prob.queryable.flatten())[:6, 0]
    kw = dict(num_samps=3, fit_budget=10, n_base_samples=8,
              candidate_tile=3)
    want = bpmf_gibbs.exp_variance_scores(4, pst, prob, pcfg, gcfg, stats,
                                          vals, cand=cand, **kw)
    got = mesh.launch(dryrun.gibbs_tile_on_ranks, 2, "cpu", None, 4, pst,
                      prob, pcfg, gcfg, stats, vals, cand, kw)
    np.testing.assert_array_equal(got["scores"], want.numpy())
    assert len(got["ranks"]) == 2
    for r in got["ranks"]:
        # the CPU takes the plain version: 3 candidates x 5 values a rank
        assert r["plain"] > 0 and r["gram_fed"] == r["s_given"] == 0
        assert r["shard_s"] > 0 and r["gather_ms"] >= 0 and r["setup_s"] > 0


# ---------------------------------------------------------------------------
# the command lines


@pytest.fixture(scope="module")
def data_files(tmp_path_factory):
    rng = np.random.default_rng(4)
    vals = np.arange(1.0, 6.0)
    real = rng.integers(1, 6, size=(5, 5)).astype(float)
    known = rng.random((5, 5)) < 0.45
    known[0], known[:, 0] = True, True
    is_new = np.zeros(5, bool)
    is_new[-2:] = True
    known[:, is_new] = False
    known[0, is_new] = True
    root = tmp_path_factory.mktemp("torch_parallel_cli")
    plain, newitems = str(root / "data.npz"), str(root / "new.npz")
    save_npz_schema(plain, {"_real": real, "_known": known,
                            "_rating_vals": vals})
    save_npz_schema(newitems, {"_real": real, "_known": known,
                               "_rating_vals": vals, "_is_new_item": is_new})
    return {"plain": plain, "newitems": newitems}


CLI_CASES = {
    "bayes_pmf": ("plain", ["-D", "2", "-S", "8", "--lookahead-samps", "4",
                            "exp-variance"]),
    "active_pmf": ("plain", ["-D", "2", "--discrete-integration",
                             "--lookahead-budget", "15", "total-variance"]),
    "bpmf": ("plain", ["-D", "2", "-S", "4", "-W", "4", "--chains", "2",
                       "--lookahead-samps", "2", "--lookahead-warmup", "1",
                       "exp-variance"]),
    "bpmf_newitems": ("newitems", ["-D", "2", "-S", "6", "-W", "6",
                                   "--initial-fit-samps", "8",
                                   "--lookahead-samps", "2",
                                   "--lookahead-warmup", "1",
                                   "exp-variance"]),
    "active_rc": ("plain", ["--max-iters", "60", "--lookahead-iters", "5",
                            "entropy"]),
}


def _records(path):
    with open(path, "rb") as f:
        res = pickle.load(f)
    return {k: [r[:2] + (tuple(r[2]) if r[2] else None,) for r in v]
            for k, v in res.items() if not k.startswith("_")
            and isinstance(v, list)}


@pytest.mark.parametrize("cli", sorted(CLI_CASES))
def test_cli_sharded_runs_record_the_unsharded_picks(cli, data_files,
                                                     tmp_path):
    import importlib

    main = importlib.import_module(f"amf_tpu_torch.run.{cli}").main
    which, extra = CLI_CASES[cli]
    argv = ["--load-data", data_files[which], "-s", "3", "--device", "cpu",
            "--no-verbose"] + extra
    one, two = str(tmp_path / "one.pkl"), str(tmp_path / "two.pkl")
    main(argv[:-1] + ["--save-results", one, argv[-1]])
    main(argv[:-1] + ["--save-results", two, "--shard-candidates", "2",
                      argv[-1]])
    want, got = _records(one), _records(two)
    assert got.keys() == want.keys() and len(want) == 1
    for k in want:
        assert len(want[k]) == 3
        assert [r[2] for r in got[k]] == [r[2] for r in want[k]], k
        _close([r[1] for r in got[k]], [r[1] for r in want[k]])


def test_cli_scan_runs_unsharded(data_files, tmp_path, capsys):
    from amf_tpu_torch.run import bayes_pmf

    argv = ["--load-data", data_files["plain"], "-D", "2", "-s", "3", "-S",
            "8", "--device", "cpu", "--no-verbose", "--scan"]
    one, two = str(tmp_path / "one.pkl"), str(tmp_path / "two.pkl")
    bayes_pmf.main(argv + ["--save-results", one, "pred-variance"])
    capsys.readouterr()
    bayes_pmf.main(argv + ["--save-results", two, "--shard-candidates", "2",
                           "pred-variance"])
    assert "runs the sweep unsharded" in capsys.readouterr().err
    assert _records(two) == _records(one)


# ---------------------------------------------------------------------------
# refusals


def test_a_mesh_of_no_ranks_is_refused():
    with pytest.raises(ValueError, match="at least one rank"):
        mesh.launch(mesh.is_lead, 0, "cpu")


def test_more_ranks_than_cards_needs_gloo(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cuda = torch.device("cuda")
    with pytest.raises(ValueError, match="name backend='gloo'"):
        mesh._check_world(2, cuda, mesh._backend_for(cuda, None))
    mesh._check_world(2, cuda, "gloo")  # ranks share the card, explicitly
    mesh._check_world(1, cuda, "nccl")


def test_nccl_on_the_cpu_and_unknown_backends_are_refused():
    with pytest.raises(ValueError, match="nccl backend needs"):
        mesh.launch(mesh.is_lead, 2, "cpu", "nccl")
    with pytest.raises(ValueError, match="backend must be"):
        mesh.launch(mesh.is_lead, 2, "cpu", "mpi")


def test_several_ranks_need_a_launcher():
    with pytest.raises(RuntimeError, match="launch or torchrun"):
        mesh.make_mesh(2, device="cpu")
    assert not torch.distributed.is_initialized()


def test_torchrun_environment_is_honoured(monkeypatch):
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(k, v)
    # this process is rank 0 of a world of one: no child is started
    assert mesh.launch(mesh.is_lead, 1, "cpu") is True
    assert not torch.distributed.is_initialized()


def test_a_rank_exception_fails_the_launch():
    # check_dryrun indexes its argument, and a mesh is no dict
    with pytest.raises(Exception, match="not subscriptable"):
        mesh.launch(dryrun.check_dryrun, 2, "cpu")
