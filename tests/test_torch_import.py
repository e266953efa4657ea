"""The port stands alone: importing it never imports JAX, and the chip
smoke refuses to run without a CUDA card."""

import os
import subprocess
import sys

import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a worker)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE = [
    "amf_tpu_torch", "amf_tpu_torch.convert", "amf_tpu_torch.types",
    "amf_tpu_torch.utils.platform", "amf_tpu_torch.utils.rng",
    "amf_tpu_torch.data.synthetic", "amf_tpu_torch.data.loaders",
    "amf_tpu_torch.analysis.metrics", "amf_tpu_torch.ops.linesearch",
    "amf_tpu_torch.ops.chol_kernel", "amf_tpu_torch.ops.cuda_build",
    "amf_tpu_torch.ops.gram_kernel", "amf_tpu_torch.ops.lane_noise",
    "amf_tpu_torch.ops.quadrature", "amf_tpu_torch.models.pmf",
    "amf_tpu_torch.models.bpmf_gibbs", "amf_tpu_torch.active.driver",
    "amf_tpu_torch.active.gibbs_loop", "amf_tpu_torch.run.bayes_pmf",
    "amf_tpu_torch.ops.pmf_kernels", "amf_tpu_torch.run.add_rmse_boosts",
    "amf_tpu_torch.ops.probe_kernels", "amf_tpu_torch.ops.moments",
    "amf_tpu_torch.ops.psd", "amf_tpu_torch.utils.linalg",
    "amf_tpu_torch.models.vnormal", "amf_tpu_torch.models.mnormal",
    "amf_tpu_torch.active.criteria", "amf_tpu_torch.active.lookahead",
    "amf_tpu_torch.active.loop", "amf_tpu_torch.run.active_pmf",
    "amf_tpu_torch.entry", "amf_tpu_torch.utils.checkpoint",
    "amf_tpu_torch.mcmc", "amf_tpu_torch.mcmc.nuts",
    "amf_tpu_torch.models.bpmf_hmc", "amf_tpu_torch.models.sample_stats",
    "amf_tpu_torch.active.stan_loop", "amf_tpu_torch.run.bpmf",
    "amf_tpu_torch.data.splits", "amf_tpu_torch.data.extractors",
    "amf_tpu_torch.ops.lbfgsb", "amf_tpu_torch.models.ratingconc",
    "amf_tpu_torch.active.rc_loop", "amf_tpu_torch.run.active_rc",
    "amf_tpu_torch.models.newitems", "amf_tpu_torch.run.bpmf_newitems",
    "amf_tpu_torch.models.mmmf", "amf_tpu_torch.models.sdpa_io",
    "amf_tpu_torch.active.mmmf_loop", "amf_tpu_torch.run.active_mmmf",
    "amf_tpu_torch.active.scan_loop", "amf_tpu_torch.utils.profiling",
    "amf_tpu_torch.analysis.results", "amf_tpu_torch.analysis.parity",
    "amf_tpu_torch.run.plot_results", "amf_tpu_torch.run.plot_aucs",
    "amf_tpu_torch.run.compare_firsts", "amf_tpu_torch.run.generate",
    "amf_tpu_torch.run.choose_training", "amf_tpu_torch.run.get_samples",
    "amf_tpu_torch.run.get_criteria", "amf_tpu_torch.run.experiment",
    "amf_tpu_torch.parallel.mesh", "amf_tpu_torch.parallel.sharding",
    "amf_tpu_torch.parallel.dryrun", "amf_tpu_torch._native",
    "amf_tpu_torch.bench", "amf_tpu_torch.bench_pool",
]


def _run(args, timeout=120):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_imports_no_jax():
    code = ("import importlib, sys\n"
            f"for name in {SLICE!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'amf_tpu.')) or m == 'amf_tpu')\n"
            "assert not bad, bad\n")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr


def test_slice_lists_every_port_module():
    """SLICE (imported above without JAX) holds every module of the port
    (the subpackages come with their modules)."""
    import pkgutil

    import amf_tpu_torch

    found = {m.name for m in pkgutil.walk_packages(amf_tpu_torch.__path__,
                                                   "amf_tpu_torch.")
             if not m.ispkg}
    assert found <= set(SLICE), sorted(found - set(SLICE))


def test_chip_smoke_imports_no_jax():
    import ast

    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    bad = sorted(n for n in names if n.split(".")[0] in ("jax", "amf_tpu"))
    assert not bad, bad


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the smoke would run for real")
    proc = _run([os.path.join(ROOT, "chip_smoke.py")])
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_platform_policy_turns_tf32_off():
    from amf_tpu_torch.utils.platform import resolve_device, setup

    torch.backends.cuda.matmul.allow_tf32 = True
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert setup(True, "cpu") == (torch.device("cpu"), torch.float64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device("cuda")


def test_default_device_is_cuda_with_no_cpu_fallback():
    """Entry points run on the card unless the CPU is named."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default would run on it")
    from amf_tpu_torch.active.gibbs_loop import run_active_gibbs
    from amf_tpu_torch.run import add_rmse_boosts, bayes_pmf
    from amf_tpu_torch.utils.platform import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_active_gibbs(None, None, ["random"])
    for cli in (add_rmse_boosts, bayes_pmf):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--load-data", "never-read.npz"])
    from amf_tpu_torch.active.loop import run_active_pmf
    from amf_tpu_torch.entry import entry
    from amf_tpu_torch.run import active_pmf

    with pytest.raises(RuntimeError, match="CUDA"):
        run_active_pmf(None, None, ["pred"])
    with pytest.raises(RuntimeError, match="CUDA"):
        active_pmf.main(["pred"])
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
    from amf_tpu_torch.active.stan_loop import run_active_stan
    from amf_tpu_torch.run import bpmf

    with pytest.raises(RuntimeError, match="CUDA"):
        run_active_stan(None, None, ["random"])
    with pytest.raises(RuntimeError, match="CUDA"):
        bpmf.main(["--load-data", "never-read.npz"])
    from amf_tpu_torch.active.rc_loop import run_active_rc
    from amf_tpu_torch.run import active_rc, bpmf_newitems

    with pytest.raises(RuntimeError, match="CUDA"):
        run_active_rc(None, None, ["random"])
    for cli in (active_rc, bpmf_newitems):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--load-data", "never-read.npz"])


def test_mmmf_and_scan_entry_points_default_to_the_card():
    """The MMMF solver state, loop and CLI and the scan sweeps run on the
    card unless the CPU is named."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default would run on it")
    import numpy as np

    from amf_tpu_torch import convert
    from amf_tpu_torch.active import scan_loop
    from amf_tpu_torch.active.mmmf_loop import run_active_mmmf
    from amf_tpu_torch.models import mmmf
    from amf_tpu_torch.run import active_mmmf

    with pytest.raises(RuntimeError, match="CUDA"):
        mmmf.init_state(2, 3)
    assert mmmf.init_state(2, 3, device="cpu").X.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.mmmf_state(dict(X=np.zeros((2, 3)), Z=np.zeros((2, 3)),
                                W=np.zeros((2, 3))))
    with pytest.raises(RuntimeError, match="CUDA"):
        run_active_mmmf(None, None, ["random"])
    with pytest.raises(RuntimeError, match="CUDA"):
        active_mmmf.main(["--load-data", "never-read.npz"])
    for sweep in (scan_loop.run_gibbs_scan, scan_loop.run_stan_scan):
        with pytest.raises(RuntimeError, match="CUDA"):
            sweep(None, None, "random", 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        scan_loop.run_active_scan(None, None, "random", 1)


def test_result_tool_entry_points_default_to_the_card(tmp_path):
    """The new CLIs that take --device run on the card unless the CPU is
    named; the text CLIs read pickles on the host and take no device."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default would run on it")
    from amf_tpu_torch.run import (choose_training, experiment, generate,
                                   get_criteria, get_samples)

    for cli, argv in (
            (get_samples, ["--load-data", "never-read.npz"]),
            (get_criteria, ["--outdir", str(tmp_path / "crit")]),
            (generate, ["-m", "2", "-n", "2", "-r", "1", "-k", "0", "-K",
                        "0", str(tmp_path / "never.pkl")]),
            (choose_training, ["never-read.npy", str(tmp_path / "n.npz")]),
            (experiment, ["10x10_discrete2_d2", "--outdir",
                          str(tmp_path / "exp")])):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)
    assert not list(tmp_path.iterdir())


def test_constructors_default_to_the_card():
    """A bare call builds on the card: without one it raises, and the CPU
    is named to be used."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default would run on it")
    import numpy as np

    from amf_tpu_torch import convert, types
    from amf_tpu_torch.models import pmf

    real = np.arange(1.0, 7.0).reshape(2, 3)
    known = real > 3
    with pytest.raises(RuntimeError, match="CUDA"):
        types.problem_from_dense(real, known)
    with pytest.raises(RuntimeError, match="CUDA"):
        types.problem_from_ratings(np.asarray([[0, 1, 2.0]]), shape=(2, 3))
    prob = types.problem_from_dense(real, known, device="cpu")
    cfg = pmf.PMFConfig(latent_d=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        pmf.init_state(torch.Generator(), 2, 3, cfg, prob)
    st = pmf.init_state(torch.Generator(), 2, 3, cfg, prob, device="cpu")
    fields = convert.to_numpy(st)
    for build, src in ((convert.pmf_state, fields),
                       (convert.problem, convert.to_numpy(prob))):
        with pytest.raises(RuntimeError, match="CUDA"):
            build(src)
        assert build(src, device="cpu") is not None


def test_lane_seeds_are_stable_and_tile_invariant():
    from amf_tpu_torch.utils.rng import fold_in_name, lane_seeds

    assert fold_in_name(0, "exp-variance") == fold_in_name(0, "exp-variance")
    assert fold_in_name(0, "a") != fold_in_name(0, "b")
    whole = lane_seeds(7, [3, 9, 14], 5)
    assert whole == lane_seeds(7, [3], 5) + lane_seeds(7, [9, 14], 5)
    assert len(set(whole)) == 15 and all(0 <= s < 2**63 for s in whole)
