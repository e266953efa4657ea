"""The port stands alone: importing it never imports JAX, and the chip
smoke refuses to run without a CUDA card."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE = [
    "amf_tpu_torch", "amf_tpu_torch.convert", "amf_tpu_torch.types",
    "amf_tpu_torch.utils.platform", "amf_tpu_torch.utils.rng",
    "amf_tpu_torch.data.synthetic", "amf_tpu_torch.data.loaders",
    "amf_tpu_torch.analysis.metrics", "amf_tpu_torch.ops.linesearch",
    "amf_tpu_torch.ops.chol_kernel", "amf_tpu_torch.ops.cuda_build",
    "amf_tpu_torch.ops.quadrature", "amf_tpu_torch.models.pmf",
    "amf_tpu_torch.models.bpmf_gibbs", "amf_tpu_torch.active.driver",
    "amf_tpu_torch.active.gibbs_loop", "amf_tpu_torch.run.bayes_pmf",
    "amf_tpu_torch.ops.pmf_kernels", "amf_tpu_torch.run.add_rmse_boosts",
    "amf_tpu_torch.ops.probe_kernels",
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


def test_lane_seeds_are_stable_and_tile_invariant():
    from amf_tpu_torch.utils.rng import fold_in_name, lane_seeds

    assert fold_in_name(0, "exp-variance") == fold_in_name(0, "exp-variance")
    assert fold_in_name(0, "a") != fold_in_name(0, "b")
    whole = lane_seeds(7, [3, 9, 14], 5)
    assert whole == lane_seeds(7, [3], 5) + lane_seeds(7, [9, 14], 5)
    assert len(set(whole)) == 15 and all(0 <= s < 2**63 for s in whole)
