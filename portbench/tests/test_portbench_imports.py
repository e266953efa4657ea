"""What a run loads, and what the reference imports."""

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "portbench"

PROBE = """
import json, sys
from portbench import run
from portbench.tests.conftest import SEED, tiny_cell
from amf_tpu_torch.utils.platform import resolve_device
out = run.run_cell(tiny_cell(sys.argv[1]), SEED, 0.2, False,
                   resolve_device("cpu"))
print(json.dumps({"correct": out["correct"],
                  "mods": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_a_run_loads_no_jax_nor_the_jax_package():
    got = subprocess.run(
        [sys.executable, "-c", PROBE, "ml100k-bpmf-d20.expvar-tiles"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    line = json.loads(got.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    tops = set(line["mods"])
    assert "amf_tpu_torch" in tops  # the port ran
    assert not tops & {"jax", "jaxlib", "flax", "amf_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_port():
    for name in ("models/bpmf_gibbs/reference.py", "seeds.py", "counts.py"):
        tops = {m.split(".")[0] for m in _imports(PKG / name)}
        assert tops <= {"__future__", "contextlib", "dataclasses", "typing",
                        "numpy", "torch", "zlib", "portbench"}, (name, tops)
        assert {m for m in _imports(PKG / name)
                if m.startswith("portbench")} <= {"portbench.seeds"}


def test_nothing_in_the_benchmark_imports_jax():
    for path in PKG.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "amf_tpu"}, path


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "amf_tpu_torch_probe", object())
    assert "amf_tpu_torch_probe" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "amf_tpu.probe", object())
    assert run.forbidden_modules() == ["amf_tpu.probe"]
