"""The benchmark's ``pmf_refit`` family (``portbench/models/pmf_refit/``) on
the CPU: a cut-down ``ml100k-pmf-d20.boost-tiles`` cell through
``portbench.run``, correct, and failed by each planted fault; its readers;
its sample; its counts; and what its reference imports.

The cell runs in a process of its own: the harness refuses to run where
the JAX package is loaded, and the tier-1 workers load it."""

import ast
import copy
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_threads  # noqa: F401  (one torch thread a worker)
from portbench import run
from portbench.models.pmf_refit import check, counts

ROOT = Path(__file__).resolve().parents[1]
CELL = "ml100k-pmf-d20.boost-tiles"
SEED = 2 ** 31 + 977
SIDES = ("port", "refit_skipped", "refit_cut", "cell_dropped",
         "grad_cell_dropped", "bf16_carry")


def tiny_cell() -> run.Cell:
    """The cell at a size for the CPU: the shapes, counts and tile cut,
    its rule, budget and limits as the files have them."""
    cell = run.load_cell(CELL, ROOT)
    c = copy.deepcopy(cell.config)
    c.update(rows=30, cols=40, latent_d=3)
    c["data"].update(rated_cells=600, min_per_row=5)
    c["split"].update(known=200, test=100)
    t = copy.deepcopy(cell.traffic)
    t["tile_candidates"] = 8
    return dataclasses.replace(cell, config=c, traffic=t)


PROBE = """
import json, sys
sys.path.insert(0, sys.argv[1])
from tests.test_portbench_pmf_refit import SEED, tiny_cell
from portbench import run
from portbench.models import pmf_refit
from amf_tpu_torch.utils.platform import resolve_device

cpu = resolve_device("cpu")
out = {}
for side in sys.argv[2:]:
    trace = side == "traced"
    if side in ("port", "traced"):
        line = run.run_cell(tiny_cell(), SEED, 0.3, trace, cpu)
    else:
        with pmf_refit.FAULTS[side]():
            line = run.run_cell(tiny_cell(), SEED, 0.3, False, cpu)
    out[side] = line
out["modules"] = sorted({m.split(".")[0] for m in sys.modules})
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def lines():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(ROOT / "tests")]), OMP_NUM_THREADS="1")
    got = subprocess.run(
        [sys.executable, "-c", PROBE, str(ROOT), *SIDES, "traced"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr[-4000:]
    return json.loads(got.stdout.strip().splitlines()[-1])


def test_the_run_loads_no_jax(lines):
    tops = set(lines["modules"])
    assert "amf_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "amf_tpu"}


@pytest.mark.parametrize("side", SIDES)
def test_the_port_passes_and_each_fault_fails(side, lines):
    line = lines[side]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert line["attempted"] % 8 == 0
    checks = line["checks"]
    assert set(checks) == {"rmse_gap", "value_gap", "refit_gap",
                           "cell_fit_gap"}
    over = [k for k, c in checks.items() if c["value"] > c["limit"]]
    if side == "port":
        assert line["correct"] is True and not over, checks
        assert set(line["metrics"]) == {"setup_s",
                                        "lookahead_cand_per_s.host"}
    else:
        assert line["correct"] is False and over, checks


READERS = {  # metric: reads a number on the CPU
    "boost_refit_pct": False,  # stream events need the card
    "boost_refit_passes": True,
    "boost_refit_idle_pct": False,  # the device trace needs the card
    "b4_roofline_pct.boost": False,
    "device_idle_pct.boost": False,
    "boost_mfu": False,  # the card's peak
}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_a_reader_on_the_traced_cell(metric, lines):
    line = lines["traced"]
    assert line["correct"] is True
    assert metric in {m["name"] for m in tiny_cell().per_layer}
    got = line["metrics"].get(metric)
    if READERS[metric]:
        assert got is not None and got["value"] > 0
        assert np.isfinite(got["value"])
    else:
        assert got is None


@pytest.mark.parametrize("width", [8, 128])
def test_the_sample_keeps_as_many_from_each_quarter(width):
    for seed in range(20):
        s = check.Sample(seed, 8)
        for t in range(50):
            p = s.position(t, width)
            assert check.quarter(p, width) == t % 4
            s.offer(t, (t, p))
        got = s.lanes()
        assert len(got) == 8 and len(set(got)) == 8
        assert sorted(t % 4 for t, _ in got) == [0, 0, 1, 1, 2, 2, 3, 3]


def test_b4_counts_by_hand():
    # L = 2 lanes, n = 3, m = 4, d = 2, nnz = 5: a lane's 6 cells cost
    # 6 d + 5 = 17 each (u.v 4, e 1, e^2 2, e/s 1, Gu 4; e/s 1, Gv 4), its
    # 7 rows a prior term 2 d = 4 each
    assert counts.b4_flops(2, 3, 4, 2, 5) == 2 * (6 * 17 + 7 * 4)
    # a lane: factors in and gradients out 2 x 7 x 2 values of 4 B, its
    # squared error 4 B, its cell 8 + 8 + 4 B; the index (3 + 1 + 4 + 1)
    # pointers of 4 B and 16 B a cell; three sigmas
    assert counts.b4_bytes(2, 3, 4, 2, 5) == 2 * (112 + 24) + 36 + 80 + 12
    # a tile of 5 passes: 6 evaluations, and 2 n m d a lane's prediction
    assert counts.tile_flops(2, 3, 4, 2, 5, 6) == \
        6 * counts.b4_flops(2, 3, 4, 2, 5) + 2 * 2 * 3 * 4 * 2


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_port_and_keeps_tf32_off():
    import torch

    from portbench.models.pmf_refit import reference as ref

    path = ROOT / "portbench" / "models" / "pmf_refit" / "reference.py"
    tops = {m.split(".")[0] for m in _imports(path)}
    assert tops <= {"__future__", "contextlib", "dataclasses", "typing",
                    "numpy", "torch"}, tops
    seen = []
    real = ref.matmul_precision

    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        data = ref.Data.build(np.full((3, 4), 2.0), np.eye(3, 4, dtype=bool),
                              np.eye(3, 4, k=1, dtype=bool), torch.float64,
                              "cpu")
        U, V = torch.ones(1, 3, 2, dtype=torch.float64), torch.ones(
            1, 4, 2, dtype=torch.float64)

        def spy(tf32):
            seen.append(tf32)
            return real(tf32)

        ref.matmul_precision = spy
        ref.neg_log_post(data, U, V)
        ref.heldout_rmse(data, U, V)
        assert seen == [False, False]
        with real(False):
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
    finally:
        ref.matmul_precision = real
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was
