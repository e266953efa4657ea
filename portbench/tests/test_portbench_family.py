"""A model family is found by name: one of another family is added as new
files only, and an unknown name is an error that says what was looked for.

The toy family goes into a copy of the benchmark, as a later change would
add one: its package, a matrix kind, a configuration, a traffic file, and
entries appended to ``BENCHMARK.json``. The copy runs it on the CPU in a
process of its own, through ``run.load_cell`` and ``run.run_cell``."""

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run
from portbench.tests.conftest import SEED, WORKLOADS, tiny_cell

ROOT = Path(__file__).resolve().parents[2]
CELL = "toy-predict-d3.tiles"
HOST_RATE = "lookahead_cand_per_s.host"

TOY = {
    "portbench/models/toy_predict/__init__.py": '''
"""A toy family: tiles of a PMF's predictions, through the port."""

import numpy as np

from portbench.check import rel_gap, worst


class PredictTiles:
    kind = "toy_predict_tiles"
    unit_counts = "candidates"

    def __init__(self, s, inputs):
        import torch

        from amf_tpu_torch.models import pmf

        self.cfg = pmf.PMFConfig(latent_d=s.config["latent_d"],
                                 subtract_mean=False)
        g = torch.Generator(device=s.device)
        g.manual_seed(s.seed)
        n, m = inputs.real.shape
        self.state = pmf.init_state(g, n, m, self.cfg, device=s.device)
        self.pool, self.C = inputs.pool, s.traffic["tile_candidates"]
        self.done = []

    def cands(self, t):
        return self.pool[(t * self.C + np.arange(self.C)) % len(self.pool)]

    def predict(self, t):
        import torch

        from amf_tpu_torch.models import pmf

        flat = pmf.predicted_matrix(self.state, self.cfg).flatten()
        return flat[torch.as_tensor(self.cands(t))]

    def warm(self):
        self.predict(0)

    def unit(self):
        t = len(self.done)
        self.done.append((self.cands(t), self.predict(t)))
        return self.C

    def failed(self):
        return 0

    def free(self):
        self.U, self.V = (x.double().cpu().numpy()
                          for x in (self.state.U, self.state.V))
        self.done = [(c, p.double().cpu().numpy()) for c, p in self.done]
        del self.state

    def check(self, inputs):
        want = (self.U @ self.V.T).ravel()
        gap = 0.0
        for cands, got in self.done:
            for c, p in zip(cands, got):
                gap = worst(gap, rel_gap(p, want[c]))
        return {"pred_gap": gap}


LOOPS = {"predict_tiles": PredictTiles}
''',
    "portbench/matrices/toy_integers.py": '''
"""toy_integers: uniform ratings 1..5, a sixth of the cells unrated."""

import numpy as np


def make(config):
    rng = np.random.default_rng(config["data"]["seed"])
    shape = (config["rows"], config["cols"])
    return rng.integers(0, 6, size=shape).astype(np.float64)
''',
    "portbench/configs/toy-predict-d3.json": json.dumps({
        "name": "toy-predict-d3", "model": "toy_predict", "rows": 12,
        "cols": 15, "latent_d": 3, "data": {"kind": "toy_integers", "seed": 7},
        "split": {"kind": "uniform", "seed": 8, "known": 30, "test": 20}}),
    "portbench/traffic/toy-predict-tiles.json": json.dumps({
        "loop": "predict_tiles", "tile_candidates": 4, "trace_units": 1,
        "check": {"limits": {"pred_gap": 1e-6}}}),
}

PROBE = """
import json, sys
from portbench import run
from amf_tpu_torch.utils.platform import resolve_device
out = run.run_cell(run.load_cell(sys.argv[1]), int(sys.argv[2]), 0.2, False,
                   resolve_device("cpu"))
print(json.dumps({"line": out, "harness": run.__file__}))
"""


def _files(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def _with_toy(man: dict) -> dict:
    man = json.loads(json.dumps(man))
    man["configs"].append({
        "name": "toy-predict-d3", "source": "a toy, for this test",
        "file": "portbench/configs/toy-predict-d3.json", "reduced": [],
        "why": "a family that is not Gibbs"})
    man["workloads"].append({
        "name": CELL, "config": "toy-predict-d3",
        "traffic": "toy-predict-tiles", "chips": 1,
        "why": "tiles of 4 predictions"})
    next(m for m in man["end_to_end"]
         if m["name"] == HOST_RATE)["workloads"].append(CELL)
    return man


def test_a_new_family_runs_from_new_files_only(tmp_path):
    tree = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", tree / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tree / "BENCHMARK.json")
    before = _files(tree)
    man = json.loads(before["BENCHMARK.json"])
    for rel, text in TOY.items():
        assert rel not in before
        (tree / rel).parent.mkdir(parents=True, exist_ok=True)
        (tree / rel).write_text(text.lstrip())
    (tree / "BENCHMARK.json").write_text(json.dumps(_with_toy(man), indent=2))

    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    got = subprocess.run([sys.executable, "-c", PROBE, CELL, str(SEED)],
                         cwd=tree, env=env, capture_output=True, text=True,
                         timeout=120)
    assert got.returncode == 0, got.stderr[-4000:]
    res = json.loads(got.stdout.strip().splitlines()[-1])
    assert Path(res["harness"]).resolve().is_relative_to(tree.resolve())
    line = res["line"]
    assert line["correct"] is True and line["failed"] == 0, line
    assert line["attempted"] > 0 and line["attempted"] % 4 == 0
    assert set(line["metrics"]) == {"setup_s", HOST_RATE}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["checks"]["pred_gap"]["value"] <= 1e-6

    after = _files(tree)
    assert set(after) == set(before) | set(TOY)
    for rel, data in before.items():
        if rel != "BENCHMARK.json":
            assert after[rel] == data, rel
    # the manifest only appended to: its entries, in order, as they were
    assert json.loads(after["BENCHMARK.json"]) == _with_toy(man)


@pytest.mark.parametrize("what, looked_for", [
    ("model", "portbench/models/no_such_family/__init__.py is not a file"),
    ("loop", "'no_such_loop' in LOOPS of "
             "portbench/models/bpmf_gibbs/__init__.py"),
    ("matrix", "portbench/matrices/no_such_kind.py is not a file"),
    ("split", "portbench/splits/no_such_kind.py is not a file"),
])
def test_an_unknown_name_says_what_was_looked_for(what, looked_for, cpu):
    cell = tiny_cell(WORKLOADS[0])
    c, t = cell.config, cell.traffic
    if what == "model":
        c["model"] = "no_such_family"
    elif what == "loop":
        t["loop"] = "no_such_loop"
    elif what == "matrix":
        c["data"]["kind"] = "no_such_kind"
    else:
        c["split"]["kind"] = "no_such_kind"
    with pytest.raises(LookupError, match=re.escape(looked_for)):
        run.run_cell(dataclasses.replace(cell, config=c, traffic=t), SEED,
                     0.2, False, cpu)
