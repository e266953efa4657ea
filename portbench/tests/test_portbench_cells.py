"""Each traffic file's cell, cut down to the CPU, run end to end: the
result line, the records of the steps against ``drive_active``'s, and
the faults the check has to catch."""

import json

import numpy as np
import pytest
import torch

from portbench import loops, run
from portbench.data import make_inputs
from portbench.models import bpmf_gibbs as gibbs
from portbench.tests.conftest import SEED, WORKLOADS, tiny_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_prints_the_contract_line(workload, trace, cpu, capsys):
    cell = tiny_cell(workload)
    out = run.run_cell(cell, SEED, 0.2, trace, cpu)
    assert run.emit(out) == 0
    std = capsys.readouterr()
    line = json.loads(std.out.strip().splitlines()[-1])
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    names = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names  # every end-to-end metric
    for k, c in line["checks"].items():
        assert f"check {k}: " in std.err and c["value"] <= c["limit"]
    assert std.err.rstrip().endswith("correct: True")


def test_steps_follow_drive_active(cpu):
    """The harness's steps give ``drive_active``'s records, seed for seed."""
    from amf_tpu_torch.active.driver import drive_active

    cell = tiny_cell("ml100k-bpmf-d20.predvar-steps")
    inputs = make_inputs(cell.config)
    s = loops.Setting(cell.config, cell.traffic, SEED, cpu)
    steps = gibbs.ActiveSteps(s, inputs)
    K = 5
    for _ in range(K):
        steps.unit()
    prob, family, state0 = gibbs.family_setup(s, inputs)
    want = drive_active(prob, inputs.real, ["pred-variance"], family, state0,
                        SEED, steps=K + 1)["pred-variance"]
    assert len(want) == len(steps.records) == K + 1
    for got, rec in zip(steps.records, want):
        assert got[:3] == rec[:3]
        assert (got[3] is None) == (rec[3] is None)
        if got[3] is not None:
            np.testing.assert_array_equal(got[3], rec[3])


def test_tiles_refuse_another_criterion(cpu):
    """A lookahead traffic file that names another criterion is refused,
    not run as exp-variance."""
    cell = tiny_cell("ml100k-bpmf-d20.expvar-tiles")
    cell.traffic["criterion"] = "exp-entropy-est"
    s = loops.Setting(cell.config, cell.traffic, SEED, cpu)
    with pytest.raises(ValueError, match="exp-entropy-est"):
        gibbs.LookaheadTiles(s, make_inputs(cell.config))


@pytest.mark.parametrize("width", [4, 32, 256])
def test_tile_sample_covers_every_quarter(width):
    """However the seed falls, the candidates checked come from both
    halves of the tiles and from even and odd positions."""
    from portbench.models.bpmf_gibbs import check

    groups = [check.quarter(k, width) for _ in range(3) for k in range(width)]
    for seed in range(50):
        got = check.stratified(np.random.default_rng(seed), groups, 4)
        assert len(set(got)) == 4
        assert sorted(groups[i] for i in got) == [0, 1, 2, 3]


def _run(workload, cpu):
    return run.run_cell(tiny_cell(workload), SEED, 0.2, False, cpu)


@pytest.mark.parametrize("workload", WORKLOADS[:2])
@pytest.mark.parametrize("fault", ["answer_swapped", "half_batch"])
def test_tile_faults_fail_the_check(workload, fault, cpu, monkeypatch):
    from amf_tpu_torch.models import bpmf_gibbs

    real = bpmf_gibbs.exp_variance_scores

    def broken(*a, **k):
        out = real(*a, **k)
        if fault == "answer_swapped":  # two candidates' answers exchanged
            return out.flip(0)
        half = out.shape[0] // 2  # half the tile left out, the mean in its place
        return torch.cat([out[:half], out[:half].mean().expand(
            out.shape[0] - half)])

    assert _run(workload, cpu)["correct"] is True
    monkeypatch.setattr(bpmf_gibbs, "exp_variance_scores", broken)
    out = _run(workload, cpu)
    assert out["correct"] is False
    assert out["checks"]["score_gap"]["value"] > \
        out["checks"]["score_gap"]["limit"]


@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered",
                                   "refit_skipped"])
def test_step_faults_fail_the_check(fault, cpu, monkeypatch):
    real = gibbs.family_setup

    def broken(s, inputs):
        prob, family, state0 = real(s, inputs)
        if fault == "state_unchanged":  # the refit returns its state
            family = family._replace(refit=lambda st, p, k: st)
        else:  # the recorded error altered where it is produced
            err = family.err
            family = family._replace(err=lambda st, p: err(st, p) * 1.01)
        return prob, family, state0

    workload = "ml100k-bpmf-d20.predvar-steps"
    assert _run(workload, cpu)["correct"] is True
    if fault == "refit_skipped":  # the MAP not refitted, the chain redrawn
        with gibbs.refit_skipped():
            out = _run(workload, cpu)
        gap = out["checks"]["refit_gap"]
        assert gap["value"] > gap["limit"]
    else:
        monkeypatch.setattr(gibbs, "family_setup", broken)
        out = _run(workload, cpu)
    assert out["correct"] is False
