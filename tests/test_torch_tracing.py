"""The port's spans (``amf_tpu_torch/utils/profiling.py``) on the CPU:
off, they record nothing and open no profiler range; on (under a
profiler or ``tracing()``), they nest by id, read tensor attributes only
when read, stop with the profiler, and sit on the clock of its Chrome
trace. Then where the port opens them, and the benchmark's span readers
on cut-down cells traced here (a number where the host clock is their
source, None where they need the card)."""

import json
import time

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a worker)
from amf_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _fresh():
    profiling.spans(reset=True)
    yield
    profiling.spans(reset=True)


def _profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    opened = []
    real = profiling._autograd_profiler.record_function
    monkeypatch.setattr(profiling._autograd_profiler, "record_function",
                        lambda name: opened.append(name) or real(name))
    assert not profiling.enabled()
    first, second = profiling.span("a"), profiling.span("b", n=1)
    assert first is second  # the one shared null context
    with first as sp:
        sp.set(iters=3)
        with second:
            pass
    assert profiling.spans() == [] and opened == []
    with profiling.tracing():  # on, but no profiler to show a range
        with profiling.span("c"):
            pass
    with _profiler():
        with profiling.span("d"):
            pass
    assert opened == ["d"]
    assert [s.name for s in profiling.spans()] == ["c", "d"]


@pytest.mark.parametrize("how", ["profiler", "tracing"])
def test_spans_nest_with_their_parent_and_root(how):
    on = _profiler() if how == "profiler" else profiling.tracing()
    with on:
        with profiling.span("outer", k=1):
            time.sleep(0.02)
            with profiling.span("mid"):
                with profiling.span("leaf"):
                    time.sleep(0.01)
            with profiling.span("side"):
                time.sleep(0.01)
        with profiling.span("next"):
            pass
    recs = profiling.spans()
    by = {s.name: s for s in recs}
    assert [s.name for s in recs] == ["outer", "mid", "leaf", "side", "next"]
    outer = by["outer"]
    assert outer.parent is None and outer.root == outer.id
    assert by["mid"].parent == outer.id and by["side"].parent == outer.id
    assert by["leaf"].parent == by["mid"].id
    assert {by[n].root for n in ("mid", "leaf", "side")} == {outer.id}
    assert by["next"].parent is None and by["next"].root == by["next"].id
    assert outer.attrs == {"k": 1} and outer.stream_s is None  # no card
    for s in recs:
        assert s.start_ns <= s.end_ns
    own = profiling.self_s(outer, recs)
    assert own == pytest.approx(
        outer.host_s - by["mid"].host_s - by["side"].host_s, abs=1e-12)
    assert 0.02 <= own <= outer.host_s - 0.02
    assert profiling.self_s(by["leaf"], recs) == by["leaf"].host_s


def test_spans_stop_recording_when_the_profiler_exits():
    with _profiler():
        with profiling.span("in"):
            pass
    assert not profiling.enabled()
    with profiling.span("after"):
        pass
    assert [s.name for s in profiling.spans()] == ["in"]


def test_a_tensor_attribute_is_read_only_by_spans():
    counts = torch.zeros(4, dtype=torch.int32)
    with profiling.tracing():
        with profiling.span("fit") as sp:
            sp.set(accepts=counts, iters=7)
    assert sp.attrs["accepts"] is counts  # kept as it is until read
    counts += torch.tensor([1, 2, 3, 6], dtype=torch.int32)
    (got,) = profiling.spans()
    assert got.attrs == {"accepts": 3.0, "iters": 7}


def test_spans_sit_on_the_chrome_trace_clock(tmp_path):
    x = torch.ones(128, 128)
    with profiling.device_trace(str(tmp_path)):
        with profiling.span("matmul"):
            (x @ x).sum()
    with open(tmp_path / "trace.json") as f:
        trace = json.load(f)
    with open(tmp_path / "spans.json") as f:
        saved = json.load(f)
    base = trace["baseTimeNanoseconds"]
    assert saved["baseTimeNanoseconds"] == base
    (mm,) = [e for e in trace["traceEvents"]
             if e.get("name") == "aten::mm" and e.get("ph") == "X"]
    (sp,) = profiling.spans()
    start, end = profiling.on_trace_clock(sp, base)
    assert start <= mm["ts"] and mm["ts"] + mm["dur"] <= end
    (row,) = saved["spans"]
    assert row["name"] == "matmul"
    assert (row["ts"], row["ts"] + row["dur"]) == pytest.approx((start, end))
    # without the header: the whole seconds from a host operator near it
    assert profiling.trace_base_ns(sp.start_ns, mm["ts"]) == base
    assert profiling.trace_base_ns(sp.end_ns, mm["ts"] + mm["dur"]) == base


@pytest.mark.parametrize("poly_ls", [False, True])
def test_a_fit_counts_its_loop_passes_and_accepts(poly_ls, monkeypatch):
    from amf_tpu_torch import types
    from amf_tpu_torch.models import pmf
    from amf_tpu_torch.utils.rng import generator

    rng = np.random.default_rng(3)
    real = rng.integers(1, 6, size=(6, 5)).astype(float)
    known = rng.random((6, 5)) < 0.5
    prob = types.problem_from_dense(real, known, dtype=torch.float64,
                                    device="cpu")
    cfg = pmf.PMFConfig(latent_d=2)
    st = pmf.init_state(generator(1, "cpu"), 6, 5, cfg, prob,
                        dtype=torch.float64, device="cpu")
    calls = []
    inner = pmf._neg_ll_and_ascent
    monkeypatch.setattr(pmf, "_neg_ll_and_ascent",
                        lambda *a: calls.append(1) or inner(*a))
    with profiling.tracing():
        _, info = pmf.fit(st, prob, cfg, max_steps=40, poly_ls=poly_ls)
    (sp,) = profiling.spans()
    assert sp.name == "pmf.fit"
    # one value-and-gradient pass a loop pass, plus the first (the poly
    # loop's first epoch uses that one)
    assert sp.attrs["iters"] == info.loop_iters == len(calls) - (not poly_ls)
    assert 1 <= info.loop_iters <= 40
    assert sp.attrs["accepts"] == float(info.n_accepts)


def _gibbs_setup():
    from amf_tpu_torch import types
    from amf_tpu_torch.models import bpmf_gibbs, pmf
    from amf_tpu_torch.utils.rng import generator

    rng = np.random.default_rng(6)
    real = rng.integers(1, 6, size=(7, 6)).astype(float)
    known = rng.random((7, 6)) < 0.4
    known[0], known[:, 0] = True, True
    prob = types.problem_from_dense(real, known, dtype=torch.float64,
                                    device="cpu")
    pcfg = pmf.PMFConfig(latent_d=2, subtract_mean=True)
    gcfg = bpmf_gibbs.GibbsConfig(latent_d=2)
    pst = pmf.init_state(generator(1, "cpu"), 7, 6, pcfg, prob,
                         dtype=torch.float64, device="cpu")
    pst, _ = pmf.fit(pst, prob, pcfg)
    _, stats, _ = bpmf_gibbs.run_chain(
        bpmf_gibbs.init_chain(pst), prob, gcfg, 8,
        generator=generator(2, "cpu"),
        value_bounds=(0.5, 1.5, 2.5, 3.5, 4.5, 5.5))
    return real, prob, pcfg, gcfg, pst, stats


def test_a_lookahead_tile_is_one_tree_of_spans():
    from amf_tpu_torch.models import bpmf_gibbs

    _, prob, pcfg, gcfg, pst, stats = _gibbs_setup()
    cand = torch.nonzero(prob.queryable.flatten())[:3, 0]
    with profiling.tracing():
        bpmf_gibbs.exp_variance_scores(
            4, pst, prob, pcfg, gcfg, stats, (1.0, 2.0, 3.0, 4.0, 5.0),
            num_samps=3, fit_budget=10, n_base_samples=8, cand=cand)
    recs = profiling.spans()
    tile, fit, chain, *noise = recs
    assert (tile.name, fit.name, chain.name) == (
        "lookahead.tile", "pmf.fit", "gibbs.chain")
    assert fit.parent == chain.parent == tile.id
    # the CPU keeps the dense product of the mask
    assert chain.attrs == {"rounds": 3, "lanes": 15, "gram_index": 0}
    assert [s.name for s in noise] == ["gibbs.noise"] * 3
    assert {s.parent for s in noise} == {chain.id}
    assert {s.root for s in recs} == {tile.id}
    assert 1 <= fit.attrs["iters"] <= 10 and fit.attrs["accepts"] > 0


def test_the_active_step_holds_the_familys_spans():
    from amf_tpu_torch.active.driver import drive_active
    from amf_tpu_torch.active.gibbs_loop import gibbs_family

    real, prob, *_ = _gibbs_setup()
    prob, family, state0 = gibbs_family(
        prob, real, latent_d=2, rating_values=(1.0, 2.0, 3.0, 4.0, 5.0),
        num_samps=4, seed=3, dtype=torch.float64, device="cpu")
    with profiling.tracing():
        drive_active(prob, real, ["pred-variance"], family, state0, 5,
                     steps=3)
    recs = profiling.spans()
    by_id = {s.id: s for s in recs}
    steps = [s for s in recs if s.name == "active.step"]
    assert len(steps) == 2 and all(s.parent is None for s in steps)
    for name in ("active.score", "active.refit", "active.err"):
        got = [s for s in recs if s.name == name]
        # the first record's error is read before any step
        want = 3 if name == "active.err" else 2
        assert len(got) == want
        assert [by_id[s.parent].name for s in got if s.parent] == \
            ["active.step"] * 2
    for name in ("pmf.fit", "gibbs.chain"):
        (a, b) = [s for s in recs if s.name == name]
        assert by_id[a.parent].name == by_id[b.parent].name == "active.refit"


# ---------------------------------------------------------------------------
# the benchmark's span readers on cut-down cells, traced on the CPU

READERS = {  # metric: (cell, reads a number on the CPU)
    "lookahead_refit_pct": ("ml100k-bpmf-d20.expvar-tiles", False),
    "lookahead_refit_iters": ("ml100k-bpmf-d20.expvar-tiles", True),
    "lookahead_refit_pct.host": ("db70x306-bpmf-d20.expvar-tiles", False),
    "lookahead_noise_idle_pct.host": ("db70x306-bpmf-d20.expvar-tiles",
                                      False),
    "active_fit_s": ("ml100k-bpmf-d20.predvar-steps", True),
    "active_chain_s": ("ml100k-bpmf-d20.predvar-steps", True),
    "active_fit_steps": ("ml100k-bpmf-d20.predvar-steps", True),
    "active_chain_idle_pct": ("ml100k-bpmf-d20.predvar-steps", False),
}


@pytest.fixture(scope="module")
def traced_cells():
    from portbench import run
    from portbench.tests.conftest import SEED, tiny_cell
    from amf_tpu_torch.utils.platform import resolve_device

    out = {}
    for workload in sorted({c for c, _ in READERS.values()}):
        profiling.spans(reset=True)
        line = run.run_cell(tiny_cell(workload), SEED, 0.2, True,
                            resolve_device("cpu"))
        out[workload] = line, profiling.spans(reset=True)
    return out


@pytest.mark.parametrize("metric", sorted(READERS))
def test_span_reader_on_a_traced_cut_down_cell(metric, traced_cells):
    workload, number = READERS[metric]
    line, recs = traced_cells[workload]
    assert line["correct"] is True
    assert recs  # the traced units ran under the profiler: tracing on
    got = line["metrics"].get(metric)
    if number:
        assert got is not None and got["value"] > 0
        assert np.isfinite(got["value"])
    else:  # stream events and the device trace need the card
        assert got is None


def test_gram_index_reader_on_a_traced_cut_down_cell(traced_cells):
    """The share of lane chains on the index Gram: 0 on the CPU, where the
    chains take the dense product (the card takes the index)."""
    line, recs = traced_cells["ml100k-bpmf-d20.expvar-tiles"]
    chains = [s for s in recs if s.name == "gibbs.chain"]
    assert chains and all(s.attrs["gram_index"] == 0 for s in chains)
    assert line["metrics"]["lookahead_gram_index_pct"]["value"] == 0.0
