"""The port's profiling helpers (``amf_tpu_torch/utils/profiling.py``):
the spans' phase report reads as the JAX package's phase timers' does,
and ``device_trace`` writes a Chrome trace of the block (the host's
operators here, where there is no card). The spans themselves:
``tests/test_torch_tracing.py``."""

import json
import time

import torch

import torch_threads  # noqa: F401  (one torch thread a worker)
from amf_tpu.utils import profiling as jprof
from amf_tpu_torch.utils import profiling as tprof


def _timed_phases(mod, timer):
    mod.phase_report(reset=True)
    # the fit's total well above the scores' (the report sorts by total),
    # however late the sleeps wake
    for name, reps in (("fit", 2), ("score", 3)):
        for _ in range(reps):
            with timer(name):
                time.sleep(0.01 if name == "fit" else 0.001)
    return mod.phase_report(reset=True).splitlines()


def test_phase_report_matches_jax():
    with tprof.tracing():
        got = _timed_phases(tprof, tprof.span)
    want = _timed_phases(jprof, jprof.phase_timer)
    assert got[0] == want[0]
    assert len(got) == len(want) == 3
    # name and call count columns equal; times differ run to run
    for g, w in zip(got[1:], want[1:]):
        assert g.split()[:2] == w.split()[:2]
    assert tprof.phase_report().splitlines() == [got[0]]


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with tprof.device_trace(str(tmp_path / "trace")) as prof:
        x = torch.ones(64, 64)
        (x @ x).sum()
    assert prof is not None
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
