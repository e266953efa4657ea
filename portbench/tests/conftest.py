"""Fixtures of the benchmark's own tests.

    python -m pytest portbench/tests -q          # the CPU tests; card tests skip
    python -m pytest portbench/tests -q -m cuda  # on a card host

A cut-down cell is the cell's own configuration and traffic file at a
size the CPU runs in seconds; its limits are the traffic file's.
"""

import copy
import dataclasses

import pytest
import torch

from portbench import run

torch.set_num_threads(1)

WORKLOADS = ("ml100k-bpmf-d20.expvar-tiles", "db70x306-bpmf-d20.expvar-tiles",
             "ml100k-bpmf-d20.predvar-steps")
SEED = 2 ** 31 + 977


def tiny_cell(workload: str) -> run.Cell:
    """``workload`` at a size for the CPU: the shapes, counts and samples
    cut, everything else as the files have it."""
    cell = run.load_cell(workload)
    c = copy.deepcopy(cell.config)
    if c["data"]["kind"] == "ratings":
        c.update(rows=12, cols=15)
        c["data"].update(rated_cells=120, min_per_row=3)
        c["split"].update(known=30, test=20)
    else:
        c.update(rows=10, cols=14)
        c["data"].update(positive_share=0.4)
        c["split"].update(known=20, test=20)
    c.update(latent_d=3, base_samples=8, lookahead_samples=4,
             lookahead_fit_budget=20)
    t = copy.deepcopy(cell.traffic)
    if "tile_candidates" in t:
        t["tile_candidates"] = 4
    return dataclasses.replace(cell, config=c, traffic=t)


@pytest.fixture
def cpu():
    from amf_tpu_torch.utils.platform import resolve_device

    return resolve_device("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells' kernels have no CPU mode")
    from amf_tpu_torch.utils.platform import resolve_device

    return resolve_device("cuda")
