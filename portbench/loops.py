"""What every model family's loops share: the setting a loop is built with,
the window that times its units, and the contract a loop keeps.

A configuration's ``model`` names its family, the package
``portbench/models/<model>/`` (``run.family``), and a traffic file's
``loop`` names one of that family's loops. A family's ``__init__.py``
holds:

  * ``LOOPS``: {loop name: class}. ``Loop(setting, inputs)`` (a
    ``Setting``; the configuration's ``data.Inputs``) starts the family on
    the device: the port's problem and whatever state its first unit needs;
  * ``CONTROLS`` (for ``python3 -m portbench.control``): {loop name:
    ``control(cell, seed, device, units)``}, the compared numbers of the
    reference put in the port's place;
  * ``FAULTS`` (for ``--fault``): {name: a context manager that plants the
    fault in the port}.

A loop has:

  * ``kind``: its name, on which the per-layer readers key;
  * ``unit_counts``: what ``unit()`` returns a count of, on which the
    end-to-end readers key: ``"candidates"`` (lookahead candidates scored;
    ``lookahead_cand_per_s``) or ``"steps"`` (active steps, one a unit;
    ``active_step_s``);
  * ``warm()``: a unit's work at the cell's shapes, in set-up;
  * ``unit()``: the next unit; returns what it attempted. A unit that
    fails is recorded for ``failed()``, not raised;
  * ``failed()``: how many of the attempted failed;
  * ``free()``: drops the port's state; what ``check`` needs stays, on the
    host;
  * ``check(inputs)``: once freed, {name: number} against the family's
    plain reference, each held to the traffic file's ``check.limits``
    (``check.judge``);
  * ``exhausted()``, optionally: True where no unit is left; the window
    then closes.

The harness times units (``run_window``) and never looks inside one.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np


@dataclasses.dataclass
class Setting:
    """What the port is run with: the cell's configuration and traffic,
    ``--seed`` and the device."""

    config: dict
    traffic: dict
    seed: int
    device: object  # torch.device

    @property
    def values(self):
        return tuple(float(v) for v in self.config["values"])

    @property
    def binary(self) -> bool:
        return self.config["error"] == "misclassification"


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Window:
    seconds: float  # host clock, synchronize to synchronize
    units: int
    attempted: int
    unit_s: List[float]  # each unit's host time, synchronize to synchronize


def run_window(loop, seconds: float, device,
               stop: Optional[Callable[[], bool]] = None) -> Window:
    """Units back to back until the first that ends at or after
    ``seconds``; each unit ends in a synchronize, and so does the window."""
    sync(device)
    t0 = time.perf_counter()
    attempted, ends = 0, [0.0]
    while True:
        attempted += loop.unit()
        sync(device)
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds or (stop is not None and stop()):
            return Window(ends[-1], len(ends) - 1, attempted,
                          list(np.diff(ends)))
