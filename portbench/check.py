"""Whether what the timed path produced is correct: the rule every family's
check is judged by, and the arithmetic its checks share.

A loop's ``check(inputs)`` (``portbench/loops.py``) compares the port's
outputs with the family's plain reference once the window has closed and
the port's state is freed, and returns {name: number}. Each number has its
limit in the traffic file (``check.limits``); a run is correct when every
number is within its limit, nothing failed and something was attempted
(``judge``). A number whose limit the traffic file lacks fails.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def rel_gap(a: float, b: float) -> float:
    if not (np.isfinite(a) and np.isfinite(b)):
        return float("inf")
    return abs(a - b) / max(abs(b), 1e-300)


def worst(a: float, b: float) -> float:
    """The larger gap, where a gap that is not a number is infinite."""
    return max(a if np.isfinite(a) else np.inf, b if np.isfinite(b) else np.inf)


def judge(numbers: Dict[str, float], limits: Dict[str, float],
          attempted: int, failed: int) -> Tuple[bool, List[tuple]]:
    """(correct, [(name, value, limit)])."""
    rows = [(k, float(numbers[k]), limits.get(k)) for k in numbers]
    ok = attempted > 0 and failed == 0 and all(
        lim is not None and np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
