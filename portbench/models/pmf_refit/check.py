"""The ``pmf_refit`` family's check: the port's refitted lanes against the
plain reference (``reference.py`` beside this file), in float64, once the
window has closed and the port's state is freed.

**The sample** (``Sample``). Each tile keeps one lane's outputs on the
host: its test RMSE, its ``neg_ll`` and its refitted factors. The lane
lies in quarter t mod 4 of tile t's positions (first or second half, even
or odd: ``quarter``), at a position drawn from
``--seed``; a reservoir of ``check.candidates / 4`` lanes a quarter,
drawn from ``--seed`` too, keeps a uniform sample of each quarter's
offers over the whole run. Every tile copies its one lane in the same
way, whatever the seed and whether the reservoir keeps it, so every seed
times the same work and the host holds at most ``check.candidates``
lanes' factors.

**The numbers**, over the sampled lanes, each from the port's MAP (the
base the tiles were refit from) with the lane's cell added at its true
value:

  * ``rmse_gap``: the recorded RMSE against the reference's test RMSE of
    the port's own refitted factors (relative);
  * ``value_gap``: the recorded ``neg_ll`` against the reference's
    objective at the port's factors, the lane's cell counted (relative);
  * ``refit_gap``: the nats by which that objective lies above the
    reference's float64 refit from the same MAP under the same rule, cut
    at its first accepted step (0 below it): the step every refit takes,
    at the starting rate. One-sided, like the active steps' ``refit_gap``.
    No end point is compared: float32 rounding flips accepts and stops,
    and from there the lanes that go on past their first step end up to
    several nats apart either way in float32 and float64 (``PERF.md``
    section 2 gives the readings), more than a lane gains by its first
    step;
  * ``cell_fit_gap``: the share of the sampled cells' residual at the
    MAP, v - u_i . v_j summed in absolute value over the lanes, that the
    port's refits leave beyond what the reference's own float64 refit
    from the same MAP under the same rule and budget leaves (negative
    where they leave less). This one sees the whole refit and the lane's
    cell in it: the reference's refit closes all but a few hundredths of
    each cell's residual, while a refit that stopped short or descended
    without the cell (in its gradient, its value, or both) leaves nearly
    all of it. The sum over the lanes holds it where one lane cannot: the
    rows of the most rated items are the problem's stiffest, and there
    the rule's rate rides the edge of stability, so their factors bounce
    from proposal to proposal, in float32 and float64 alike, and move a
    lane's prediction by up to a third of a rating either way (``PERF.md``
    section 2). No gradient at the end point is compared: on those rows
    it is the bounce's.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from portbench.check import rel_gap, worst
from portbench.models.pmf_refit import reference as ref
from portbench.seeds import fold_in_name, numpy_seed

NUMBERS = ("rmse_gap", "value_gap", "refit_gap", "cell_fit_gap")


def quarter(k: int, width: int) -> int:
    """Which quarter of a tile's positions ``k`` lies in: first or second
    half, even or odd."""
    return 2 * int(k >= width // 2) + k % 2


def rule_of(config: dict, traffic: dict) -> ref.Rule:
    return ref.Rule(lr0=config["learning_rate"],
                    stop_thresh=config["stop_thresh"],
                    min_lr=config["min_learning_rate"],
                    max_steps=traffic.get("refit_steps",
                                          config["refit_steps"]))


class Sample:
    """The lanes a run keeps for the check (see the module)."""

    def __init__(self, seed: int, candidates: int):
        self.rng = np.random.default_rng(
            numpy_seed(fold_in_name(seed, "check")))
        self.slots = -(-candidates // 4)
        self.offers = [0] * 4
        self.kept: Dict[tuple, tuple] = {}  # (quarter, slot): the lane

    def position(self, t: int, width: int) -> int:
        """The position in tile ``t`` whose lane the tile copies."""
        q = t % 4
        spots = [k for k in range(width) if quarter(k, width) == q]
        if not spots:  # a tile narrower than four lanes
            spots = list(range(width))
        return int(spots[self.rng.integers(len(spots))])

    def offer(self, t: int, lane: tuple) -> None:
        """Tile ``t``'s copied lane: kept, in place of another, or not."""
        q = t % 4
        self.offers[q] += 1
        slot = (self.offers[q] - 1 if self.offers[q] <= self.slots
                else int(self.rng.integers(self.offers[q])))
        if slot < self.slots:
            self.kept[(q, slot)] = lane

    def lanes(self) -> List[tuple]:
        return [self.kept[k] for k in sorted(self.kept)]


def check_lanes(config, traffic, inputs, lanes, start, device,
                dtype=None) -> Dict[str, float]:
    """``lanes``: [(flat cell, rmse, neg_ll, U (n, d), V (m, d))] as the
    port gave them; ``start``: the MAP (U, V) the tiles were refit from."""
    import torch

    dtype = dtype or torch.float64
    if not lanes:
        return {k: float("inf") for k in NUMBERS}
    data = ref.Data.build(inputs.real, inputs.known, inputs.test, dtype,
                          device)

    def on(x):
        return torch.as_tensor(x).to(device=device, dtype=dtype)

    cells = ref.Cells.true_values(data, [c for c, *_ in lanes])
    U = torch.stack([on(u) for *_, u, _ in lanes])
    V = torch.stack([on(v) for *_, v in lanes])
    rmse = ref.heldout_rmse(data, U, V).cpu().numpy()
    rule = rule_of(config, traffic)
    U0, V0 = on(start[0]), on(start[1])
    value = ref.neg_log_post(data, U, V, cells)[0].cpu().numpy()
    _, _, f_end = ref.refit(data, U0, V0, cells, rule, accepts=1)
    f_end = f_end.cpu().numpy()
    U_ref, V_ref, _ = ref.refit(data, U0, V0, cells, rule)
    out = dict.fromkeys(NUMBERS, 0.0)
    for (_, r, f, _, _), r_ref, f_ref, f_best in zip(lanes, rmse, value,
                                                     f_end):
        out["rmse_gap"] = worst(out["rmse_gap"], rel_gap(r, r_ref))
        out["value_gap"] = worst(out["value_gap"], rel_gap(f, f_ref))
        out["refit_gap"] = worst(out["refit_gap"],
                                 _above(float(f_ref - f_best)))
    L = len(lanes)
    base = (U0.expand(L, -1, -1), V0.expand(L, -1, -1))
    left, left_ref, at_map = (_residual(cells, *uv) for uv in
                              ((U, V), (U_ref, V_ref), base))
    out["cell_fit_gap"] = ((left - left_ref) / at_map if at_map > 0
                           else float("inf"))
    return out


def _residual(cells, U, V) -> float:
    """|v - u_i . v_j| at each lane's cell, from its factors (L, n, d) and
    (L, m, d), summed over the lanes."""
    import torch

    lane = torch.arange(len(cells.i), device=cells.i.device)
    pred = (U[lane, cells.i] * V[lane, cells.j]).sum(-1)
    return float((cells.v - pred).abs().sum())


def _above(x: float) -> float:
    """``x`` where it is positive or not finite, else 0."""
    return max(x, 0.0) if np.isfinite(x) else x
