"""The ``pmf_refit`` family: the PMF-refit lookahead of the port's
``add_rmse_boosts`` CLI (``amf_tpu_torch/run/add_rmse_boosts.py``), the
reference's ``fit_worker`` (python-pmf ``add_rmse_boosts.py``): for each
queryable cell, add its true rating, refit the MAP factors from the base
MAP, and take the test RMSE.

Its loop (a traffic file's ``loop``):

  * ``boost_tiles``: a closed loop of the CLI's tiles, back to back in one
    process. Set-up puts the problem on the device as the CLI does
    (``types.problem_from_ratings`` in float32) and fits the base MAP
    (``pmf.init_state`` from a generator seeded with the configuration's
    ``family_seed``, then ``pmf.fit``). Tile t is ``tile_candidates``
    consecutive cells of the flat queryable pool, from an offset drawn
    from the traffic's ``start_seed`` (the same tiles for every
    ``--seed``; the warm tile is t = -1), each at its true value, through
    the CLI's own ``add_rmse_boosts.boost_tile`` with its ``refit_steps``:
    the lanes' refit on the value+gradient kernel (B4) and the RMSE
    chunks. A unit is one tile; it copies the tile's RMSEs and one lane's
    outputs to the host (``check.Sample``). ``--seed`` draws only which
    lanes the check samples.

The configuration gives the widths, the data, the ascent's knobs
(``learning_rate``, ``stop_thresh``, ``min_learning_rate``: the CLI's
``PMFConfig`` defaults) and the CLI's ``tile`` and ``refit_steps``, which
a traffic file may set for itself. The check is ``check.py``'s, against
``reference.py``; ``counts.py`` counts B4's operations and bytes and a
tile's, for ``b4_roofline_pct.boost`` and ``boost_mfu``.

The control (``CONTROLS``): the reference put in the port's place, in
float32 with TF32 matmuls, from its own MAP fit in the same precision,
over ``units`` tiles of the traffic's width from the same offset; it
refits only the lane of each tile that the sample copies (lanes never
mix), and is judged by the float64 reference as a run is. ``FAULTS``
holds the second control and the two faults, each planted in the port's
``pmf.fit_lookahead_batch`` as ``boost_tile`` calls it:

  * ``bf16_carry``: the port's own precision below float32, its bf16
    carry (``lane_block`` 8, ``bf16``: B2 on the card);
  * ``refit_skipped``: no proposal is made, each lane returns the base
    MAP and its objective there;
  * ``refit_cut``: each lane's refit cut to its first proposal;
  * ``cell_dropped``: each lane's rating left out (every lane adds a cell
    that is already known, at its known value);
  * ``grad_cell_dropped``: the lane's rating left out of the gradients
    that the value+gradient kernel returns, and kept in the value, so the
    refit descends the base problem and is judged on the lane's.
"""

from __future__ import annotations

import contextlib
import sys
import traceback

import numpy as np

from portbench.loops import Setting
from portbench.models.pmf_refit import check
from portbench.models.pmf_refit import reference as ref


def family_setup(s: Setting, inputs):
    """The port's problem, true matrix, config and base MAP on the device,
    as the CLI makes them."""
    import torch

    from amf_tpu_torch import types
    from amf_tpu_torch.models import pmf
    from amf_tpu_torch.utils.rng import generator

    c = s.config
    if c["subtract_mean"]:
        raise ValueError("the PMF-refit cells run without --subtract-mean, "
                         "as add_rmse_boosts does")
    rated = np.argwhere(inputs.known)
    ratings = np.column_stack([rated, inputs.real[inputs.known]])
    prob = types.problem_from_ratings(ratings, real=inputs.real,
                                      test=inputs.test, dtype=torch.float32,
                                      device=s.device)
    n, m = prob.shape
    cfg = pmf.PMFConfig(latent_d=c["latent_d"], subtract_mean=False,
                        learning_rate=c["learning_rate"],
                        stop_thresh=c["stop_thresh"],
                        min_learning_rate=c["min_learning_rate"],
                        max_fit_steps=c["map_fit_steps"])
    st = pmf.init_state(generator(c["family_seed"], s.device), n, m, cfg,
                        prob, dtype=torch.float32, device=s.device)
    st, _ = pmf.fit(st, prob, cfg)
    real = torch.as_tensor(inputs.real, dtype=torch.float32, device=s.device)
    return prob, real, cfg, st


def offset_for(traffic: dict, pool: int) -> int:
    """Where tile 0 starts in the pool, drawn from ``start_seed``."""
    return int(np.random.default_rng(traffic["start_seed"]).integers(pool))


def tile_cells(pool: np.ndarray, offset: int, width: int, t: int
               ) -> np.ndarray:
    return pool[(offset + t * width + np.arange(width)) % len(pool)]


class BoostTiles:
    """Tiles of ``add_rmse_boosts`` (see the module)."""

    kind = "boost_tiles"
    unit_counts = "candidates"

    def __init__(self, s: Setting, inputs):
        self.s = s
        self.prob, self.real, self.cfg, self.st = family_setup(s, inputs)
        self.start = (self.st.U, self.st.V)
        self.C = s.traffic.get("tile_candidates", s.config["tile"])
        self.steps = s.traffic.get("refit_steps", s.config["refit_steps"])
        self.pool = inputs.pool
        self.offset = offset_for(s.traffic, len(self.pool))
        self.sample = check.Sample(s.seed, s.traffic["check"]["candidates"])
        self.lanes = self.C
        self.next = 0
        self.rmses = []  # each tile's (L,) RMSEs on the host, None if raised
        # each tile's B4 launches and plain calls: one of them an evaluation
        self.launches = []

    def cands(self, t: int) -> np.ndarray:
        return tile_cells(self.pool, self.offset, self.C, t)

    def tile(self, t: int):
        import torch

        from amf_tpu_torch.run import add_rmse_boosts

        return add_rmse_boosts.boost_tile(
            self.st, self.prob, self.cfg, self.real,
            torch.as_tensor(self.cands(t), device=self.s.device), self.steps)

    def warm(self) -> None:
        self.tile(-1)

    def unit(self) -> int:
        """Refit the next tile; copy its RMSEs and the sampled lane's
        outputs to the host; returns the candidates it attempted."""
        import torch

        from amf_tpu_torch.ops import pmf_kernels as pk

        t = self.next
        self.next += 1
        before = _launch_counts(pk)
        try:
            out = self.tile(t)
            p = self.sample.position(t, self.C)
            host = torch.cat([out.rmse, out.neg_ll.to(out.rmse.dtype),
                              out.U[p].flatten(), out.V[p].flatten()]).cpu()
        except RuntimeError:
            traceback.print_exc()
            self.rmses.append(None)
            self.launches.append((0, 0))
            return self.C
        after = _launch_counts(pk)
        self.launches.append((after[0] - before[0], after[1] - before[1]))
        C, (n, m), d = self.C, self.prob.shape, self.cfg.latent_d
        rmse, neg_ll = host[:C].numpy(), host[C:2 * C].numpy()
        self.rmses.append(rmse)
        uv = host[2 * C:].numpy()
        self.sample.offer(t, (int(self.cands(t)[p]), float(rmse[p]),
                              float(neg_ll[p]), uv[:n * d].reshape(n, d),
                              uv[n * d:].reshape(m, d)))
        return self.C

    def failed(self) -> int:
        return sum(self.C if r is None else int((~np.isfinite(r)).sum())
                   for r in self.rmses)

    def evaluations(self) -> list:
        """Each tile's value+gradient evaluations: its B4 launches, or on
        the CPU its calls of the plain version."""
        return [a + b for a, b in self.launches]

    def free(self) -> None:
        """Drop the port's state; the MAP and the sample stay, on the
        host. Standard error gets the tiles' B4 launches and the plain
        version's calls: on the card, no plain call means every evaluation
        of every proposal launched B4."""
        b4 = [a for a, _ in self.launches]
        plain = sum(b for _, b in self.launches)
        print(f"boost tiles: {len(b4)}; B4 launches a tile "
              f"{min(b4, default=0)} to {max(b4, default=0)}, {sum(b4)} in "
              f"all; plain value+gradient calls {plain}", file=sys.stderr)
        self.start = tuple(x.double().cpu() for x in self.start)
        del self.prob, self.real, self.st

    def check(self, inputs) -> dict:
        """The compared numbers (``check.check_lanes``), once freed."""
        s = self.s
        return check.check_lanes(s.config, s.traffic, inputs,
                                 self.sample.lanes(), self.start, s.device)


def _launch_counts(pk) -> tuple:
    """(B4 launches in float32, calls of the plain value+gradient) so far."""
    return (pk.pmf_value_grad_cuda.launches[("L,rows,d", "torch.float32")],
            pk.pmf_value_grad_plain.calls)


LOOPS = {"boost_tiles": BoostTiles}


@contextlib.contextmanager
def _planted(change):
    """``pmf.fit_lookahead_batch`` called as ``change(args, kwargs)`` has
    it, inside the block."""
    from amf_tpu_torch.models import pmf

    real = pmf.fit_lookahead_batch

    def planted(*args, **kwargs):
        args, kwargs = change(list(args), dict(kwargs))
        return real(*args, **kwargs)

    pmf.fit_lookahead_batch = planted
    try:
        yield
    finally:
        pmf.fit_lookahead_batch = real


def _bf16_carry(args, kwargs):
    kwargs.update(lane_block=8, bf16=True)
    return args, kwargs


def _refit_skipped(args, kwargs):
    kwargs["max_steps"] = 0
    return args, kwargs


def _refit_cut(args, kwargs):
    kwargs["max_steps"] = 1
    return args, kwargs


def _known_cells(rated, R, di):
    """(i, j, v) for every lane: the first rated cell at its rating."""
    import torch

    i, j = (int(x) for x in torch.nonzero(rated)[0])
    return (torch.full_like(di, i), torch.full_like(di, j),
            R[i, j].expand(di.shape[0]).clone())


def _cell_dropped(args, kwargs):
    _, problem, di, *_ = args
    args[2:5] = _known_cells(problem.rated, problem.R_obs, di)
    return args, kwargs


@contextlib.contextmanager
def _grad_cell_dropped():
    """``pmf_kernels.pmf_batched_value_grad`` (B4, and its plain version
    on the CPU) returning the value with the lanes' cells and the
    gradients without them, inside the block."""
    from amf_tpu_torch.ops import pmf_kernels as pk

    real = pk.pmf_batched_value_grad

    def planted(U, V, R, rated, di, dj, dv, sigmas, **kw):
        f, _, _ = real(U, V, R, rated, di, dj, dv, sigmas, **kw)
        _, gu, gv = real(U, V, R, rated, *_known_cells(rated, R, di), sigmas,
                         **kw)
        return f, gu, gv

    pk.pmf_batched_value_grad = planted
    try:
        yield
    finally:
        pk.pmf_batched_value_grad = real


FAULTS = {
    "bf16_carry": lambda: _planted(_bf16_carry),
    "refit_skipped": lambda: _planted(_refit_skipped),
    "refit_cut": lambda: _planted(_refit_cut),
    "cell_dropped": lambda: _planted(_cell_dropped),
    "grad_cell_dropped": _grad_cell_dropped,
}


def control_tiles(cell, seed, device, units):
    """The reference in the port's place, float32 with TF32 matmuls (see
    the module)."""
    import torch

    from portbench.data import make_inputs

    c, traffic = cell.config, cell.traffic
    inputs = make_inputs(c)
    rule = check.rule_of(c, traffic)
    width = traffic.get("tile_candidates", c["tile"])
    pool = inputs.pool
    offset = offset_for(traffic, len(pool))
    sample = check.Sample(seed, traffic["check"]["candidates"])
    data = ref.Data.build(inputs.real, inputs.known, inputs.test,
                          torch.float32, device)
    n, m = data.R.shape
    U0, V0 = ref.init_factors(c["family_seed"], n, m, c["latent_d"], device)
    fit_rule = ref.Rule(rule.lr0, rule.stop_thresh, rule.min_lr,
                        c["map_fit_steps"])
    U0, V0, _ = ref.refit(data, U0, V0, None, fit_rule, tf32=True)
    U0, V0 = U0[0], V0[0]
    for t in range(units):
        p = sample.position(t, width)
        flat = int(tile_cells(pool, offset, width, t)[p])
        cells = ref.Cells.true_values(data, [flat])
        U, V, f = ref.refit(data, U0, V0, cells, rule, tf32=True)
        r = ref.heldout_rmse(data, U, V, tf32=True)
        sample.offer(t, (flat, float(r[0]), float(f[0]),
                         U[0].cpu().numpy(), V[0].cpu().numpy()))
    start = (U0.double().cpu(), V0.double().cpu())
    del data
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return check.check_lanes(c, traffic, inputs, sample.lanes(), start,
                             device)


CONTROLS = {"boost_tiles": control_tiles}
