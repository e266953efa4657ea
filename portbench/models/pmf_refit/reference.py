"""Plain PyTorch reference of what the ``pmf_refit`` family's cells run.

The one-step lookahead of python-pmf's ``add_rmse_boosts.py``
(``fit_worker``): for a candidate cell, add its true rating to the known
ones, refit the PMF MAP factors from the base MAP by the reference's
adaptive-rate ascent (``pmf.py:179-211``, ``fit_lls``), and take the test
RMSE of the refitted prediction U V^T.

Every lane is a dense problem: the known ratings with the lane's own cell
set to its value, masks (L, n, m), no index, no kernel. The objective is
PMF's negative log posterior

    f(U, V) = sum_mask (R - U V^T)^2 / 2 s + |U|^2 / 2 su + |V|^2 / 2 sv

with s, su, sv = 1, 10, 10, and its descent direction is the ascent
gradient of the log posterior. The rule: propose x + lr g; accept when
the objective is finite and lower (lr x 1.25; done when it fell by less
than the stop threshold), else reject (lr / 2; done when the next lr would
sink below its floor); at most ``max_steps`` proposals; a lane that is done
keeps its point. Lanes run side by side and never mix.

It runs in the dtype it is given (float64 for the check; float32 with TF32
matmuls is the control), on the card or the CPU, with TF32 off unless a
caller asks for it. It imports nothing of the port.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

# the reference's constants (python-pmf pmf.py:26-41)
SIGMA_SQ, SIGMA_U_SQ, SIGMA_V_SQ = 1.0, 10.0, 10.0
GROW, SHRINK = 1.25, 0.5


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Both TF32 switches set to ``tf32`` inside the block; they come
    back after it."""
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was


@dataclasses.dataclass(frozen=True)
class Rule:
    """The ascent's knobs (pmf.py:28-30) and its budget of proposals."""

    lr0: float
    stop_thresh: float
    min_lr: float
    max_steps: int


@dataclasses.dataclass
class Data:
    """One problem in the reference's dtype: the known ratings (``R``, 0
    elsewhere), the true matrix and the test cells, dense."""

    R: torch.Tensor  # (n, m)
    known: torch.Tensor  # (n, m) bool
    real: torch.Tensor  # (n, m)
    test: torch.Tensor  # (n, m) bool

    @classmethod
    def build(cls, real, known, test, dtype, device) -> "Data":
        def t(x, dt):
            return torch.as_tensor(np.asarray(x), device=device).to(dt)

        known_t, real_t = t(known, torch.bool), t(real, dtype)
        return cls(R=torch.where(known_t, real_t, 0.0), known=known_t,
                   real=real_t, test=t(test, torch.bool))


@dataclasses.dataclass
class Cells:
    """Each lane's added rating: value ``v`` at cell (i, j); None for the
    base problem alone."""

    i: torch.Tensor
    j: torch.Tensor
    v: torch.Tensor

    @classmethod
    def true_values(cls, data: Data, flat) -> "Cells":
        """The cells ``flat`` (flat indices) at their true values."""
        flat = torch.as_tensor(np.asarray(flat, dtype=np.int64),
                               device=data.R.device)
        i, j = flat // data.R.shape[1], flat % data.R.shape[1]
        return cls(i=i, j=j, v=data.real[i, j])


def _lanes(data: Data, cells, L: int):
    """(mask, ratings), (L, n, m): the known cells plus each lane's own."""
    mask = data.known.expand(L, *data.known.shape).clone()
    R = data.R.expand(L, *data.R.shape).clone()
    if cells is not None:
        lane = torch.arange(L, device=mask.device)
        mask[lane, cells.i, cells.j] = True
        R[lane, cells.i, cells.j] = cells.v
    return mask, R


def neg_log_post(data: Data, U, V, cells=None, tf32: bool = False):
    """(L,) negative log posterior of each lane at (U (L, n, d), V (L, m,
    d)) and its descent direction (gU, gV)."""
    with matmul_precision(tf32):
        mask, R = _lanes(data, cells, U.shape[0])
        E = torch.where(mask, R - U @ V.mT, 0.0)
        f = ((E * E).sum((-2, -1)) / (2 * SIGMA_SQ)
             + (U * U).sum((-2, -1)) / (2 * SIGMA_U_SQ)
             + (V * V).sum((-2, -1)) / (2 * SIGMA_V_SQ))
        E = E / SIGMA_SQ
        return f, (E @ V - U / SIGMA_U_SQ, E.mT @ U - V / SIGMA_V_SQ)


def refit(data: Data, U0, V0, cells, rule: Rule, tf32: bool = False,
          accepts: Optional[int] = None
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every lane's ascent from (U0 (n, d), V0 (m, d)) under ``rule``:
    (U (L, n, d), V (L, m, d), f (L,)). ``cells`` None refits the base
    problem alone, one lane. With ``accepts``, a lane also stops once it
    has accepted that many steps."""
    L = 1 if cells is None else len(cells.i)
    U = U0.expand(L, *U0.shape).clone()
    V = V0.expand(L, *V0.shape).clone()
    f, (gu, gv) = neg_log_post(data, U, V, cells, tf32)
    lr = torch.full_like(f, rule.lr0)
    done = torch.zeros(L, dtype=torch.bool, device=f.device)
    taken = torch.zeros(L, dtype=torch.long, device=f.device)
    for _ in range(rule.max_steps):
        if bool(done.all()):
            break
        live = ~done
        Up = U + lr[:, None, None] * gu
        Vp = V + lr[:, None, None] * gv
        fp, (gup, gvp) = neg_log_post(data, Up, Vp, cells, tf32)
        ok = live & torch.isfinite(fp) & (fp < f)
        stop = torch.where(ok, (f - fp) < rule.stop_thresh,
                           lr * SHRINK < rule.min_lr)
        take = ok[:, None, None]
        U, V = torch.where(take, Up, U), torch.where(take, Vp, V)
        gu, gv = torch.where(take, gup, gu), torch.where(take, gvp, gv)
        f = torch.where(ok, fp, f)
        lr = torch.where(live, torch.where(ok, lr * GROW, lr * SHRINK), lr)
        taken = taken + ok.long()
        if accepts is not None:
            stop = stop | (taken >= accepts)
        done = done | (live & stop)
    return U, V, f


def heldout_rmse(data: Data, U, V, tf32: bool = False) -> torch.Tensor:
    """(L,) RMSE of each lane's prediction U V^T on the test cells."""
    with matmul_precision(tf32):
        err = torch.where(data.test, U @ V.mT - data.real, 0.0)
        return torch.sqrt((err * err).sum((-2, -1))
                          / data.test.sum().clamp(min=1))


def init_factors(seed: int, n: int, m: int, d: int, device):
    """The MAP fit's start, U ~ U(0, 1) (n, d) then V (m, d), float32,
    from one generator seeded with ``seed`` on ``device``."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    U = torch.rand((n, d), generator=g, dtype=torch.float32, device=device)
    V = torch.rand((m, d), generator=g, dtype=torch.float32, device=device)
    return U, V
