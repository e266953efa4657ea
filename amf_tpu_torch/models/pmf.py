"""MAP Probabilistic Matrix Factorization (mirrors ``amf_tpu/models/pmf.py``).

Gaussian likelihood with Gaussian priors on U and V, fit by the reference's
adaptive-learning-rate batch ascent ``fit_lls`` (python-pmf/pmf.py:179-211),
optionally with the exact quartic line search.

Every function takes one problem or a tile of lookahead lanes. For one
problem U is (n, d) and ``mean_rating`` a scalar. For lanes U is (L, n, d),
V (L, m, d), ``mean_rating`` (L,), and ``lanes`` says which hypothesised
rating each lane adds to the shared base problem: the (n, m) matrices are
never copied per lane, each lane's own cell is patched into its residual.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from amf_tpu_torch.ops.linesearch import (
    DescentInfo, _bcast, adaptive_descent, adaptive_descent_poly,
)
from amf_tpu_torch.types import LaneCells, Problem


class PMFConfig(NamedTuple):
    """Static hyperparameters (reference defaults: pmf.py:26-41)."""

    latent_d: int = 1
    subtract_mean: bool = False
    learning_rate: float = 1e-4
    min_learning_rate: float = 1e-10
    stop_thresh: float = 1e-2
    max_fit_steps: int = 2000
    # negative variance = no hyperprior on log sigma_{u,v}^2 (pmf.py:37-41)
    sig_u_mean: float = 0.0
    sig_u_var: float = -1.0
    sig_v_mean: float = 0.0
    sig_v_var: float = -1.0


@dataclasses.dataclass(frozen=True)
class PMFState:
    U: torch.Tensor  # (n, d) or (L, n, d)
    V: torch.Tensor  # (m, d) or (L, m, d)
    sigma_sq: torch.Tensor
    sigma_u_sq: torch.Tensor
    sigma_v_sq: torch.Tensor
    mean_rating: torch.Tensor  # () or (L,)


def init_state(
    generator: torch.Generator, n: int, m: int, cfg: PMFConfig,
    problem: Optional[Problem] = None, dtype=torch.float32, device="cpu",
) -> PMFState:
    """Uniform(0, 1) factor init (reference: pmf.py:55-56)."""
    U = torch.rand((n, cfg.latent_d), generator=generator, dtype=dtype,
                   device=device)
    V = torch.rand((m, cfg.latent_d), generator=generator, dtype=dtype,
                   device=device)
    mean = (problem.mean_rating() if problem is not None
            else torch.zeros((), dtype=dtype))

    def scalar(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    return PMFState(U=U, V=V, sigma_sq=scalar(1.0), sigma_u_sq=scalar(10.0),
                    sigma_v_sq=scalar(10.0),
                    mean_rating=mean.to(dtype=dtype, device=device))


def refresh_mean_rating(state: PMFState, problem: Problem,
                        lanes: Optional[LaneCells] = None) -> PMFState:
    """Recompute the observed mean after mask changes (pmf.py:90)."""
    mean = problem.mean_rating() if lanes is None else lanes.mean_rating(problem)
    return dataclasses.replace(state, mean_rating=mean.to(state.U.dtype))


def predicted_matrix(state: PMFState, cfg: PMFConfig) -> torch.Tensor:
    pred = state.U @ state.V.mT
    if cfg.subtract_mean:
        pred = pred + state.mean_rating[..., None, None]
    return pred


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inner product over the last two dims, per leading index."""
    return (a * b).sum(dim=(-2, -1))


def _masked(P: torch.Tensor, problem: Problem,
            lanes: Optional[LaneCells]) -> torch.Tensor:
    """``P`` zeroed off each lane's rated cells, in place."""
    if lanes is None:
        return P.masked_fill_(~problem.rated, 0.0)
    lane = torch.arange(len(lanes), device=P.device)
    cell = P[lane, lanes.i, lanes.j]
    P.masked_fill_(~problem.rated, 0.0)
    P[lane, lanes.i, lanes.j] = cell
    return P


def _residual(state: PMFState, problem: Problem, cfg: PMFConfig,
              U: torch.Tensor, V: torch.Tensor,
              lanes: Optional[LaneCells]) -> torch.Tensor:
    """E = rated * (R_obs - pred), one (n, m) per lane, built in place."""
    pred = U @ V.mT
    if cfg.subtract_mean:
        pred.add_(state.mean_rating[..., None, None])
    if lanes is None:
        return pred.neg_().add_(problem.R_obs).masked_fill_(~problem.rated, 0.0)
    lane = torch.arange(len(lanes), device=pred.device)
    cell = lanes.v - pred[lane, lanes.i, lanes.j]
    E = pred.neg_().add_(problem.R_obs).masked_fill_(~problem.rated, 0.0)
    E[lane, lanes.i, lanes.j] = cell
    return E


def log_likelihood(
    state: PMFState, problem: Problem, cfg: PMFConfig,
    U: Optional[torch.Tensor] = None, V: Optional[torch.Tensor] = None,
    lanes: Optional[LaneCells] = None,
) -> torch.Tensor:
    """Unnormalized log posterior (reference: pmf.py:104-121)."""
    U = state.U if U is None else U
    V = state.V if V is None else V
    E = _residual(state, problem, cfg, U, V, lanes)
    return (
        -_vdot(E, E) / (2 * state.sigma_sq)
        - _vdot(U, U) / (2 * state.sigma_u_sq)
        - _vdot(V, V) / (2 * state.sigma_v_sq)
    )


def gradient(
    state: PMFState, problem: Problem, cfg: PMFConfig,
    U: Optional[torch.Tensor] = None, V: Optional[torch.Tensor] = None,
    lanes: Optional[LaneCells] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form ascent gradient: one masked residual + two matmuls
    (reference: pmf.py:132-149)."""
    U = state.U if U is None else U
    V = state.V if V is None else V
    resid = _residual(state, problem, cfg, U, V, lanes).div_(state.sigma_sq)
    grad_u = resid @ V - U / state.sigma_u_sq
    grad_v = resid.mT @ U - V / state.sigma_v_sq
    return grad_u, grad_v


def _neg_ll_and_ascent(state, problem, cfg, uv, lanes):
    """(-log_likelihood, ascent gradient) from one shared residual — the
    closed form where the JAX package differentiates the value."""
    U, V = uv
    E = _residual(state, problem, cfg, U, V, lanes)
    f = (_vdot(E, E) / (2 * state.sigma_sq)
         + _vdot(U, U) / (2 * state.sigma_u_sq)
         + _vdot(V, V) / (2 * state.sigma_v_sq))
    E.div_(state.sigma_sq)
    return f, (E @ V - U / state.sigma_u_sq, E.mT @ U - V / state.sigma_v_sq)


def _delta_poly(state, problem, cfg, uv, g, lanes=None):
    """Exact improvement quartic along the ascent ray (poly line search).

    The neg-log-posterior at ``(U + a*gu, V + a*gv)`` is a quartic in ``a``
    because pred' = pred + a*P1 + a^2*P2 with P1 = gu V^T + U gv^T,
    P2 = gu gv^T. Returns (c1..c4) of the IMPROVEMENT polynomial
    ``delta(a) = f(0) - f(a)``, built from masked cross-reductions directly.
    """
    U, V = uv
    gu, gv = g
    E = _residual(state, problem, cfg, U, V, lanes)
    mp2 = _masked(gu @ gv.mT, problem, lanes)
    a2 = _vdot(E, mp2)
    del E
    P1 = gu @ V.mT
    P1 += U @ gv.mT
    mp1 = _masked(P1, problem, lanes)
    a11 = _vdot(mp1, mp1)
    a12 = _vdot(mp1, mp2)
    del mp1
    a22 = _vdot(mp2, mp2)
    s = state.sigma_sq
    uu, vv = _vdot(gu, gu), _vdot(gv, gv)
    b2 = 0.5 * (uu / state.sigma_u_sq + vv / state.sigma_v_sq)
    # c1 = a1/s - <U,gu>/su - <V,gv>/sv algebraically, but that difference of
    # large reductions IS the squared gradient norm (cancellation near
    # convergence) — use the exact identity instead.
    c1 = uu + vv
    c2 = -(a11 - 2.0 * a2) / (2.0 * s) - b2
    c3 = -a12 / s
    c4 = -a22 / (2.0 * s)
    return c1, c2, c3, c4


def fit(
    state: PMFState, problem: Problem, cfg: PMFConfig,
    max_steps: Optional[int] = None,
    poly_ls: bool = False,
    lanes: Optional[LaneCells] = None,
) -> Tuple[PMFState, DescentInfo]:
    """Batch MAP fit — the reference's ``fit_lls`` adaptive-LR ascent
    (pmf.py:179-211): gradient recomputed only on accepted steps; lr grows
    1.25x on accept and halves on reject; stops when an accepted step
    improves by < stop_thresh or lr < min_learning_rate.

    ``poly_ls=True`` decides rejected learning rates by the exact quartic
    (``adaptive_descent_poly``) instead of full value passes. With
    ``lanes`` every lane runs its own fit, in lockstep.
    """
    max_steps = cfg.max_fit_steps if max_steps is None else max_steps

    def value_and_grad_fn(uv):
        return _neg_ll_and_ascent(state, problem, cfg, uv, lanes)

    def step_fn(uv, g, lr):
        return (uv[0] + _bcast(lr, uv[0]) * g[0],
                uv[1] + _bcast(lr, uv[1]) * g[1])

    common = dict(lr0=cfg.learning_rate, stop_thresh=cfg.stop_thresh,
                  min_lr=cfg.min_learning_rate, max_steps=max_steps)
    if poly_ls:
        (U, V), info = adaptive_descent_poly(
            (state.U, state.V), value_and_grad_fn, step_fn,
            lambda uv, g: _delta_poly(state, problem, cfg, uv, g, lanes),
            **common)
    else:
        (U, V), info = adaptive_descent(
            (state.U, state.V), value_and_grad_fn, step_fn, **common)
    return dataclasses.replace(state, U=U, V=V), info


def parse_fit_type(string: str) -> tuple:
    """Parse the reference's fit-type mini-DSL, e.g. 'mini-valid,100,50'
    (reference: pmf.py:338-350)."""
    res = []
    for x in string.split(","):
        for fn in (int, float):
            try:
                res.append(fn(x))
                break
            except ValueError:
                pass
        else:
            res.append(x)
    return tuple(res)


def do_fit(
    state: PMFState, problem: Problem, cfg: PMFConfig,
    fit_type: tuple = ("batch",),
) -> PMFState:
    """Dispatch on fit type (reference: pmf.py:217-224). Only 'batch' is
    ported; the others are a ROADMAP item of the port."""
    kind = fit_type[0]
    if kind == "batch":
        return fit(state, problem, cfg)[0]
    raise NotImplementedError(
        f"fit type {kind!r} is not ported yet (ROADMAP.md, port queue A, "
        "'Left out of the first slice': the lbfgs and mini-valid fit types)")


def rmse(state: PMFState, problem: Problem, cfg: PMFConfig, real, on=None):
    from amf_tpu_torch.analysis import metrics

    pred = predicted_matrix(state, cfg)
    if on is None:
        return metrics.rmse(pred, real)
    return metrics.rmse_on(pred, real, on)
