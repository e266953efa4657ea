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

import numpy as np
import torch

from amf_tpu_torch.ops.lbfgsb import lbfgsb
from amf_tpu_torch.ops.linesearch import (
    DescentInfo, _bcast, adaptive_descent, adaptive_descent_poly,
)
from amf_tpu_torch.types import LaneCells, Problem
from amf_tpu_torch.utils.platform import resolve_device
from amf_tpu_torch.utils.profiling import span


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
    problem: Optional[Problem] = None, dtype=torch.float32, device=None,
) -> PMFState:
    """Uniform(0, 1) factor init (reference: pmf.py:55-56) on ``device``
    (None: the card, ``utils.platform.resolve_device``); ``generator``
    must live there."""
    device = resolve_device(device)
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


def ll_prior_adjustment(state: PMFState, problem: Problem,
                        cfg: PMFConfig) -> torch.Tensor:
    """Variance-dependent normalization terms (reference: pmf.py:123-127)."""
    n, m = problem.shape
    d = cfg.latent_d
    return -0.5 * (torch.log(state.sigma_sq) * problem.n_rated
                   + n * d * torch.log(state.sigma_u_sq)
                   + m * d * torch.log(state.sigma_v_sq))


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
    with span("pmf.fit") as sp:
        if poly_ls:
            (U, V), info = adaptive_descent_poly(
                (state.U, state.V), value_and_grad_fn, step_fn,
                lambda uv, g: _delta_poly(state, problem, cfg, uv, g, lanes),
                **common)
        else:
            (U, V), info = adaptive_descent(
                (state.U, state.V), value_and_grad_fn, step_fn, **common)
        sp.set(iters=info.loop_iters, accepts=info.n_accepts)
    return dataclasses.replace(state, U=U, V=V), info


def update_sigma(state: PMFState, problem: Problem,
                 cfg: PMFConfig) -> PMFState:
    """Type-II ML noise-variance update (reference: pmf.py:151-157)."""
    err = torch.where(problem.rated,
                      problem.R_obs - predicted_matrix(state, cfg), 0.0)
    n_rated = problem.n_rated.clamp(min=1)
    return dataclasses.replace(state, sigma_sq=(err * err).sum() / n_rated)


def update_sigma_uv(state: PMFState, problem: Problem,
                    cfg: PMFConfig) -> PMFState:
    """Prior-variance updates (reference: pmf.py:159-177, with the item norm
    from V as in pmf_cy.pyx:243)."""
    n, m = problem.shape
    d = cfg.latent_d

    def update(norm2, rows, sigma_sq, mean, var):
        if var > 0:
            return norm2 / (rows * d + 2
                            + 2 * (torch.log(sigma_sq) - mean) / var)
        return norm2 / (rows * d)

    return dataclasses.replace(
        state,
        sigma_u_sq=update((state.U * state.U).sum(), n, state.sigma_u_sq,
                          cfg.sig_u_mean, cfg.sig_u_var),
        sigma_v_sq=update((state.V * state.V).sum(), m, state.sigma_v_sq,
                          cfg.sig_v_mean, cfg.sig_v_var))


def fit_with_sigmas(
    state: PMFState, problem: Problem, cfg: PMFConfig,
    max_outer: int = 25, max_steps: Optional[int] = None,
) -> PMFState:
    """Alternate full factor fits with sigma updates until a fit accepts at
    most one step or ``max_outer`` fits ran (the JAX package's loop; the
    reference interleaves the updates inside its fit generator,
    pmf.py:286-305, to the same type-II ML fixed point). The host reads
    each fit's accept count."""
    max_steps = cfg.max_fit_steps if max_steps is None else max_steps
    for _ in range(max_outer):
        state, info = fit(state, problem, cfg, max_steps=max_steps)
        state = update_sigma_uv(update_sigma(state, problem, cfg), problem,
                                cfg)
        if int(info.n_accepts) <= 1:
            break
    return state


POLY_RUNGS = 64  # rungs of the poly loop: lr down to min_lr from any lr


def _poly_epochs(value_grad, coeffs, U, V, cfg: PMFConfig, max_steps: int):
    """The poly-LS epoch loop of ``amf_tpu/models/pmf.py`` (its
    ``fit_lookahead_batch(poly_ls=True)``), lanes in lockstep.

    Each epoch takes the improvement quartic of every lane along its ascent
    direction (``coeffs``), walks the halving ladder lr, lr/2, ... in closed
    form, moves each lane that hits a rung to it, and refreshes value and
    gradients at the (maybe unchanged) point (``value_grad``). A lane is
    done when its step improves by < stop_thresh, or when no rung hits
    (its budget of ``max_steps`` proposals spent, or lr below min_lr). The
    carry keeps U's dtype. Returns (U, V, f, proposals) with f from the
    last refresh and the rungs each lane examined (L,) int32; the host
    reads ``done`` once an epoch.
    """
    f, gu, gv = value_grad(U, V)
    L, dev = f.shape[0], f.device
    lr = torch.full((L,), cfg.learning_rate, dtype=torch.float32, device=dev)
    done = torch.zeros(L, dtype=torch.bool, device=dev)
    n_it = torch.zeros(L, dtype=torch.int32, device=dev)
    rung = torch.arange(POLY_RUNGS, dtype=torch.int32, device=dev)
    half_pow = 0.5 ** rung.to(torch.float32)
    first = torch.ones((L, 1), dtype=torch.bool, device=dev)
    while bool((~done).any()):
        c1, c2, c3, c4 = (c[:, None] for c in coeffs(U, V, gu, gv))
        alpha = lr[:, None] * half_pow  # (L, rungs)
        dlt = alpha * (c1 + alpha * (c2 + alpha * (c3 + alpha * c4)))
        accept = torch.isfinite(dlt) & (dlt > 0)
        stop_rej = ~accept & (alpha * 0.5 < cfg.min_learning_rate)
        prev_ok = torch.cat([first, torch.cumprod(
            (~accept & ~stop_rej).to(torch.int32), dim=1)[:, :-1].bool()],
            dim=1)
        examined = (prev_ok & ((n_it[:, None] + rung) < max_steps)
                    & ~done[:, None])
        hit = examined & accept
        any_hit = hit.any(dim=1)
        t_star = torch.argmax(hit.to(torch.int32), dim=1, keepdim=True)
        a_star = alpha.gather(1, t_star)[:, 0]
        d_star = dlt.gather(1, t_star)[:, 0]
        consumed = torch.where(any_hit, t_star[:, 0].to(torch.int32) + 1,
                               examined.sum(dim=1).to(torch.int32))
        step = any_hit[:, None, None]
        U = torch.where(step, (U + a_star[:, None, None] * gu).to(U.dtype), U)
        V = torch.where(step, (V + a_star[:, None, None] * gv).to(V.dtype), V)
        # on lanes that accepted nothing this recomputes the same point
        f, gu, gv = value_grad(U, V)
        lr = torch.where(any_hit, a_star * 1.25,
                         lr * 0.5 ** consumed.to(torch.float32))
        done = done | torch.where(any_hit, d_star < cfg.stop_thresh, True)
        n_it = n_it + consumed
    return U, V, f, n_it


def fit_lookahead_batch(
    state: PMFState, problem: Problem,
    delta_i: torch.Tensor, delta_j: torch.Tensor, delta_v: torch.Tensor,
    cfg: PMFConfig, max_steps: int, use_pallas: bool = True,
    block_rows: int = 256, bf16: bool = False, lane_block: int = 0,
    fused: bool = False, poly_ls: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Refit the MAP factors for L hypothesised (i, j, v) ratings at once.

    Mirrors ``amf_tpu/models/pmf.py::fit_lookahead_batch``: the adaptive
    accept/reject ascent of ``fit`` on every lane in lockstep, each lane
    the shared base problem plus its own cell, with the kernels of
    ``ops/pmf_kernels``:

      * ``fused`` and ``lane_block > 0``: the whole line search in one
        launch, ``pmf_lookahead_fused_t``;
      * ``lane_block > 0``: value and gradients from
        ``pmf_batched_value_grad_t``; the carry is (L, d, rows), bf16 when
        ``bf16``, transposed once at each end. The proposal loop runs on
        ``adaptive_descent``; with ``poly_ls`` the epoch loop decides every
        rejected lr by the exact quartic (``pmf_line_coeffs_t``);
      * else ``use_pallas``: ``pmf_batched_value_grad``;
      * else the plain version, ``pmf_batched_value_grad_reference``.

    ``poly_ls`` needs ``lane_block > 0`` (ValueError); ``fused`` without it
    takes the proposal loop, as in the JAX package. On CUDA tensors the
    kernel paths launch the CUDA kernels (the JAX name ``use_pallas`` is
    kept), on one index of the rated cells built here, once a call.
    Returns (U (L, n, d), V (L, m, d), neg_ll (L,)), float32, the kernels'
    type; from a float64 state on CPU tensors outside the lane-blocked
    routes, float64 through the plain version (the wrappers' plain dispatch
    would take it to float32). Assumes subtract_mean=False, as the JAX
    function does.

    The span ``pmf.refit_batch`` holds the refit (``lanes``, ``route``:
    ``fused``, ``poly``, ``value_grad_t``, ``value_grad`` or ``plain``,
    ``max_steps``; on the proposal loop ``passes``, ``proposals`` and
    ``accepts``, the last two the lanes' means).
    """
    if fused and lane_block:
        route = "fused"
    elif poly_ls:
        route = "poly"
    else:
        route = ("value_grad_t" if lane_block else
                 "value_grad" if use_pallas else "plain")
    with span("pmf.refit_batch", lanes=int(delta_i.shape[0]), route=route,
              max_steps=max_steps) as sp:
        U, V, f, info = _refit_batch(
            state, problem, delta_i, delta_j, delta_v, cfg, max_steps,
            use_pallas, block_rows, bf16, lane_block, fused, poly_ls)
        if info is not None:
            sp.set(passes=info.loop_iters, proposals=info.n_iters,
                   accepts=info.n_accepts)
    return U, V, f


def _refit_batch(state, problem, delta_i, delta_j, delta_v, cfg, max_steps,
                 use_pallas, block_rows, bf16, lane_block, fused, poly_ls):
    """The body of ``fit_lookahead_batch``: (U, V, f, DescentInfo or
    None)."""
    from amf_tpu_torch.ops import pmf_kernels as pk

    L = delta_i.shape[0]
    n, m = problem.shape
    f32 = torch.float32
    f64 = state.U.dtype == torch.float64
    if f64 and (problem.R_obs.is_cuda or lane_block):
        raise ValueError("a float64 refit runs the plain version on CPU "
                         "tensors, without lane blocks")
    dtype = torch.float64 if f64 else f32
    sigmas = torch.stack(
        [state.sigma_sq, state.sigma_u_sq, state.sigma_v_sq]).to(dtype)
    args = (problem.R_obs, problem.rated, delta_i, delta_j, delta_v, sigmas)
    # the kernels' walk of the rated cells, indexed once for the whole refit
    # (it synchronises the host); the plain versions on the CPU take none
    index = None
    if problem.R_obs.is_cuda and (lane_block or use_pallas):
        index = pk.rated_index(problem.rated, problem.R_obs, bf16=bf16)
    if fused and lane_block:
        ls_params = torch.tensor(
            [cfg.learning_rate, cfg.stop_thresh, cfg.min_learning_rate],
            dtype=f32, device=sigmas.device)
        f, Ut, Vt = pk.pmf_lookahead_fused_t(
            state.U.mT.to(f32), state.V.mT.to(f32), *args, ls_params,
            max_steps=max_steps, block_rows=block_rows,
            lanes_per_block=lane_block, bf16=bf16, index=index)
        return Ut.mT, Vt.mT, f, None
    if poly_ls and not lane_block:
        raise ValueError("poly_ls requires lane_block > 0")
    if lane_block:
        fn, kw = pk.pmf_batched_value_grad_t, dict(
            block_rows=block_rows, lanes_per_block=lane_block, bf16=bf16)
    elif use_pallas and not f64:
        fn, kw = pk.pmf_batched_value_grad, dict(block_rows=block_rows,
                                                 bf16=bf16)
    else:
        fn, kw = pk.pmf_batched_value_grad_reference, {}
    vg_kw = dict(kw, index=index) if fn is not \
        pk.pmf_batched_value_grad_reference else kw

    U0 = state.U.to(dtype).expand(L, n, cfg.latent_d)
    V0 = state.V.to(dtype).expand(L, m, cfg.latent_d)
    if lane_block:
        U0, V0 = U0.mT, V0.mT
        if bf16:
            U0, V0 = U0.to(torch.bfloat16), V0.to(torch.bfloat16)
    U0, V0 = U0.contiguous(), V0.contiguous()
    info = None
    if poly_ls:
        U, V, f, _ = _poly_epochs(
            lambda U, V: fn(U, V, *args, **vg_kw),
            lambda *uvg: pk.pmf_line_coeffs_t(*uvg, *args, **vg_kw),
            U0, V0, cfg, max_steps)
    else:
        def value_and_grad_fn(uv):
            f, gu, gv = fn(*uv, *args, **vg_kw)
            return f, (gu, gv)

        def step_fn(uv, g, lr):
            return tuple((x + _bcast(lr, x) * gx).to(x.dtype)
                         for x, gx in zip(uv, g))

        (U, V), info = adaptive_descent(
            (U0, V0), value_and_grad_fn, step_fn,
            lr0=cfg.learning_rate, stop_thresh=cfg.stop_thresh,
            min_lr=cfg.min_learning_rate, max_steps=max_steps)
        f = info.final_value
    if lane_block:
        U, V = U.mT.to(f32), V.mT.to(f32)
    return U, V, f, info


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


def fit_lbfgs(
    state: PMFState, problem: Problem, cfg: PMFConfig,
    max_iters: int = 500,
) -> PMFState:
    """MAP fit via (unconstrained) L-BFGS, the faster alternative to the
    reference's adaptive-LR ascent for large problems (SURVEY.md §7 build
    plan). Same optimum, different trajectory; use fit() for parity runs.
    The gradient is the closed form of ``gradient``; search trials
    evaluate the value alone.
    """
    n, m = problem.shape
    d = cfg.latent_d

    def split(x):
        return x[:, : n * d].reshape(n, d), x[:, n * d:].reshape(m, d)

    def fun(x):
        f, (gu, gv) = _neg_ll_and_ascent(state, problem, cfg, split(x), None)
        return f[None], -torch.cat([gu.reshape(-1), gv.reshape(-1)])[None]

    def value(x):
        U, V = split(x)
        return -log_likelihood(state, problem, cfg, U=U, V=V)[None]

    x0 = torch.cat([state.U.reshape(-1), state.V.reshape(-1)])[None]
    res = lbfgsb(fun, x0, -torch.inf, torch.inf, max_iters=max_iters,
                 pgtol=1e-8, value_fn=value)
    U, V = split(res.x)
    return dataclasses.replace(state, U=U, V=V)


# ---------------------------------------------------------------------------
# Minibatch SGD path (reference: fit_minibatches* pmf.py:226-284)


class MiniBatchNoise:
    """The draws of the 'mini-valid' fit, from one ``torch.Generator``: the
    validation subset (on the host) and one permutation of all cells an
    epoch (on the generator's device). The tests replay the JAX package's
    key stream by overriding both methods."""

    def __init__(self, generator: torch.Generator):
        self.gen = generator

    def valid_subset(self, rated_idx: np.ndarray, size: int) -> np.ndarray:
        """``size`` of the rated flat cells ``rated_idx``, drawn without
        replacement."""
        pick = torch.randperm(rated_idx.size, generator=self.gen,
                              device=self.gen.device)[:size]
        return rated_idx[pick.cpu().numpy()]

    def permutation(self, cap: int) -> torch.Tensor:
        """The next epoch's permutation of the ``cap`` flat cells."""
        return torch.randperm(cap, generator=self.gen, device=self.gen.device)


def fit_minibatches_until_validation(
    state: PMFState,
    problem: Problem,
    cfg: PMFConfig,
    noise,
    batch_size: int,
    valid_size: int,
    lr: float = 1.0,
    momentum: float = 0.8,
    stop_thresh: float = 1e-3,
    max_epochs: int = 500,
    graph: bool = True,
) -> PMFState:
    """Momentum SGD over shuffled rating minibatches with validation-based
    early stopping (reference: pmf.py:226-284, fit type 'mini-valid').

    As in the JAX package: each epoch walks one permutation of all n m
    cells, padded with its own start to whole batches; cells outside the
    training set are masked out of a batch, and every batch steps (one
    with no training cell takes the prior's step alone: its count clamps
    to 1). The validation subset of the rated cells is drawn once on the
    host; the fit stops after the first epoch whose validation RMSE
    improves by less than ``stop_thresh``. ``noise``: a ``torch.Generator``
    or a ``MiniBatchNoise``.

    An epoch is ceil(n m / batch_size) steps of about 20 launches each, with
    no host wait. On the card the epoch's steps are captured once in one
    CUDA graph (static shapes) and the graph is replayed every epoch;
    ``graph=False``, or the CPU, runs them eagerly. Each epoch is a span,
    ``pmf.minibatch_epoch``, from its permutation to its validation
    error, which waits for the card; a graphed fit's first epoch holds the
    capture.
    """
    if isinstance(noise, torch.Generator):
        noise = MiniBatchNoise(noise)
    n, m = problem.shape
    cap = n * m
    device, dtype = state.U.device, state.U.dtype
    rated_flat = problem.rated.flatten()
    rated_idx = np.nonzero(rated_flat.cpu().numpy())[0]
    valid_idx = torch.as_tensor(
        noise.valid_subset(rated_idx, min(valid_size, rated_idx.size)),
        device=device)
    valid_i, valid_j = valid_idx // m, valid_idx % m
    r_flat = problem.R_obs.flatten().to(dtype)
    valid_r = r_flat[valid_idx]
    train = rated_flat.clone()
    train[valid_idx] = False

    n_batches = (cap + batch_size - 1) // batch_size
    pad = n_batches * batch_size - cap
    U, V = state.U.clone(), state.V.clone()
    u_inc, v_inc = torch.zeros_like(U), torch.zeros_like(V)
    perm = torch.empty(cap + pad, dtype=torch.int64, device=device)

    def epoch():
        for b in range(n_batches):
            sel = perm[b * batch_size:(b + 1) * batch_size]
            valid = train[sel]
            cnt = torch.clamp(valid.sum().to(dtype), min=1)
            ii, jj = sel // m, sel % m
            u_rows, v_rows = U[ii], V[jj]
            pred = (u_rows * v_rows).sum(1)
            if cfg.subtract_mean:
                pred = pred + state.mean_rating
            resid = torch.where(valid, (r_flat[sel] - pred) / state.sigma_sq,
                                0.0)
            gu = torch.zeros_like(U).index_add_(0, ii, resid[:, None] * v_rows)
            gv = torch.zeros_like(V).index_add_(0, jj, resid[:, None] * u_rows)
            gu = gu - U / state.sigma_u_sq
            gv = gv - V / state.sigma_v_sq
            step = lr / cnt
            u_inc.copy_(u_inc * momentum + gu * step)
            v_inc.copy_(v_inc * momentum + gv * step)
            U.add_(u_inc)
            V.add_(v_inc)

    run = epoch
    if graph and device.type == "cuda":
        run = _graphed(epoch, (U, V, u_inc, v_inc))

    last_valid = torch.inf
    for _ in range(max_epochs):
        with span("pmf.minibatch_epoch"):
            p = noise.permutation(cap).to(device)
            perm.copy_(torch.cat([p, p[:pad]]) if pad else p)
            run()
            pred_valid = (U[valid_i] * V[valid_j]).sum(1)
            if cfg.subtract_mean:
                pred_valid = pred_valid + state.mean_rating
            valid_err = float(
                torch.sqrt(torch.mean((pred_valid - valid_r) ** 2)))
        if valid_err > last_valid - stop_thresh:
            break
        last_valid = valid_err
    return dataclasses.replace(state, U=U, V=V)


def _graphed(body, state):
    """``body`` (in place on ``state``'s tensors) as one CUDA graph, captured
    at the first call: warm-up runs would move the state, so it is saved
    before them and restored before the capture and before the first
    replay."""
    captured = {}

    def run():
        if not captured:
            saved = [t.clone() for t in state]
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                body()  # a warm-up run allocates outside the graph
            torch.cuda.current_stream().wait_stream(side)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                body()
            for t, s in zip(state, saved):
                t.copy_(s)
            captured["graph"] = g
        captured["graph"].replay()

    return run


def do_fit(
    state: PMFState, problem: Problem, cfg: PMFConfig,
    fit_type: tuple = ("batch",),
    generator=None,
) -> PMFState:
    """Dispatch on fit type (reference: pmf.py:217-224): 'batch', 'lbfgs'
    (its argument: max_iters) and 'mini-valid' (batch_size, valid_size,
    then lr, momentum, stop_thresh, max_epochs), which draws from
    ``generator`` (a ``torch.Generator`` or a ``MiniBatchNoise``; None:
    a generator seeded 0 on the state's device)."""
    kind, *args = fit_type
    if kind == "batch":
        return fit(state, problem, cfg)[0]
    if kind == "lbfgs":
        return fit_lbfgs(state, problem, cfg, *args)
    if kind == "mini-valid":
        if generator is None:
            generator = torch.Generator(device=state.U.device)
            generator.manual_seed(0)
        return fit_minibatches_until_validation(state, problem, cfg,
                                                generator, *args)
    raise ValueError(f"unknown fit type {kind!r}")


def rmse(state: PMFState, problem: Problem, cfg: PMFConfig, real, on=None):
    from amf_tpu_torch.analysis import metrics

    pred = predicted_matrix(state, cfg)
    if on is None:
        return metrics.rmse(pred, real)
    return metrics.rmse_on(pred, real, on)
