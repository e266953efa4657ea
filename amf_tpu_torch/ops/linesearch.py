"""Adaptive-learning-rate descent with accept/reject line search, batched.

Mirrors ``amf_tpu/ops/linesearch.py``: the optimization pattern behind the
reference's ``fit_lls`` (python-pmf/pmf.py:179-211)::

    loop: propose x' = step(x, g, lr)
          if f(x') improves: accept; lr *= 1.25;
              converged if improvement < stop_thresh; recompute gradient
          else: lr *= 0.5; converged if lr < min_lr

The JAX package runs it as a ``lax.while_loop`` and batches it with
``vmap``. Here the value has any leading lane shape (``()`` for one fit,
``(L,)`` for a lookahead tile) and the loop is a Python loop over lanes in
lockstep. A lane that is done freezes: its carry no longer changes, which is
``vmap``-of-``while_loop`` semantics. The host reads ``done`` only every
``CHECK_EVERY`` iterations, so the loop does not wait on the device each
step; the extra iterations after the last lane is done change nothing.

Minimization convention: pass f = -log_likelihood to reproduce the
reference's ascent loops.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

CHECK_EVERY = 4


class DescentInfo(NamedTuple):
    final_value: torch.Tensor
    final_lr: torch.Tensor
    n_iters: torch.Tensor
    n_accepts: torch.Tensor
    # passes of the lockstep loop, a Python int: read without waiting for
    # the device
    loop_iters: int = 0


def _bcast(pred: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``pred`` (lane shape) reshaped to broadcast against ``like``."""
    return pred.reshape(pred.shape + (1,) * (like.dim() - pred.dim()))


def _select(pred, a, b):
    return tuple(torch.where(_bcast(pred, u), u, v) for u, v in zip(a, b))


def adaptive_descent(
    x0: Tuple[torch.Tensor, ...],
    value_and_grad_fn: Callable,
    step_fn: Callable,
    lr0: float,
    stop_thresh: float,
    min_lr: float,
    max_steps: int,
    grow: float = 1.25,
    shrink: float = 0.5,
) -> Tuple[tuple, DescentInfo]:
    """Minimize with the reference's adaptive-LR rule, one fused
    value+gradient evaluation per proposal.

    Args:
      x0: tuple of tensors whose leading dims are the lane shape.
      value_and_grad_fn: x -> (f, g), f of the lane shape, g like x (the
        descent direction).
      step_fn: (x, g, lr) -> proposed x; lr has the lane shape.
      lr0/stop_thresh/min_lr: the reference's learning_rate / stop_thresh /
        min_learning_rate knobs (pmf.py:28-30).
      max_steps: bound on proposals, accepted or not.

    Returns (x_final, DescentInfo) with per-lane info.
    """
    f, g = value_and_grad_fn(x0)
    x = tuple(x0)
    lr = torch.full_like(f, lr0)
    done = torch.zeros(f.shape, dtype=torch.bool, device=f.device)
    n_iters = torch.zeros(f.shape, dtype=torch.int32, device=f.device)
    n_accepts = torch.zeros_like(n_iters)
    passes = 0
    for it in range(max_steps):
        if it % CHECK_EVERY == 0 and bool(done.all()):
            break
        passes += 1
        active = ~done
        x_prop = step_fn(x, g, lr)
        new_f, new_g = value_and_grad_fn(x_prop)
        # NaN/inf proposals are rejections
        accept = active & torch.isfinite(new_f) & (new_f < f)
        conv = torch.where(accept, (f - new_f) < stop_thresh,
                           lr * shrink < min_lr)
        x = _select(accept, x_prop, x)
        g = _select(accept, new_g, g)
        lr = torch.where(active, torch.where(accept, lr * grow, lr * shrink), lr)
        f = torch.where(accept, new_f, f)
        done = done | (active & conv)
        n_iters += active
        n_accepts += accept
    return x, DescentInfo(f, lr, n_iters, n_accepts, passes)


def adaptive_descent_poly(
    x0: Tuple[torch.Tensor, ...],
    value_and_grad_fn: Callable,
    step_fn: Callable,
    delta_poly_fn: Callable,
    lr0: float,
    stop_thresh: float,
    min_lr: float,
    max_steps: int,
    grow: float = 1.25,
    shrink: float = 0.5,
    max_rungs: int = 64,
) -> Tuple[tuple, DescentInfo]:
    """Polynomial-in-alpha variant of ``adaptive_descent``.

    For bilinear models the objective along the ray ``x + alpha * g`` is an
    exact quartic, so each rejected proposal is decided by a scalar
    polynomial instead of a full value pass. One epoch is one fused
    value+gradient pass at the current point plus one ``delta_poly_fn``
    pass; the halving ladder lr, lr/2, lr/4, ... (``max_rungs`` rungs) is
    walked in closed form.

    ``delta_poly_fn(x, g) -> (c1, c2, c3, c4)`` with EXACTLY
    ``f(step_fn(x, g, a)) = f(x) - (c1 a + c2 a^2 + c3 a^3 + c4 a^4)``.
    Trajectory semantics match ``adaptive_descent``; ``n_iters`` counts
    proposals against ``max_steps``.
    """
    f_carry, g = value_and_grad_fn(x0)
    f = f_carry
    x = tuple(x0)
    dev = f.device
    lr = torch.full_like(f, lr0)
    done = torch.zeros(f.shape, dtype=torch.bool, device=dev)
    n_iters = torch.zeros(f.shape, dtype=torch.int32, device=dev)
    n_accepts = torch.zeros_like(n_iters)
    t = torch.arange(max_rungs, dtype=torch.int32, device=dev)
    ladder = shrink ** t.to(f.dtype)
    first = torch.ones(f.shape + (1,), dtype=torch.bool, device=dev)
    passes = 0
    for epoch in range(max_steps):
        active = ~done & (n_iters < max_steps)
        if epoch % CHECK_EVERY == 0 and not bool(active.any()):
            break
        passes += 1
        if epoch:
            f, g = value_and_grad_fn(x)
        c1, c2, c3, c4 = (c[..., None] for c in delta_poly_fn(x, g))

        alpha = lr[..., None] * ladder
        d = alpha * (c1 + alpha * (c2 + alpha * (c3 + alpha * c4)))
        acc = torch.isfinite(d) & (d > 0)
        # reject-convergence: after rejecting rung t the next lr would sink
        # below min_lr -> the lane stops without accepting
        stop_rej = ~acc & (alpha * shrink < min_lr)
        # rung t is examined iff every earlier rung was a plain reject and
        # the proposal budget allows
        plain = (~acc & ~stop_rej).to(torch.int32)
        prev_ok = torch.cat(
            [first, torch.cumprod(plain, dim=-1)[..., :-1].bool()], dim=-1)
        examined = prev_ok & ((n_iters[..., None] + t) < max_steps)
        hit = examined & acc
        any_hit = hit.any(dim=-1)
        t_star = torch.argmax(hit.to(torch.int32), dim=-1, keepdim=True)
        alpha_star = alpha.gather(-1, t_star)[..., 0]
        d_star = d.gather(-1, t_star)[..., 0]
        consumed = torch.where(any_hit, t_star[..., 0] + 1,
                               examined.sum(dim=-1)).to(torch.int32)

        take = active & any_hit
        x = _select(take, step_fn(x, g, alpha_star), x)
        f_carry = torch.where(
            active, torch.where(any_hit, f - d_star, f), f_carry)
        lr = torch.where(
            active,
            torch.where(any_hit, alpha_star * grow,
                        lr * shrink ** consumed.to(f.dtype)),
            lr)
        conv = torch.where(any_hit, d_star < stop_thresh, True)
        done = done | (active & conv)
        n_iters += torch.where(active, consumed, 0)
        n_accepts += take
    return x, DescentInfo(f_carry, lr, n_iters, n_accepts, passes)
