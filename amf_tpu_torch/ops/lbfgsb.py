"""Box-constrained projected L-BFGS over a lane axis
(mirrors ``amf_tpu/ops/lbfgsb.py``).

The JAX package runs one solve as a ``lax.while_loop`` and batches solves
(the lookahead's warm-started refits) with ``vmap``, which runs every lane
in lockstep and freezes the lanes that have stopped. Here that batching is
written out: x is (L, dim), every lane keeps its own history, curvature
scale, iteration count and Armijo search, and a lane that has converged
(or whose search failed) keeps its state, bit for bit, while the others go
on. Lane l gives what the JAX function gives for that lane alone.

The algorithm is the JAX package's: the two-loop recursion over a circular
history, a steepest-descent fallback where the direction is not one of
descent, an Armijo backtracking search along the projected arc, a retry
along the projected gradient from a curvature-scaled step where that search
failed, and a history update only on positive curvature. Two savings keep
the results: the retry runs only on the lanes whose first search failed
(JAX runs it on every iteration and keeps it only there), and a search
trial evaluates the value alone (JAX computes and drops a gradient).

The host reads whether any lane still runs once every ``SYNC_ITERS``
iterations and whether any lane still searches once a trial; ``Counters``
sums what the lockstep costs.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

# iterations between two host reads of "does any lane still run"
SYNC_ITERS = 4


class Counters:
    """What the lockstep costs, summed over calls until ``reset``:
    iterations run on all lanes at once, the lanes' own iterations (kept
    on the device until read), search trials (value-only evaluations of
    all lanes) and host reads."""

    iterations = 0
    trials = 0
    syncs = 0
    _lane_iterations = 0

    @classmethod
    def reset(cls):
        cls.iterations = cls.trials = cls.syncs = 0
        cls._lane_iterations = 0

    @classmethod
    def read(cls) -> Dict[str, int]:
        return dict(iterations=cls.iterations, trials=cls.trials,
                    syncs=cls.syncs,
                    lane_iterations=int(cls._lane_iterations))


def _any(mask: torch.Tensor) -> bool:
    Counters.syncs += 1
    return bool(mask.any())


class LBFGSBResult(NamedTuple):
    x: torch.Tensor  # (L, dim)
    f: torch.Tensor  # (L,)
    pg_norm: torch.Tensor  # (L,) projected-gradient sup-norm at exit
    n_iters: torch.Tensor  # (L,) int64


def _autograd(fun: Callable) -> Callable:
    """x -> (f, grad) of a value-only ``fun`` by one backward pass of the
    lanes' summed values (lanes are independent)."""

    def value_and_grad(x):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            f = fun(xg)
            (g,) = torch.autograd.grad(f.sum(), xg)
        return f.detach(), g

    return value_and_grad


def _bound(b, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(b, dtype=x.dtype, device=x.device).expand(x.shape)


def lbfgsb(
    fun: Callable,  # x (L, dim) -> (f (L,), grad (L, dim)), or f alone
    x0: torch.Tensor,
    lower,
    upper,
    max_iters: int = 500,
    history: int = 10,
    pgtol: float = 1e-6,
    armijo_c1: float = 1e-4,
    max_linesearch: int = 30,
    value_and_grad: bool = True,
    value_fn: Optional[Callable] = None,
) -> LBFGSBResult:
    """Minimize ``fun`` over the box [lower, upper], every lane of x0
    (L, dim) on its own. ``lower`` / ``upper``: numbers, (dim,) or
    (L, dim). ``value_fn`` x -> f (L,) serves the search trials (default:
    ``fun``'s value); with ``value_and_grad=False`` ``fun`` gives the value
    and autograd the gradient."""
    if not value_and_grad:
        value_fn = value_fn or fun
        fun = _autograd(fun)
    if value_fn is None:
        def value_fn(x):
            return fun(x)[0]

    L, dim = x0.shape
    dtype, device = x0.dtype, x0.device
    lo, hi = _bound(lower, x0), _bound(upper, x0)
    lane = torch.arange(L, device=device)

    def proj(x):
        return torch.minimum(torch.maximum(x, lo), hi)

    def pg_norm(x, g):
        return torch.amax(torch.abs(proj(x - g) - x), dim=-1)

    def dot(a, b):
        return (a * b).sum(-1)

    x = proj(x0)
    f, g = fun(x)
    S = torch.zeros((L, history, dim), dtype=dtype, device=device)
    Y = torch.zeros_like(S)
    rho = torch.zeros((L, history), dtype=dtype, device=device)
    count = torch.zeros(L, dtype=torch.int64, device=device)
    gamma = torch.ones(L, dtype=dtype, device=device)
    n_iters = torch.zeros(L, dtype=torch.int64, device=device)
    done = torch.zeros(L, dtype=torch.bool, device=device)

    def two_loop(g):
        """The L-BFGS two-loop recursion, every lane on its own buffer."""
        valid_n = torch.clamp(count, max=history)
        q = g
        alphas = torch.zeros((L, history), dtype=dtype, device=device)
        for i in range(history):
            idx = (count - 1 - i) % history
            valid = i < valid_n
            s_i, y_i = S[lane, idx], Y[lane, idx]
            a = torch.where(valid, rho[lane, idx] * dot(s_i, q), 0.0)
            q = q - (a * valid)[:, None] * y_i
            alphas[lane, idx] = a
        r = gamma[:, None] * q
        for i in range(history):
            idx = (count - valid_n + i) % history
            valid = i < valid_n
            s_i, y_i = S[lane, idx], Y[lane, idx]
            b = torch.where(valid, rho[lane, idx] * dot(y_i, r), 0.0)
            r = r + ((alphas[lane, idx] - b) * valid)[:, None] * s_i
        return r

    def search(direction, init_step, active):
        """Armijo backtracking of the ``active`` lanes: (x at the last
        step, ok) per lane; the other lanes come back not ok."""
        step = init_step.clone()
        ok = torch.zeros(L, dtype=torch.bool, device=device)
        for _ in range(max_linesearch):
            trying = active & ~ok
            if not _any(trying):
                break
            Counters.trials += 1
            x_new = proj(x + step[:, None] * direction)
            f_new = value_fn(x_new)
            suff = f_new <= f + armijo_c1 * dot(g, x_new - x)
            ok = ok | (trying & suff & torch.isfinite(f_new) & (f_new < f))
            step = torch.where(trying & ~ok, step * 0.5, step)
        return proj(x + step[:, None] * direction), ok

    for it in range(max_iters):
        running = ~done
        if it % SYNC_ITERS == 0 and not _any(running):
            break
        Counters.iterations += 1
        d = -two_loop(g)
        d = torch.where((dot(d, g) < 0)[:, None], d, -g)
        x_try, ok = search(d, torch.ones(L, dtype=dtype, device=device),
                           running)
        # quasi-Newton direction failed: retry along the projected gradient
        # with a curvature-scaled initial step, on those lanes alone
        x_sd, ok_sd = search(-g, gamma, running & ~ok)
        use = ok | ok_sd
        x_new = torch.where(ok[:, None], x_try,
                            torch.where(ok_sd[:, None], x_sd, x))
        f_new, g_new = fun(x_new)
        f_new = torch.where(use, f_new, f)
        g_new = torch.where(use[:, None], g_new, g)

        s = x_new - x
        yv = g_new - g
        sy = dot(s, yv)
        accept = running & use & (sy > 1e-10)
        idx = count % history
        acc = accept[:, None]
        S[lane, idx] = torch.where(acc, s, S[lane, idx])
        Y[lane, idx] = torch.where(acc, yv, Y[lane, idx])
        rho[lane, idx] = torch.where(accept, 1.0 / sy, rho[lane, idx])
        count = count + accept.to(torch.int64)
        gamma = torch.where(accept, sy / dot(yv, yv), gamma)

        col = running[:, None]
        x = torch.where(col, x_new, x)
        f = torch.where(running, f_new, f)
        g = torch.where(col, g_new, g)
        n_iters = n_iters + running.to(torch.int64)
        done = done | (running & ((pg_norm(x_new, g_new) < pgtol) | ~use))
    Counters._lane_iterations = Counters._lane_iterations + n_iters.sum()
    return LBFGSBResult(x, f, pg_norm(x, g), n_iters)
