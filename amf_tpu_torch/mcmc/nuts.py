"""No-U-Turn Sampler on a lane axis (mirrors ``amf_tpu/mcmc/nuts.py``).

The JAX package runs one chain as a ``lax.while_loop`` program and batches
chains (and lookahead lanes) with ``vmap``, which runs every lane in
lockstep and masks the lanes that have stopped. Here that batching is
written out: every state carries a leading lane axis, positions are
(L, dim), and each leapfrog evaluates the potential of all L lanes at once.
A lane that has stopped (its tree turned or diverged, or its subtree did)
keeps its ends, candidate, weights and momentum sum untouched while the
others go on.

Algorithm (as in the JAX package): multinomial NUTS (Betancourt 2017) with
iterative trajectory doubling; iterative subtrees with a binary-counter
merge stack for the generalized U-turn checks; streaming multinomial
candidate selection; a divergence threshold on the energy error; warmup by
an ESJD grid over five step-size multipliers around a reasonable-eps
anchor, with Stan's windowed diagonal mass estimation and a
degenerate-variance gate.

Lockstep without host waits. The merges after leaf i of a subtree are the
trailing zeros of i + 1, the same for every lane, so the merge stack is
indexed on the host and needs no sync. The host reads whether any lane
still runs once per doubling and every ``SYNC_LEAVES`` leaves of a subtree.

Randomness. Every draw of a run comes from one noise source (``NUTSNoise``)
by what it is for: per transition the momentum, the direction bits and
merge uniforms of each depth, the uniforms of every leaf of every depth's
subtree (depth j's 2**j leaves at [2**j - 1, 2**(j+1) - 1)), and the
jitter; per step-size search its momentum. A stopped lane's draws are
simply not read, so a lane's trajectory is a function of its own draws
alone, whatever the other lanes do. ``GeneratorNoise`` draws them a window
of transitions at a time from one ``torch.Generator`` per lane; the tests
replay the JAX package's key stream through the same interface.

The potential's gradient is ``torch.autograd.grad`` of the lanes' summed
log density: lanes are independent, so one backward pass gives every
lane's gradient; on the card it is one CUDA graph a call (``potential``).
The potential and the RNG windows are spans (``nuts.potential``,
``nuts.rng``; ``utils/profiling``), so a profiler's trace splits a
transition into them and the bookkeeping around them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from amf_tpu_torch.utils.profiling import span

# Provenance tag of the warmup controller that generated a recorded run;
# the same string as the JAX package's, whose controller this is. Stamped
# into checkpoints so a trace is never resumed across sampler eras.
SAMPLER_ERA = "esjd-leapfrog-v1"

# leaves of a subtree between two host reads of "does any lane still run"
SYNC_LEAVES = 8

# step-size multipliers of the warmup's ESJD grid
_MULTS = (0.25, 0.5, 1.0, 2.0, 4.0)


class NUTSConfig(NamedTuple):
    max_depth: int = 10
    max_delta_energy: float = 1000.0


class StepNoise(NamedTuple):
    """The draws of one transition, for L lanes."""

    momentum: torch.Tensor  # (L, dim) standard normals
    go_right: torch.Tensor  # (L, max_depth) bool, one direction a depth
    u_merge: torch.Tensor  # (L, max_depth) uniforms of the subtree merges
    u_leaf: torch.Tensor  # (L, 2**max_depth - 1) leaf-selection uniforms
    u_jitter: torch.Tensor  # (L,) uniform of the sampling step's jitter


class NUTSNoise:
    """Interface of a run's noise source (see the module docstring)."""

    def step(self, t: int) -> StepNoise:
        """Draws of transition t of the run (warmup first, then draws)."""
        raise NotImplementedError

    def search(self, t: Optional[int]) -> torch.Tensor:
        """(L, dim) momentum normals of a step-size search: the one before
        the run (t None) or the one after warm step t."""
        raise NotImplementedError


class GeneratorNoise(NUTSNoise):
    """Draws from one ``torch.Generator`` per lane, ``window`` transitions
    at a time: two calls a lane a window (normals, uniforms), so the RNG's
    launches stay out of the leapfrog loop. Lane l's draws depend on its
    generator alone (``utils/rng.lane_generators`` keys them by global
    candidate index, so scores do not depend on the tiling)."""

    def __init__(self, generators: Sequence[torch.Generator], dim: int,
                 max_depth: int, dtype, device, window: int = 16):
        self.gens = list(generators)
        self.dim, self.depth = dim, max_depth
        self.dtype, self.device = dtype, torch.device(device)
        self.window = max(int(window), 1)
        self._t0 = None  # first transition of the drawn window
        self._buf = None

    def _draw(self, t0: int):
        W, d, dim = self.window, self.depth, self.dim
        n_u = 2 * d + 2 ** d - 1 + 1
        L = len(self.gens)
        z = torch.empty((L, W, dim), dtype=self.dtype, device=self.device)
        u = torch.empty((L, W, n_u), dtype=self.dtype, device=self.device)
        with span("nuts.rng"):
            for row_z, row_u, gen in zip(z, u, self.gens):
                row_z.normal_(generator=gen)
                row_u.uniform_(generator=gen)
        self._t0, self._buf = t0, (z, u)

    def step(self, t: int) -> StepNoise:
        if self._buf is None or not (self._t0 <= t < self._t0 + self.window):
            self._draw(t)
        z, u = self._buf
        k, d = t - self._t0, self.depth
        uk = u[:, k]
        return StepNoise(momentum=z[:, k], go_right=uk[:, :d] < 0.5,
                         u_merge=uk[:, d:2 * d], u_leaf=uk[:, 2 * d:-1],
                         u_jitter=uk[:, -1])

    def search(self, t: Optional[int]) -> torch.Tensor:
        out = torch.empty((len(self.gens), self.dim), dtype=self.dtype,
                          device=self.device)
        for row, gen in zip(out, self.gens):
            row.normal_(generator=gen)
        return out


class Counters:
    """What the lockstep costs, summed over calls until ``reset``:
    transitions, leapfrogs evaluated on all lanes at once, lane
    transitions and the leaves those lanes needed (their ``num_leaves``;
    kept on the device until read), and host reads of "does any lane still
    run"."""

    transitions = 0
    lockstep_leapfrogs = 0
    lane_transitions = 0
    syncs = 0
    _lane_leaves = 0

    @classmethod
    def reset(cls):
        cls.transitions = cls.lockstep_leapfrogs = cls.lane_transitions = 0
        cls.syncs = 0
        cls._lane_leaves = 0

    @classmethod
    def read(cls) -> Dict[str, int]:
        return dict(transitions=cls.transitions,
                    lockstep_leapfrogs=cls.lockstep_leapfrogs,
                    lane_transitions=cls.lane_transitions,
                    lane_leaves=int(cls._lane_leaves), syncs=cls.syncs)


def _any(mask: torch.Tensor) -> bool:
    Counters.syncs += 1
    return bool(mask.any())


class _End(NamedTuple):
    """One endpoint of every lane's trajectory: position, momentum,
    potential, gradient of the potential."""

    q: torch.Tensor  # (L, dim)
    p: torch.Tensor  # (L, dim)
    pe: torch.Tensor  # (L,)
    grad: torch.Tensor  # (L, dim)


def _where_end(mask: torch.Tensor, a: _End, b: _End) -> _End:
    """Lane-wise ``a`` where ``mask`` (L,), else ``b``."""
    col = mask[:, None]
    return _End(torch.where(col, a.q, b.q), torch.where(col, a.p, b.p),
                torch.where(mask, a.pe, b.pe),
                torch.where(col, a.grad, b.grad))


Potential = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def potential(logprob_fn: Callable[[torch.Tensor], torch.Tensor],
              graph: bool = True) -> Potential:
    """q (L, dim) -> (potential (L,), its gradient (L, dim)) of the log
    density ``logprob_fn`` (L, dim) -> (L,): one backward pass of the
    lanes' summed log density.

    On the card the forward and backward pass (a few hundred small
    launches) are captured once, at the first call, in a CUDA graph and
    replayed at every later call of that shape: the same kernels, one
    launch from the host. ``graph=False``, or a CPU tensor, runs them
    eagerly. ``logprob_fn`` must not wait for the host (no ``.item()``)."""

    def eager(q):
        with torch.enable_grad():
            x = q.detach().requires_grad_(True)
            lp = logprob_fn(x)
            (g,) = torch.autograd.grad(lp.sum(), x)
        return -lp.detach(), -g

    captured = {}

    def capture(q):
        static_q = q.detach().clone()
        side = torch.cuda.Stream(device=q.device)
        side.wait_stream(torch.cuda.current_stream(q.device))
        with torch.cuda.stream(side):
            for _ in range(2):  # warm-up runs allocate outside the graph
                eager(static_q)
        torch.cuda.current_stream(q.device).wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = eager(static_q)
        captured.update(graph=g, q=static_q, out=out, shape=q.shape)

    def pe_and_grad(q):
        with span("nuts.potential"):
            if not graph or q.device.type != "cuda":
                return eager(q)
            if captured.get("shape") != q.shape:
                capture(q)
            captured["q"].copy_(q)
            captured["graph"].replay()
            pe, g = captured["out"]
            return pe.clone(), g.clone()

    return pe_and_grad


def _leapfrog(end: _End, eps, inv_mass, pe_and_grad) -> _End:
    """One leapfrog step of every lane; eps (L,), inv_mass (L, dim)."""
    half = (0.5 * eps)[:, None]
    p_half = end.p - half * end.grad
    q_new = end.q + eps[:, None] * inv_mass * p_half
    pe_new, grad_new = pe_and_grad(q_new)
    p_new = p_half - half * grad_new
    return _End(q_new, p_new, pe_new, grad_new)


def _kinetic(p, inv_mass):
    return 0.5 * torch.sum(inv_mass * p * p, dim=-1)


def _is_turning(p_first, p_last, p_sum, inv_mass):
    """Generalized U-turn criterion with endpoint centering
    (Betancourt 2017 A.4.2; numpyro/Stan semantics), per lane."""
    v_first = inv_mass * p_first
    v_last = inv_mass * p_last
    rho = p_sum - (p_first + p_last) / 2
    return ((v_first * rho).sum(-1) <= 0) | ((v_last * rho).sum(-1) <= 0)


class _Subtree(NamedTuple):
    end: _End
    cand_q: torch.Tensor
    cand_pe: torch.Tensor
    logw: torch.Tensor
    p_sum: torch.Tensor
    turning: torch.Tensor
    diverging: torch.Tensor
    sum_acc: torch.Tensor
    n_leaves: torch.Tensor


def _build_subtree(u_leaf, start: _End, depth: int, eps, inv_mass, H0,
                   pe_and_grad, cfg: NUTSConfig, running) -> _Subtree:
    """A subtree of 2**depth leaves from ``start`` for every lane in
    ``running`` (L,); the other lanes' fields stay as they start.

    u_leaf (L, 2**depth): the leaves' selection uniforms. A lane stops at
    the leaf that turns or diverges (that leaf counts). The merge stack is
    shared by the lanes' structure: after leaf i it merges the trailing
    zeros of i + 1 blocks, each checked as is_turning(block's first p, the
    current p, block's p sum).
    """
    L, dim = start.q.shape
    dtype, device = start.q.dtype, start.q.device
    end = start
    cand_q, cand_pe = start.q, start.pe
    logw = torch.full((L,), -torch.inf, dtype=dtype, device=device)
    p_sum = torch.zeros_like(start.q)
    turning = torch.zeros(L, dtype=torch.bool, device=device)
    diverging = torch.zeros_like(turning)
    sum_acc = torch.zeros(L, dtype=dtype, device=device)
    n_done = torch.zeros(L, dtype=torch.int64, device=device)
    s_pfirst: List[torch.Tensor] = []
    s_psum: List[torch.Tensor] = []

    for i in range(2 ** depth):
        alive = running & ~turning & ~diverging
        if i and i % SYNC_LEAVES == 0 and not _any(alive):
            break
        Counters.lockstep_leapfrogs += 1
        new = _leapfrog(end, eps, inv_mass, pe_and_grad)
        end = _where_end(alive, new, end)
        H = end.pe + _kinetic(end.p, inv_mass)
        delta = H - H0
        finite = torch.isfinite(delta)
        diverging = diverging | (alive & ((delta > cfg.max_delta_energy)
                                          | ~finite))
        logw_leaf = torch.where(finite, -delta, -torch.inf)
        # non-finite energy counts as accept-prob 0 (Stan semantics)
        sum_acc = sum_acc + torch.where(
            alive & finite, torch.clamp(torch.exp(-delta), max=1.0), 0.0)

        # streaming multinomial candidate selection
        new_logw = torch.logaddexp(logw, logw_leaf)
        take = alive & (torch.log(u_leaf[:, i]) < (logw_leaf - new_logw))
        cand_q = torch.where(take[:, None], end.q, cand_q)
        cand_pe = torch.where(take, end.pe, cand_pe)
        logw = torch.where(alive, new_logw, logw)
        p_sum = torch.where(alive[:, None], p_sum + end.p, p_sum)
        n_done = n_done + alive

        # push the leaf, then the binary-counter merges
        s_pfirst.append(end.p)
        s_psum.append(end.p)
        k = i + 1
        while k % 2 == 0:
            merged = s_psum[-2] + s_psum[-1]
            turning = turning | (alive & _is_turning(
                s_pfirst[-2], end.p, merged, inv_mass))
            s_psum[-2] = merged
            s_psum.pop()
            s_pfirst.pop()
            k //= 2
    return _Subtree(end, cand_q, cand_pe, logw, p_sum, turning, diverging,
                    sum_acc, n_done)


class NUTSInfo(NamedTuple):
    accept_prob: torch.Tensor  # (L,)
    num_leaves: torch.Tensor  # (L,) int64
    diverging: torch.Tensor  # (L,) bool
    logprob: torch.Tensor  # (L,)


def nuts_kernel(
    q: torch.Tensor,
    pe_and_grad: Potential,
    eps: torch.Tensor,
    inv_mass: torch.Tensor,
    noise: StepNoise,
    cfg: NUTSConfig = NUTSConfig(),
) -> Tuple[torch.Tensor, NUTSInfo]:
    """One NUTS transition of every lane from q (L, dim); eps (L,),
    inv_mass (L, dim), the transition's draws ``noise``."""
    L = q.shape[0]
    dtype, device = q.dtype, q.device
    neg_lp, grad = pe_and_grad(q)
    p0 = noise.momentum / torch.sqrt(inv_mass)
    H0 = neg_lp + _kinetic(p0, inv_mass)
    left = right = _End(q, p0, neg_lp, grad)
    cand_q, cand_pe = q, neg_lp
    logw = torch.zeros(L, dtype=dtype, device=device)  # initial point: -0
    p_sum = p0
    running = torch.ones(L, dtype=torch.bool, device=device)
    diverging = torch.zeros_like(running)
    sum_acc = torch.zeros(L, dtype=dtype, device=device)
    n_leaves = torch.zeros(L, dtype=torch.int64, device=device)

    for depth in range(cfg.max_depth):
        if depth and not _any(running):
            break
        go_right = noise.go_right[:, depth]
        start = _where_end(go_right, right, left)
        step = torch.where(go_right, eps, -eps)
        lo = 2 ** depth - 1
        sub = _build_subtree(noise.u_leaf[:, lo:lo + 2 ** depth], start,
                             depth, step, inv_mass, H0, pe_and_grad, cfg,
                             running)
        sum_acc = sum_acc + torch.where(running, sub.sum_acc, 0.0)
        n_leaves = n_leaves + torch.where(running, sub.n_leaves, 0)

        ok = running & ~sub.turning & ~sub.diverging
        # biased progressive sampling (favor the new subtree, Stan-style)
        accept_new = ok & (torch.log(noise.u_merge[:, depth])
                           < (sub.logw - logw))
        cand_q = torch.where(accept_new[:, None], sub.cand_q, cand_q)
        cand_pe = torch.where(accept_new, sub.cand_pe, cand_pe)
        logw = torch.where(ok, torch.logaddexp(logw, sub.logw), logw)
        right = _where_end(ok & go_right, sub.end, right)
        left = _where_end(ok & ~go_right, sub.end, left)
        p_sum = torch.where(ok[:, None], p_sum + sub.p_sum, p_sum)
        whole_turn = _is_turning(left.p, right.p, p_sum, inv_mass)
        turning = sub.turning | (ok & whole_turn)
        diverging = diverging | (running & sub.diverging)
        running = running & ~turning & ~diverging

    Counters.transitions += 1
    Counters.lane_transitions += L
    Counters._lane_leaves = Counters._lane_leaves + n_leaves.sum()
    accept = sum_acc / torch.clamp(n_leaves, min=1)
    return cand_q, NUTSInfo(accept, n_leaves, diverging, -cand_pe)


def find_reasonable_step_size(
    momentum: torch.Tensor, q: torch.Tensor, pe_and_grad: Potential,
    inv_mass: torch.Tensor, init_eps, lanes: Optional[torch.Tensor] = None,
    max_tries: int = 50,
) -> torch.Tensor:
    """Stan's heuristic, per lane: double or halve eps until the one-step
    accept probability crosses 0.5. momentum (L, dim) standard normals;
    init_eps a number or (L,); ``lanes`` (L,) bool restricts the search
    (the other lanes keep init_eps). One host read an iteration."""
    L = q.shape[0]
    dtype, device = q.dtype, q.device
    neg_lp, grad = pe_and_grad(q)
    p0 = momentum / torch.sqrt(inv_mass)
    H0 = neg_lp + _kinetic(p0, inv_mass)
    start = _End(q, p0, neg_lp, grad)
    eps = torch.as_tensor(init_eps, dtype=dtype, device=device).expand(L)
    eps = eps.clone()

    def accept_at(e):
        Counters.lockstep_leapfrogs += 1
        end = _leapfrog(start, e, inv_mass, pe_and_grad)
        H = end.pe + _kinetic(end.p, inv_mass)
        return torch.exp(H0 - H)

    a = accept_at(eps)
    up = a > 0.5
    tries = torch.zeros(L, dtype=torch.int64, device=device)
    active = torch.ones(L, dtype=torch.bool, device=device) if lanes is None \
        else lanes.clone()
    factor = torch.where(up, 2.0, 0.5).to(dtype)
    while True:
        a = torch.where(torch.isfinite(a), a, 0.0)
        keep = torch.where(up, a > 0.5, a < 0.5) & (tries < max_tries)
        active = active & keep
        if not _any(active):
            return eps
        eps = torch.where(active, eps * factor, eps)
        tries = tries + active
        a = accept_at(eps)


def _warmup_schedule(warmup: int, adapt_mass: bool):
    """Stan's three-phase warmup schedule (stan::mcmc::windowed_adaptation):
    an eps-only initial buffer, expanding mass-estimation windows (base 25,
    doubling, the last absorbs the remainder), and an eps-only terminal
    buffer. Returns host flags (is_accum, is_switch, is_refine) per
    iteration; a switch applies the window's Welford variance as the new
    diagonal inverse mass, resets the accumulator and re-runs the
    reasonable-step-size search under the new metric."""
    w = max(warmup, 1)
    is_accum = np.zeros(w, bool)
    is_switch = np.zeros(w, bool)
    is_refine = np.zeros(w, bool)
    if warmup >= 5:
        is_refine[w - 1] = True  # terminal eps refinement
    if not adapt_mass or warmup < 20:
        return is_accum, is_switch, is_refine
    init_buf, term_buf, base = 75, 50, 25
    if warmup < init_buf + term_buf + base:
        init_buf = int(0.15 * warmup)
        term_buf = int(0.10 * warmup)
        base = warmup - init_buf - term_buf
    ends = []
    start, size = init_buf, base
    while True:
        end = start + size
        # absorb the remainder if the NEXT window wouldn't fit
        if end + 2 * size > warmup - term_buf:
            end = warmup - term_buf
            ends.append(end)
            break
        ends.append(end)
        start, size = end, 2 * size
    is_accum[init_buf:ends[-1]] = True
    for e in ends:
        is_switch[e - 1] = True  # applied after that iteration's draw
        is_refine[e - 1] = True
    return is_accum, is_switch, is_refine


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis, the mean of the middle two for an even
    count (``jnp.median``)."""
    s = torch.sort(x, dim=-1).values
    k = s.shape[-1]
    if k % 2:
        return s[..., k // 2]
    return (s[..., k // 2 - 1] + s[..., k // 2]) / 2


def run_nuts(
    noise: NUTSNoise,
    q0: torch.Tensor,
    logprob_fn: Callable[[torch.Tensor], torch.Tensor],
    num_samples: int,
    warmup: int,
    cfg: NUTSConfig = NUTSConfig(),
    adapt_mass: bool = True,
    init_eps: float = 1.0,
    return_adaptation: bool = False,
    eps_anchor=None,
    init_inv_mass: Optional[torch.Tensor] = None,
):
    """Warmup (step size and diagonal mass) then sampling, for L lanes.

    q0 (L, dim); ``logprob_fn`` (L, dim) -> (L,). Returns samples
    (L, num_samples, dim) and a ``NUTSInfo`` of (L, num_samples) fields,
    and with ``return_adaptation`` the final {"eps" (L,), "inv_mass"
    (L, dim)}.

    Warmup follows Stan's windowed schedule (``_warmup_schedule``); the
    step size is adapted for mixing: warm iterations round-robin over the
    multipliers 0.25..4 of an anchor, accumulate each arm's squared jump
    per leapfrog, and each window end re-centres the anchor on the best
    arm, re-running the reasonable-eps search on the lanes whose metric
    changed. Sampling jitters the final anchor 0.7-1.3x per draw. See the
    JAX package for why (funnel posteriors freeze accept-targeting dual
    averaging).

    eps_anchor / init_inv_mass warm-start adaptation from a previously
    adapted chain (numbers, (L,) / (dim,) or (L, dim)); given an anchor,
    the initial search is skipped, and given a mass, warmup refines eps
    only.
    """
    L, dim = q0.shape
    dtype, device = q0.dtype, q0.device
    pe_and_grad = potential(logprob_fn)
    if init_inv_mass is None:
        inv_mass = torch.ones((L, dim), dtype=dtype, device=device)
    else:
        inv_mass = init_inv_mass.to(dtype).expand(L, dim).clone()
    # a warm start trusts the carried metric: warm warmups refine eps only
    adapt_mass = adapt_mass and init_inv_mass is None

    if eps_anchor is None:
        anchor = find_reasonable_step_size(noise.search(None), q0,
                                           pe_and_grad, inv_mass, init_eps)
    else:
        anchor = torch.as_tensor(eps_anchor, dtype=dtype,
                                 device=device).expand(L).clone()

    is_accum, is_switch, is_refine = _warmup_schedule(warmup, adapt_mass)
    mults = torch.as_tensor(_MULTS, dtype=dtype, device=device)
    n_arms = len(_MULTS)
    q = q0
    esjd = torch.zeros((L, n_arms), dtype=dtype, device=device)
    arm_n = torch.zeros_like(esjd)
    w_n = 0.0
    w_mean = torch.zeros((L, dim), dtype=dtype, device=device)
    w_m2 = torch.zeros_like(w_mean)
    for t in range(warmup):
        accum, switch, refine = (bool(is_accum[t]), bool(is_switch[t]),
                                 bool(is_refine[t]))
        arm = t % n_arms
        q_new, info = nuts_kernel(q, pe_and_grad, anchor * mults[arm],
                                  inv_mass, noise.step(t), cfg)
        # normalized by cost (leapfrogs), not by transitions
        esjd[:, arm] += torch.sum((q_new - q) ** 2, dim=-1)
        arm_n[:, arm] += info.num_leaves.to(dtype)
        q = q_new

        if accum:  # Welford accumulation of position variance
            w_n += 1.0
            delta = q - w_mean
            w_mean = w_mean + delta / max(w_n, 1.0)
            w_m2 = w_m2 + delta * (q - w_mean)

        # the window's variance becomes the inverse mass, unless degenerate
        mass_changed = None
        if switch and w_n > 1:
            var = w_m2 / max(w_n - 1.0, 1.0)
            reg = (w_n / (w_n + 5.0)) * var + (5.0 / (w_n + 5.0)) * 1e-3
            mass_changed = _median(var) > 1e-3
            inv_mass = torch.where(mass_changed[:, None], reg, inv_mass)

        if refine or mass_changed is not None:
            # re-centre the anchor on the best jump-per-leapfrog arm
            best = torch.argmax(torch.where(
                arm_n > 0, esjd / torch.clamp(arm_n, min=1), -torch.inf),
                dim=-1)
            moved = torch.any(esjd > 0, dim=-1)
            refined = torch.where(moved, anchor * mults[best], anchor)
            new_anchor = refined if refine else anchor
            if mass_changed is not None and _any(mass_changed):
                # the metric changed: the eps scale is stale; re-run the
                # doubling search under it from the refined value
                found = find_reasonable_step_size(
                    noise.search(t), q, pe_and_grad, inv_mass, refined,
                    lanes=mass_changed)
                new_anchor = torch.where(mass_changed, found, new_anchor)
            anchor = new_anchor
        if refine:
            esjd.zero_()
            arm_n.zero_()
        if switch:
            w_n = 0.0
            w_mean = torch.zeros_like(w_mean)
            w_m2 = torch.zeros_like(w_m2)

    samples = torch.empty((L, num_samples, dim), dtype=dtype, device=device)
    fields = [torch.empty((L, num_samples), dtype=dt, device=device)
              for dt in (dtype, torch.int64, torch.bool, dtype)]
    for s in range(num_samples):
        sn = noise.step(warmup + s)
        eps = anchor * torch.clamp(sn.u_jitter * (1.3 - 0.7) + 0.7, min=0.7)
        q, info = nuts_kernel(q, pe_and_grad, eps, inv_mass, sn, cfg)
        samples[:, s] = q
        for out, x in zip(fields, info):
            out[:, s] = x
    infos = NUTSInfo(*fields)
    if return_adaptation:
        return samples, infos, {"eps": anchor, "inv_mass": inv_mass}
    return samples, infos
