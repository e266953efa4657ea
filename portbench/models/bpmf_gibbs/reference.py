"""Plain PyTorch reference of what the ``bpmf_gibbs`` family's cells run.

Bayesian PMF by Gibbs sampling (Salakhutdinov and Mnih, ICML 2008) with
the active-learning steps of the reference code (python-pmf,
``bayes_pmf.py``): the MAP fit by adaptive-rate gradient ascent that
starts a chain, the Gaussian-Wishart hyperparameter draws, the row
draws, the streamed predictive statistics, the ``exp-variance`` one-step
lookahead (per candidate cell and value: add the rating, refit the MAP
with the exact quartic line search, run a fresh short chain, sum the
predictive variance over all cells, weight by the base chain's smoothed
histogram of the cell), and the ``pred-variance`` step (pick the queryable
cell of largest predictive variance, add its rating, refit the MAP warm,
draw a fresh chain, record the test error).

Every matrix is dense and every row is drawn with
``torch.linalg.cholesky_ex`` and triangular solves: no kernel, no packing,
no lane tricks. It runs in ``dtype`` (float64 for the check; float32 with
TF32 matmuls is the control). Its noise is drawn as the port draws it:
float32 normals and Gamma variates from one ``torch.Generator`` a stream,
seeded by ``portbench.seeds``, in the port's order, then cast to ``dtype``.
It imports nothing of the port.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench.seeds import fold_in, fold_in_name, lane_seeds

# the reference's constants (python-pmf pmf.py:26-41, bayes_pmf.py:73-109)
SIGMA_SQ, SIGMA_U_SQ, SIGMA_V_SQ = 1.0, 10.0, 10.0
LR0, MIN_LR, STOP_THRESH = 1e-4, 1e-10, 1e-2
BETA, B0, NUM_GIBBS = 2.0, 2.0, 2
GROW, SHRINK, RUNGS = 1.25, 0.5, 64


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 matmuls on or off inside the block; the settings come back."""
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    return g


@dataclasses.dataclass
class Data:
    """One problem on the device in the reference's dtype: the ratings the
    learner knows (``known``, ``R`` zero elsewhere), the true matrix and
    the test cells."""

    R: torch.Tensor  # (n, m) known ratings, 0 elsewhere
    known: torch.Tensor  # (n, m) bool
    real: torch.Tensor  # (n, m) every cell's true value
    test: torch.Tensor  # (n, m) bool
    queryable: torch.Tensor  # (n, m) bool

    @classmethod
    def build(cls, real, known, test, queryable, dtype, device) -> "Data":
        def t(x, dt):
            return torch.as_tensor(np.asarray(x), device=device).to(dt)

        known_t = t(known, torch.bool)
        real_t = t(real, dtype)
        return cls(R=torch.where(known_t, real_t, 0.0), known=known_t,
                   real=real_t, test=t(test, torch.bool),
                   queryable=t(queryable, torch.bool))

    def add(self, i: int, j: int) -> "Data":
        known, R, q = self.known.clone(), self.R.clone(), self.queryable.clone()
        known[i, j], R[i, j], q[i, j] = True, self.real[i, j], False
        return dataclasses.replace(self, known=known, R=R, queryable=q)

    def mean_rating(self) -> torch.Tensor:
        return self.R.sum() / self.known.sum().clamp(min=1)


@dataclasses.dataclass
class Cells:
    """Each lane's hypothesised rating: value ``v`` at cell (i, j)."""

    i: torch.Tensor
    j: torch.Tensor
    v: torch.Tensor


def lane_mean(data: Data, cells: Cells) -> torch.Tensor:
    """Each lane's mean known rating with its cell added."""
    was = data.known[cells.i, cells.j]
    total = data.R.sum() + cells.v - data.R[cells.i, cells.j]
    return total / (data.known.sum() + (~was).to(cells.v.dtype))


# ---------------------------------------------------------------------------
# MAP fit


def _residual(data: Data, U, V, mean, cells: Optional[Cells]):
    """(L, n, m) known rating minus prediction on each lane's known cells
    and its own cell, 0 elsewhere."""
    pred = U @ V.mT + mean[:, None, None]
    E = torch.where(data.known, data.R - pred, 0.0)
    if cells is not None:
        lane = torch.arange(len(cells.i), device=U.device)
        E[lane, cells.i, cells.j] = cells.v - pred[lane, cells.i, cells.j]
    return E


def _lane_mask(data: Data, cells: Optional[Cells], L: int):
    mask = data.known.expand(L, *data.known.shape)
    if cells is not None:
        mask = mask.clone()
        mask[torch.arange(L, device=mask.device), cells.i, cells.j] = True
    return mask


def neg_log_post(data, U, V, mean, cells=None):
    """(L,) negative log posterior and its descent direction (the ascent
    gradient of the log posterior)."""
    E = _residual(data, U, V, mean, cells)
    f = ((E * E).sum((-2, -1)) / (2 * SIGMA_SQ)
         + (U * U).sum((-2, -1)) / (2 * SIGMA_U_SQ)
         + (V * V).sum((-2, -1)) / (2 * SIGMA_V_SQ))
    E = E / SIGMA_SQ
    return f, (E @ V - U / SIGMA_U_SQ, E.mT @ U - V / SIGMA_V_SQ)


def fit_batch(data: Data, U, V, mean, max_steps: int = 2000,
              accepts: Optional[int] = None):
    """The reference's adaptive-rate ascent (pmf.py ``fit_lls``) of one
    problem, U (n, d): propose x + lr g; accept if the objective falls (lr
    x 1.25), else reject (lr / 2); stop when an accepted step gains less
    than the threshold or lr falls below its floor. With ``accepts``, stop
    after that many accepted steps as well."""
    U, V, mean = U[None], V[None], mean.reshape(1)
    f, g = neg_log_post(data, U, V, mean)
    lr = LR0
    taken = 0
    for _ in range(max_steps):
        if accepts is not None and taken >= accepts:
            break
        Up, Vp = U + lr * g[0], V + lr * g[1]
        f_new, g_new = neg_log_post(data, Up, Vp, mean)
        fv, fn = float(f), float(f_new)
        if np.isfinite(fn) and fn < fv:
            U, V, g, f = Up, Vp, g_new, f_new
            lr *= GROW
            taken += 1
            if fv - fn < STOP_THRESH:
                break
        else:
            lr *= SHRINK
            if lr < MIN_LR:
                break
    return U[0], V[0]


def objective(data: Data, U, V, mean) -> float:
    """The negative log posterior of one problem at (U, V)."""
    return float(neg_log_post(data, U[None], V[None], mean.reshape(1))[0])


def _improvement_quartic(data, U, V, mean, g, cells):
    """(c1, c2, c3, c4), each (L,): f(x) - f(x + a g) = c1 a + c2 a^2 +
    c3 a^3 + c4 a^4 along the descent direction g, exactly."""
    gu, gv = g
    mask = _lane_mask(data, cells, U.shape[0])
    E = _residual(data, U, V, mean, cells)
    P1 = torch.where(mask, gu @ V.mT + U @ gv.mT, 0.0)
    P2 = torch.where(mask, gu @ gv.mT, 0.0)

    def dot(a, b):
        return (a * b).sum((-2, -1))

    uu, vv = dot(gu, gu), dot(gv, gv)
    s = SIGMA_SQ
    # the residual falls by a P1 + a^2 P2, the priors grow along g; the
    # linear term of the priors and the residual is the squared gradient
    c1 = uu + vv
    c2 = (-(dot(P1, P1) - 2.0 * dot(E, P2)) / (2.0 * s)
          - 0.5 * (uu / SIGMA_U_SQ + vv / SIGMA_V_SQ))
    c3 = -dot(P1, P2) / s
    c4 = -dot(P2, P2) / (2.0 * s)
    return c1, c2, c3, c4


def fit_lanes_poly(data: Data, U, V, mean, cells: Cells, max_steps: int):
    """Every lane's MAP refit with the exact line search, lanes apart:
    each epoch walks the halving ladder lr, lr/2, ... in closed form on
    the quartic, takes the first rung that improves, grows lr by 1.25 on
    a hit; a lane stops when its step gains less than the threshold, its
    ladder sinks below the floor, or ``max_steps`` rungs were examined."""
    L = U.shape[0]
    dev, dt = U.device, U.dtype
    t = torch.arange(RUNGS, device=dev)
    ladder = SHRINK ** t.to(dt)
    lr = torch.full((L,), LR0, dtype=dt, device=dev)
    done = torch.zeros(L, dtype=torch.bool, device=dev)
    n_it = torch.zeros(L, dtype=torch.long, device=dev)
    for _ in range(max_steps):
        active = ~done & (n_it < max_steps)
        if not bool(active.any()):
            break
        _, g = neg_log_post(data, U, V, mean, cells)
        c1, c2, c3, c4 = (c[:, None] for c in
                          _improvement_quartic(data, U, V, mean, g, cells))
        alpha = lr[:, None] * ladder
        gain = alpha * (c1 + alpha * (c2 + alpha * (c3 + alpha * c4)))
        hit_ok = torch.isfinite(gain) & (gain > 0)
        sinks = ~hit_ok & (alpha * SHRINK < MIN_LR)
        plain_miss = (~hit_ok & ~sinks).long()
        reached = torch.cat([torch.ones((L, 1), dtype=torch.bool, device=dev),
                             torch.cumprod(plain_miss, 1)[:, :-1].bool()], 1)
        examined = reached & (n_it[:, None] + t < max_steps)
        hit = examined & hit_ok
        any_hit = hit.any(1)
        first = torch.argmax(hit.long(), 1, keepdim=True)
        a_star = alpha.gather(1, first)[:, 0]
        gain_star = gain.gather(1, first)[:, 0]
        used = torch.where(any_hit, first[:, 0] + 1, examined.sum(1))
        take = (active & any_hit)[:, None, None]
        U = torch.where(take, U + a_star[:, None, None] * g[0], U)
        V = torch.where(take, V + a_star[:, None, None] * g[1], V)
        lr = torch.where(active, torch.where(any_hit, a_star * GROW,
                                             lr * SHRINK ** used.to(dt)), lr)
        done = done | (active & torch.where(any_hit,
                                            gain_star < STOP_THRESH, True))
        n_it = n_it + torch.where(active, used, 0)
    return U, V


# ---------------------------------------------------------------------------
# Gibbs sampling


def init_factors(seed: int, n: int, m: int, d: int, device):
    """The MAP fit's start, U ~ U(0, 1) (n, d) then V (m, d), float32."""
    g = generator(seed, device)
    U = torch.rand((n, d), generator=g, dtype=torch.float32, device=device)
    V = torch.rand((m, d), generator=g, dtype=torch.float32, device=device)
    return U, V


def round_noise(gens: Sequence[torch.Generator], n: int, m: int, d: int,
                dtype, device) -> Dict[str, torch.Tensor]:
    """One Gibbs round's draws for each lane, in the port's order: one
    float32 normal call a lane (Wishart and mean normals of U, of V, then
    the row normals of every sweep of U, of V), then one Gamma call a lane
    (Bartlett shapes (d + N - k) / 2 of U, of V)."""
    g = NUM_GIBBS
    sizes = [d * d, d, d * d, d, g * n * d, g * m * d]
    L = len(gens)
    flat = torch.empty((L, sum(sizes)), dtype=torch.float32, device=device)
    for row, gen in zip(flat, gens):
        row.normal_(generator=gen)
    k = torch.arange(d, dtype=torch.float32, device=device)
    shape = torch.cat([(d + n - k) / 2.0, (d + m - k) / 2.0])
    gam = torch.stack([torch._standard_gamma(shape, generator=gen)
                       for gen in gens]).to(dtype)
    wu, mu_u, wv, mu_v, zu, zv = (x.to(dtype) for x in
                                  torch.split(flat, sizes, dim=1))
    return dict(
        gamma_u=gam[:, :d], w_u=wu.reshape(L, d, d), mu_u=mu_u,
        gamma_v=gam[:, d:], w_v=wv.reshape(L, d, d), mu_v=mu_v,
        z_u=zu.reshape(L, g, n, d).transpose(0, 1),
        z_v=zv.reshape(L, g, m, d).transpose(0, 1))


def _chol(A):
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info > 0)[..., None, None], torch.nan, L)


def _inv(A):
    X, info = torch.linalg.inv_ex(A)
    return torch.where((info > 0)[..., None, None], torch.nan, X)


def hyper_draw(F, gamma, w, z_mu):
    """Gaussian-Wishart posterior draw (mu, precision) given factors F
    (L, N, d): mu0 = 0, W0 = I, nu0 = d, b0 = 2 (bayes_pmf.py:157-186,
    with the outer product of the mean offset); the Wishart by Bartlett's
    decomposition from the Gamma and normal draws."""
    N, d = F.shape[-2:]
    x_bar = F.mean(-2)
    C = F - x_bar[:, None]
    S_bar = C.mT @ C / (N - 1)
    eye = torch.eye(d, dtype=F.dtype, device=F.device)
    W = _inv(eye + N * S_bar
             + (B0 * N) / (B0 + N) * (x_bar[:, :, None] * x_bar[:, None, :]))
    W = (W + W.mT) / 2
    A = torch.diag_embed(torch.sqrt(2.0 * gamma)) + torch.tril(w, -1)
    X = _chol(W) @ A
    prec = X @ X.mT
    lam = _chol(_inv((B0 + N) * prec))
    mu = (lam @ z_mu[..., None])[..., 0] + N * x_bar / (B0 + N)
    return mu, prec


def row_draws(mask, Rm, other, mu, prec, z, center, cells_rc, dm, dr):
    """Every row's draw from its conditional, L lanes: precision
    S_i = prec + beta sum_j mask_ij o_j o_j^T, mean
    S_i^-1 (beta sum_j mask_ij (R_ij - center) o_j + prec mu), plus
    chol(S_i)^-T z_i. ``cells_rc`` = (row, col) adds each lane's one cell
    (mask + dm, masked rating + dr there)."""
    L, c, d = other.shape
    outer = (other[:, :, :, None] * other[:, :, None, :]).reshape(L, c, d * d)
    G = (mask @ outer).reshape(L, -1, d, d)
    Go = mask @ other
    mr = Rm @ other
    S = prec[:, None] + BETA * G
    rhs = BETA * (mr - center[:, None, None] * Go) + (prec @ mu[..., None])[
        :, None, :, 0]
    if cells_rc is not None:
        row, col = cells_rc
        lane = torch.arange(L, device=other.device)
        o = other[lane, col]
        S[lane, row] += (BETA * dm)[:, None, None] * (o[:, :, None] * o[:, None, :])
        rhs[lane, row] += (BETA * (dr - dm * center))[:, None] * o
    Lc = _chol(S)
    mean = torch.cholesky_solve(rhs[..., None], Lc)
    noise = torch.linalg.solve_triangular(Lc.mT, z[..., None], upper=True)
    return (mean + noise)[..., 0]


def run_chain(data: Data, U, V, mean, gens, num_samps: int,
              cells: Optional[Cells] = None, edges=None):
    """``num_samps`` Gibbs rounds from (U, V) (L, ., d) with lane l's noise
    from ``gens[l]``; returns the predictive mean, variance (ddof 0) and,
    with ``edges``, the count of samples in each bin, each (L, ...)."""
    n, m = data.R.shape
    L, _, d = U.shape
    dt, dev = U.dtype, U.device
    maskf = data.known.to(dt)
    Rm = data.R
    cells_u = cells_v = None
    dm = dr = None
    if cells is not None:
        was = data.known[cells.i, cells.j].to(dt)
        dm, dr = 1.0 - was, cells.v - was * data.R[cells.i, cells.j]
        cells_u, cells_v = (cells.i, cells.j), (cells.j, cells.i)
    s1 = torch.zeros((L, n, m), dtype=dt, device=dev)
    s2 = torch.zeros_like(s1)
    bins = None
    if edges is not None:
        e = torch.as_tensor(np.asarray(edges), dtype=dt, device=dev)
        lo, hi = e[:-1, None, None], e[1:, None, None]
        bins = torch.zeros((L, len(edges) - 1, n, m), dtype=dt, device=dev)
    for _ in range(num_samps):
        nz = round_noise(gens, n, m, d, dt, dev)
        mu_u, p_u = hyper_draw(U, nz["gamma_u"], nz["w_u"], nz["mu_u"])
        mu_v, p_v = hyper_draw(V, nz["gamma_v"], nz["w_v"], nz["mu_v"])
        for s in range(NUM_GIBBS):
            U = row_draws(maskf, Rm, V, mu_u, p_u, nz["z_u"][s], mean,
                          cells_u, dm, dr)
            V = row_draws(maskf.T, Rm.T, U, mu_v, p_v, nz["z_v"][s], mean,
                          cells_v, dm, dr)
        pred = U @ V.mT + mean[:, None, None]
        s1 += pred
        s2 += pred * pred
        if bins is not None:
            p = pred[:, None]
            bins += ((p >= lo) & (p < hi)).to(dt)
    mu = s1 / num_samps
    var = (s2 / num_samps - mu * mu).clamp(min=0.0)
    return mu, var, bins


def bin_edges(values: Sequence[float]) -> np.ndarray:
    """Midpoints between the sorted values, with infinite ends."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    return np.concatenate([[-np.inf], (v[1:] + v[:-1]) / 2, [np.inf]])


# ---------------------------------------------------------------------------
# The cells' computations


@dataclasses.dataclass
class Model:
    """What a configuration fixes: width, samples, rating values, error."""

    d: int
    base_samples: int
    lookahead_samples: int
    values: Tuple[float, ...]
    binary_error: bool
    fit_budget: int = 200  # the lane refit's proposals
    dirichlet_alpha: float = 0.1


@dataclasses.dataclass
class Base:
    U: torch.Tensor  # (n, d) the MAP
    V: torch.Tensor
    mean: torch.Tensor  # ()
    pred_mean: torch.Tensor  # (n, m) of the chain
    var: torch.Tensor  # (n, m)
    bins: torch.Tensor  # (n_values, n, m)


def base_chain(data: Data, model: Model, U, V, mean, chain_seed: int
               ) -> Base:
    """The base chain of ``base_samples`` rounds from the MAP (U, V, mean)
    under ``chain_seed``, with its value histogram."""
    mu, var, bins = run_chain(
        data, U[None], V[None], mean.reshape(1),
        [generator(chain_seed, U.device)], model.base_samples,
        edges=bin_edges(model.values))
    return Base(U, V, mean, mu[0], var[0], bins[0])


def init_seeds(seed: int) -> Tuple[int, int]:
    """(start, chain) seeds of the active family's start under ``seed``:
    fold_in(k, 1) and fold_in(k, 2), k = fold_in_name(seed, "init")."""
    k = fold_in_name(seed, "init")
    return fold_in(k, 1), fold_in(k, 2)


def initial_fit(data: Data, model: Model, seed: int):
    """The family's MAP under ``seed``: U, V ~ U(0, 1), then the fit;
    (U, V, mean)."""
    n, m = data.R.shape
    U, V = init_factors(init_seeds(seed)[0], n, m, model.d, data.R.device)
    mean = data.mean_rating()
    U, V = fit_batch(data, U.to(data.R.dtype), V.to(data.R.dtype), mean)
    return U, V, mean


def initial_state(data: Data, model: Model, seed: int) -> Base:
    """The family's start under ``seed``: the MAP fit and its chain."""
    U, V, mean = initial_fit(data, model, seed)
    return base_chain(data, model, U, V, mean, init_seeds(seed)[1])


def refit(data: Data, model: Model, U, V, refit_seed: int) -> Base:
    """An active step's refit after a rating was added: the MAP warm from
    (U, V), then a fresh base chain under ``refit_seed``."""
    mean = data.mean_rating()
    U, V = fit_batch(data, U, V, mean)
    return base_chain(data, model, U, V, mean, refit_seed)


def expvar_scores(data: Data, model: Model, base: Base, cand: Sequence[int],
                  seeds: Sequence[int]) -> torch.Tensor:
    """E[total predictive variance] after observing each candidate cell
    (flat index ``cand[c]``, its lanes seeded under ``seeds[c]``): per
    value a lane adds the rating, refits the MAP from the base MAP with
    the exact line search, runs a fresh chain and sums its variance over
    every cell; the lanes are weighted by the base chain's smoothed
    histogram of the cell."""
    n, m = data.R.shape
    dt, dev = data.R.dtype, data.R.device
    vals = sorted(model.values)
    nv = len(vals)
    cand = [int(c) for c in cand]
    L = len(cand) * nv
    ci = torch.tensor([c // m for c in cand for _ in vals], device=dev)
    cj = torch.tensor([c % m for c in cand for _ in vals], device=dev)
    cv = torch.tensor([v for _ in cand for v in vals], dtype=dt, device=dev)
    cells = Cells(ci, cj, cv)
    mean = lane_mean(data, cells)
    U = base.U.expand(L, n, model.d)
    V = base.V.expand(L, m, model.d)
    U, V = fit_lanes_poly(data, U, V, mean, cells, model.fit_budget)
    gens = [generator(s, dev) for c, sd in zip(cand, seeds)
            for s in lane_seeds(sd, [c], nv)]
    _, var, _ = run_chain(data, U, V, mean, gens, model.lookahead_samples,
                          cells=cells)
    evals = var.sum((-2, -1)).reshape(len(cand), nv)
    w = ((base.bins[:, ci[::nv], cj[::nv]] + model.dirichlet_alpha)
         / (model.base_samples + model.dirichlet_alpha * nv)).T
    return (evals * w).sum(-1)


def error(data: Data, pred_mean: torch.Tensor, binary: bool) -> float:
    """Test RMSE, or the share of test cells whose sign is wrong."""
    if binary:
        miss = torch.sign(pred_mean) != data.real
        return float(torch.where(data.test, miss, False).sum()
                     / data.test.sum().clamp(min=1))
    d2 = torch.where(data.test, (pred_mean - data.real) ** 2, 0.0)
    return float(torch.sqrt(d2.sum() / data.test.sum().clamp(min=1)))


def step_seeds(seed: int, criterion: str, step: int) -> Tuple[int, int]:
    """(score, refit) seeds of active step ``step`` (1 is the first)."""
    k = fold_in(fold_in_name(seed, criterion), step)
    return fold_in(k, 0), fold_in(k, 1)
