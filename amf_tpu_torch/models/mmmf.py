"""Max-Margin Matrix Factorization (MMMF) on PyTorch
(mirrors ``amf_tpu/models/mmmf.py``).

Capability parity with the reference's MATLAB SDP path (mmmf/solveD.m:37-94 +
evaluate_active.m + select_*.m): soft-margin nuclear-norm MMMF on binary
labels. Like the JAX package, the port solves the primal convex problem the
reference's SDP is dual to,

    min_X  ||X||_*  +  C * sum_{(i,j) observed} max(0, 1 - y_ij X_ij),

by ADMM with two closed-form proximal maps: singular-value soft-thresholding
from the eigendecomposition of the smaller-side Gram (``torch.linalg.eigh``,
cuSOLVER on the card) and an elementwise three-zone hinge prox. The max-norm
('m') and ordinal (solveDord.m) variants and the selector margin maps are
here too. No hand-written kernel: every step is a GEMM, an eigh or
elementwise work, as in the JAX package, where no Pallas kernel lies on
this path.

What differs from the JAX package's ``while_loop``:

  * the loop test ``resid > tol and it < max_iters`` reads the residual on
    the host once an iteration. On the card the eigh already waits on the
    host for its own error check every iteration, so the read adds no
    second wait of note; the iterate that comes out is the one the JAX loop
    stops at;
  * ``torch.linalg.eigh`` raises on a non-finite input where LAPACK in JAX
    returns NaN. The port's eigh runs on a zeroed matrix when its input is
    not finite and poisons its output with NaN on the device, so a poisoned
    warm start reaches a NaN residual, leaves the loop and is re-solved
    cold, as in JAX. A failure to converge on a finite input still raises.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from amf_tpu_torch.utils.platform import resolve_device

# Provenance tag stamped into results and checkpoints, the JAX package's:
# "eigh-svt-v1" = the ADMM solver with eigh-based SVT, the cold-restart
# guard and adaptive rho (PARITY.md adjudication 4).
SOLVER_ERA = "eigh-svt-v1"


class MMMFConfig(NamedTuple):
    C: float = 1.0  # slack penalty (reference default in evaluate_active.m)
    rho: float = 1.0  # initial ADMM penalty
    max_iters: int = 2000
    tol: float = 1e-6  # primal/dual residual tolerance (Frobenius, relative)
    # residual balancing (Boyd et al. 2011 §3.4.1): scale rho up/down by
    # rho_scale when one residual exceeds balance_mu x the other
    adapt_rho: bool = True
    balance_mu: float = 10.0
    rho_scale: float = 2.0
    # over-relaxation (Boyd et al. 2011 §3.4.3); default off, as in JAX
    over_relax: float = 1.0


@dataclasses.dataclass(frozen=True)
class MMMFState:
    """ADMM variables, carried across active steps for warm starting."""

    X: torch.Tensor  # learned matrix (the reference's x)
    Z: torch.Tensor  # split variable
    W: torch.Tensor  # scaled dual


def init_state(n: int, m: int, dtype=torch.float32, device=None) -> MMMFState:
    """All-zero ADMM variables; ``device`` None means the card."""
    z = torch.zeros((n, m), dtype=dtype, device=resolve_device(device))
    return MMMFState(X=z, Z=z, W=z)


def _eigh(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``eigh`` of the symmetrised ``g`` (as ``jnp.linalg.eigh`` does it),
    NaN everywhere when ``g`` is not finite: no raise and no host read."""
    ok = torch.isfinite(g).all()
    g = torch.where(ok, (g + g.mT) / 2, torch.zeros_like(g))
    w, V = torch.linalg.eigh(g)
    poison = torch.where(ok, 0.0, torch.nan).to(g.dtype)
    return w + poison, V + poison


def _svt(a: torch.Tensor, tau) -> torch.Tensor:
    """Singular-value soft-thresholding: prox of tau * ||.||_*.

    From the eigendecomposition of the smaller-side Gram, with the JAX
    package's side choice (``m <= n``): A = U S V^T gives A^T A = V S^2 V^T
    and svt(A) = A V diag(f) V^T with f = (s - tau)_+ / s. Only singular
    values above tau count, so 1/s never divides by anything below tau.
    """
    n, m = a.shape
    tau = torch.as_tensor(tau, dtype=a.dtype, device=a.device)
    if m <= n:
        w, V = _eigh(a.mT @ a)
        s = torch.sqrt(torch.clamp(w, min=0.0))
        f = torch.where(s > tau, (s - tau) / torch.maximum(s, tau), 0.0)
        return ((a @ V) * f[None, :]) @ V.mT
    w, U = _eigh(a @ a.mT)
    s = torch.sqrt(torch.clamp(w, min=0.0))
    f = torch.where(s > tau, (s - tau) / torch.maximum(s, tau), 0.0)
    return (U * f[None, :]) @ (U.mT @ a)


def _hinge_prox(a, y, observed, c_over_rho):
    """Elementwise prox of (C/rho) * max(0, 1 - y z) at a; identity on
    unobserved cells."""
    u = y * a
    z = torch.where(
        u >= 1.0,
        a,
        torch.where(u >= 1.0 - c_over_rho, y, a + c_over_rho * y),
    )
    return torch.where(observed, z, a)


def _admm(Y, observed, scale, cfg: MMMFConfig, state: MMMFState
          ) -> Tuple[MMMFState, int]:
    """The ADMM iterations from ``state``, with the exit rescale of W."""
    rho0 = torch.as_tensor(cfg.rho, dtype=Y.dtype, device=Y.device)
    rho = rho0
    one = torch.ones((), dtype=Y.dtype, device=Y.device)
    X, Z, W = state.X, state.Z, state.W
    it, resid = 0, float("inf")
    while resid > cfg.tol and it < cfg.max_iters:
        X = _svt(Z - W, 1.0 / rho)
        # over-relaxed splitting point (X itself stays the f-prox output)
        Xh = cfg.over_relax * X + (1.0 - cfg.over_relax) * Z
        Z_new = _hinge_prox(Xh + W, Y, observed, cfg.C / rho)
        W = W + Xh - Z_new
        primal = torch.linalg.norm(X - Z_new) / scale
        dual = rho * torch.linalg.norm(Z_new - Z) / scale
        Z = Z_new
        if cfg.adapt_rho:
            # residual balancing; the scaled dual W = u/rho rescales with rho
            fac = torch.where(
                primal > cfg.balance_mu * dual, cfg.rho_scale * one,
                torch.where(dual > cfg.balance_mu * primal,
                            one / cfg.rho_scale, one))
            rho = rho * fac
            W = W / fac
        it += 1
        # NaN compares False: a non-finite iterate leaves the loop
        resid = float(torch.maximum(primal, dual))
    # express the scaled dual at the NOMINAL rho on exit (u = rho_end * W):
    # the KKT certificate and the next warm start (which re-enters at rho0)
    # both read W consistently
    return MMMFState(X=X, Z=Z, W=W * (rho / rho0)), it


def solve(
    Y: torch.Tensor,
    cfg: MMMFConfig = MMMFConfig(),
    state: Optional[MMMFState] = None,
) -> Tuple[MMMFState, int]:
    """Solve soft-margin nuclear-norm MMMF for a +1/0/-1 label matrix.

    Returns (state, n_iters); ``state.X`` is the learned matrix whose sign
    should agree (up to slack) with Y. Pass the previous step's state to warm
    start. A non-finite result (a poisoned warm start) is re-solved cold
    from zeros, and the cold solve's state and iterations are returned.
    """
    observed = Y != 0
    n, m = Y.shape
    cold = init_state(n, m, Y.dtype, Y.device)
    scale = torch.clamp(torch.sqrt(observed.sum().to(Y.dtype)), min=1.0)
    st, it = _admm(Y, observed, scale, cfg, cold if state is None else state)
    # failure recovery (SURVEY.md §5.3): one host read a solve
    if not bool(torch.isfinite(st.X.sum() + st.Z.sum() + st.W.sum())):
        st, it = _admm(Y, observed, scale, cfg, cold)
    return st, it


def factors(X: torch.Tensor, rank: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Low-norm factors xu, xv with X = xu @ xv.T (reference: solveD.m:83-88,
    via SVD with singular values split evenly)."""
    u, s, vt = torch.linalg.svd(X, full_matrices=False)
    if rank is not None:
        u, s, vt = u[:, :rank], s[:rank], vt[:rank]
    root = torch.sqrt(s)
    return u * root[None, :], vt.mT * root[None, :]


def objective(X: torch.Tensor, Y: torch.Tensor, C: float) -> torch.Tensor:
    """||X||_* + C * sum hinge — for solver validation."""
    s = torch.linalg.svdvals(X)
    hinge = torch.where(Y != 0, torch.clamp(1.0 - Y * X, min=0.0), 0.0)
    return s.sum() + C * hinge.sum()


# ---------------------------------------------------------------------------
# Max-norm mode (reference: solveD.m 'm' mode, :37-45)


class MaxNormConfig(NamedTuple):
    C: float = 1.0
    rank: Optional[int] = None  # factor rank; None = min(n, m) (exact)
    max_iters: int = 4000
    lr0: float = 0.1


@dataclasses.dataclass(frozen=True)
class MaxNormState:
    U: torch.Tensor
    V: torch.Tensor

    @property
    def X(self) -> torch.Tensor:
        return self.U @ self.V.mT


def solve_maxnorm(
    Y: torch.Tensor,
    cfg: MaxNormConfig = MaxNormConfig(),
    state: Optional[MaxNormState] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[MaxNormState, torch.Tensor]:
    """Soft-margin MAX-NORM MMMF (the reference's solveD 'm' objective):

        min  max(max_i ||U_i||^2, max_j ||V_j||^2)
             + C * sum_{obs} hinge(1 - y_ij U_i . V_j)

    by subgradient descent with diminishing steps; the max term contributes
    a subgradient on the argmax row (the first on ties, as ``jnp.argmax``).
    Without a ``state`` the factors start at 0.1 x standard normals from
    ``generator`` (a fresh one seeded 0 when None). Returns (state, final
    objective).
    """
    n, m = Y.shape
    observed = Y != 0
    d = cfg.rank or min(n, m)
    if state is None:
        if generator is None:
            generator = torch.Generator(device=Y.device)
            generator.manual_seed(0)
        kw = dict(generator=generator, dtype=Y.dtype, device=Y.device)
        state = MaxNormState(U=0.1 * torch.randn((n, d), **kw),
                             V=0.1 * torch.randn((m, d), **kw))
    rows_u = torch.arange(n, device=Y.device)[:, None]
    rows_v = torch.arange(m, device=Y.device)[:, None]
    U, V = state.U, state.V
    for t in range(cfg.max_iters):
        X = U @ V.mT
        act = observed & (Y * X < 1.0)
        dX = torch.where(act, -cfg.C * Y, 0.0)
        dU = dX @ V
        dV = dX.mT @ U
        # subgradient of max(max_i ||U_i||^2, max_j ||V_j||^2), on the device
        un = (U * U).sum(1)
        vn = (V * V).sum(1)
        iu, iv = torch.argmax(un), torch.argmax(vn)
        u_side = un.max() >= vn.max()
        dU = dU + torch.where(u_side, 2.0, 0.0) * torch.where(
            rows_u == iu, U, 0.0)
        dV = dV + torch.where(u_side, 0.0, 2.0) * torch.where(
            rows_v == iv, V, 0.0)
        eta = cfg.lr0 / (t + 1.0) ** 0.5
        U, V = U - eta * dU, V - eta * dV
    return MaxNormState(U=U, V=V), maxnorm_objective(U, V, Y, cfg.C)


def maxnorm_objective(U, V, Y, C: float) -> torch.Tensor:
    X = U @ V.mT
    hinge = torch.where(Y != 0, torch.clamp(1.0 - Y * X, min=0.0), 0.0)
    return (torch.maximum((U * U).sum(1).max(), (V * V).sum(1).max())
            + C * hinge.sum())


# ---------------------------------------------------------------------------
# Ordinal-label MMMF (reference: solveDord.m:1-60)


class OrdinalConfig(NamedTuple):
    C: float = 1.0  # >0: immediate-threshold hinge; use all_thresholds below
    all_thresholds: bool = False  # reference C<0 mode (loss over all thresholds)
    per_row_thresh: bool = False  # reference perrowthresh
    require_thresh_order: bool = True  # reference requirethreshord (isotonic)
    max_iters: int = 4000
    lr0: float = 0.5


def _isotonic(v: torch.Tensor) -> torch.Tensor:
    """Exact L2 projection onto nondecreasing vectors along the last axis via
    the minimax representation of isotonic regression:
        iso(v)_k = max_{i <= k} min_{j >= k} mean(v[i..j]).
    O(R^3) in the threshold count, with no PAV recursion."""
    R = v.shape[-1]
    cs = torch.cat([torch.zeros(v.shape[:-1] + (1,), dtype=v.dtype,
                                device=v.device), torch.cumsum(v, -1)], -1)
    ar = torch.arange(R, device=v.device)
    i = ar[:, None]  # segment start
    j = ar[None, :]  # segment end (inclusive)
    seg_mean = ((cs[..., j + 1] - cs[..., i])
                / torch.clamp(j - i + 1, min=1).to(v.dtype))
    inf = torch.tensor(torch.inf, dtype=v.dtype, device=v.device)
    seg_mean = torch.where(j >= i, seg_mean, inf)  # (..., R, R), [i, j]
    # min over j >= k of mean(i..j): (..., K, I)
    mask_kj = ar[None, :] >= ar[:, None]  # (K, J)
    min_over_j = torch.where(mask_kj[:, None, :], seg_mean[..., None, :, :],
                             inf).amin(-1)
    # max over i <= k: (..., K)
    mask_ki = ar[None, :] <= ar[:, None]  # (K, I)
    return torch.where(mask_ki, min_over_j, -inf).amax(-1)


def ordinal_loss_grads(X, theta, Y_int, observed, R: int, cfg: OrdinalConfig):
    """(loss, dX, dtheta) for the ordinal hinge losses.

    Immediate-threshold (Shashua–Levin, reference C>0): per observed cell
    with label r, hinge(1 - (x - theta_{r-1})) + hinge(1 - (theta_r - x)).
    All-thresholds (reference C<0): sum_k<r hinge(1 - (x - theta_k)) +
    sum_k>=r hinge(1 - (theta_k - x)).
    theta: (R-1,) or (n, R-1) (per-row).
    """
    n, m = X.shape
    C = cfg.C
    nt = R - 1
    th = theta if theta.ndim == 2 else theta[None].expand(n, nt)
    k_idx = torch.arange(nt, device=X.device)

    # masks over thresholds per cell: which side each threshold constrains
    r = Y_int[..., None]  # (n, m, 1), labels 1..R
    below = k_idx[None, None, :] < (r - 1)  # thresholds strictly below label
    above = ~below
    if not cfg.all_thresholds:
        below = below & (k_idx[None, None, :] == (r - 2))
        above = above & (k_idx[None, None, :] == (r - 1))

    diff_low = 1.0 - (X[..., None] - th[:, None, :])  # want x > theta_k + 1
    diff_up = 1.0 - (th[:, None, :] - X[..., None])  # want x < theta_k - 1
    obs = observed[..., None]
    act_low = (diff_low > 0) & below & obs
    act_up = (diff_up > 0) & above & obs

    loss = C * (torch.where(act_low, diff_low, 0.0).sum()
                + torch.where(act_up, diff_up, 0.0).sum())
    dX = C * (-act_low.sum(-1).to(X.dtype) + act_up.sum(-1).to(X.dtype))
    dth_rows = C * (act_low.sum(1).to(X.dtype)
                    - act_up.sum(1).to(X.dtype))  # (n, R-1)
    dtheta = dth_rows if cfg.per_row_thresh else dth_rows.sum(0)
    return loss, dX, dtheta


def solve_ordinal(
    Y: torch.Tensor,  # (n, m) integer labels 1..R, 0 = missing
    R: Optional[int] = None,
    cfg: OrdinalConfig = OrdinalConfig(),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ordinal-label nuclear-norm MMMF (reference: solveDord.m).

    min_{X, theta} ||X||_* + C * ordinal_hinge(X, theta; Y), by proximal
    subgradient with diminishing steps (SVT prox on X; free thresholds,
    optionally isotonic-projected). Integer labels run in float32, as in
    the JAX package.

    Returns (xy predicted labels, X, theta).
    """
    if not Y.is_floating_point():
        Y = Y.to(torch.float32)  # integer labels are the documented input
    n, m = Y.shape
    if R is None:
        R = int(Y.max())
    observed = Y > 0
    Y_int = Y.to(torch.int32)
    nt = R - 1
    theta = torch.arange(1, R, dtype=Y.dtype, device=Y.device) + 0.5
    if cfg.per_row_thresh:
        theta = theta[None].expand(n, nt).clone()
    X = torch.zeros((n, m), dtype=Y.dtype, device=Y.device)
    for t in range(cfg.max_iters):
        _, dX, dtheta = ordinal_loss_grads(X, theta, Y_int, observed, R, cfg)
        eta = cfg.lr0 / (t + 1.0) ** 0.5
        X = _svt(X - eta * dX, eta)
        theta = theta - eta * dtheta
        if cfg.require_thresh_order:
            theta = _isotonic(theta)
    return predict_ordinal(X, theta, n), X, theta


def predict_ordinal(X: torch.Tensor, theta: torch.Tensor, n: int
                    ) -> torch.Tensor:
    """Labels from thresholds: xy = 1 + #{k: x > theta_k}
    (reference: solveDord.m output contract :41-46)."""
    th = theta if theta.ndim == 2 else theta[None].expand(n, theta.shape[-1])
    return 1 + (X[..., None] > th[:, None, :]).sum(-1)


def ordinal_objective(X, theta, Y, R, cfg: OrdinalConfig):
    s = torch.linalg.svdvals(X)
    loss, _, _ = ordinal_loss_grads(X, theta, Y.to(torch.int32), Y > 0, R,
                                    cfg)
    return s.sum() + loss


# ---------------------------------------------------------------------------
# Selectors (reference: mmmf/select_*.m)


def selector_evals(name: str, X: torch.Tensor, can_query: torch.Tensor,
                   generator: Optional[torch.Generator] = None):
    """Margin maps for the selector registry (NaN off the pool), and
    whether the selector takes the largest.

    min-margin / max-margin use |x| (select_min_margin.m:1-12);
    min-margin-pos uses the signed margin with non-positives masked to +inf
    (select_min_margin_pos.m:7); max-margin-pos is the UNMASKED signed max
    (the reference's mask line is commented out, select_max_margin_pos.m:7).
    ``random`` draws uniforms from ``generator``.
    """
    if name == "random":
        ev = torch.rand(X.shape, generator=generator, dtype=X.dtype,
                        device=X.device)
        return torch.where(can_query, ev, torch.nan), True
    if name == "min-margin":
        return torch.where(can_query, X.abs(), torch.nan), False
    if name == "max-margin":
        return torch.where(can_query, X.abs(), torch.nan), True
    if name == "min-margin-pos":
        ev = torch.where(X > 0, X, torch.inf)
        return torch.where(can_query, ev, torch.nan), False
    if name == "max-margin-pos":
        return torch.where(can_query, X, torch.nan), True
    raise ValueError(f"unknown MMMF selector {name!r}")


MMMF_KEYS = {
    "random": "Random",
    "min-margin": "Min Margin",
    "min-margin-pos": "Min Margin Positive",
    "max-margin": "Max Margin",
    "max-margin-pos": "Max Margin Positive",
}
