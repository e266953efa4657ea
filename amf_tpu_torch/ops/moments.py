"""Closed-form Gaussian moments (Isserlis), batched over all matrix cells
(mirrors ``amf_tpu/ops/moments.py``).

Reference analogues: python-pmf/normal_exps_cy.pyx:40-135 (scalar moments,
one cell at a time) and matrix_normal_exps_cy.pyx:28-154 (Kronecker
versions). Every per-cell scalar moment becomes an all-pairs einsum, and
every function takes any leading lane dimensions (``...``): a lookahead
tile computes all of its lanes' moments in one pass.

Key identity (general Isserlis, valid for repeated indices), summed over
latent dims k, l with x1=U_ik, x2=V_jk, x3=U_il, x4=V_jl:

  E[(U_i^T V_j)^2] = (mu_i . mv_j + tr A)^2                  (= E[U_i^T V_j]^2)
    + mu_i^T Bv mu_i + mv_j^T Bu mv_j + 2 mv_j^T A mu_i
    + sum(Bu * Bv) + tr(A A)                                 (= Var[U_i^T V_j])

with A_kl = cov(U_ik, V_jl), Bu_kl = cov(U_ik, U_il), Bv_kl = cov(V_jk, V_jl).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

# ---------------------------------------------------------------------------
# Scalar moments (kept for tests / parity with normal_exps_cy.pyx:40-135)


def tripexpect(mean, cov, a, b, c):
    """E[X_a X_b X_c] for N(mean, cov)."""
    return (mean[a] * mean[b] * mean[c] + mean[a] * cov[b, c]
            + mean[b] * cov[a, c] + mean[c] * cov[a, b])


def quadexpect(mean, cov, a, b, c, d):
    """E[X_a X_b X_c X_d] (general Isserlis; valid for repeated indices)."""
    ma, mb, mc, md = mean[a], mean[b], mean[c], mean[d]
    return (ma * mb * mc * md
            + ma * mb * cov[c, d] + ma * mc * cov[b, d] + ma * md * cov[b, c]
            + mb * mc * cov[a, d] + mb * md * cov[a, c] + mc * md * cov[a, b]
            + cov[a, b] * cov[c, d] + cov[a, c] * cov[b, d]
            + cov[a, d] * cov[b, c])


def exp_squared(mean, cov, a, b):
    """E[X_a^2 X_b^2]."""
    return (4 * mean[a] * mean[b] * cov[a, b] + 2 * cov[a, b] ** 2
            + (mean[a] ** 2 + cov[a, a]) * (mean[b] ** 2 + cov[b, b]))


def exp_a2bc(mean, cov, a, b, c):
    """E[X_a^2 X_b X_c]."""
    ma, mb, mc = mean[a], mean[b], mean[c]
    return ((ma ** 2 + cov[a, a]) * (mb * mc + cov[b, c])
            + 2 * ma * mc * cov[a, b] + 2 * ma * mb * cov[a, c]
            + 2 * cov[a, b] * cov[a, c])


# ---------------------------------------------------------------------------
# Full-covariance (vector-normal) batched moments


class VNBlocks(NamedTuple):
    """Views of the flat (..., K, K) covariance, K = (n+m)*d, flat index of
    U_{ik} = i*d+k and V_{jk} = n*d + j*d + k (the reference's index arrays,
    active_pmf.py:141-142)."""

    mu_u: torch.Tensor  # (..., n, d)
    mu_v: torch.Tensor  # (..., m, d)
    Cuu: torch.Tensor  # (..., n, d, n, d)
    Cuv: torch.Tensor  # (..., n, d, m, d)
    Cvv: torch.Tensor  # (..., m, d, m, d)
    Bu: torch.Tensor  # (..., n, d, d) per-row covariance diag blocks
    Bv: torch.Tensor  # (..., m, d, d)


def vn_blocks(mean: torch.Tensor, cov: torch.Tensor, n: int, m: int,
              d: int) -> VNBlocks:
    lead = mean.shape[:-1]
    nd = n * d
    mu_u = mean[..., :nd].reshape(*lead, n, d)
    mu_v = mean[..., nd:].reshape(*lead, m, d)
    Cuu = cov[..., :nd, :nd].reshape(*lead, n, d, n, d)
    Cuv = cov[..., :nd, nd:].reshape(*lead, n, d, m, d)
    Cvv = cov[..., nd:, nd:].reshape(*lead, m, d, m, d)
    Bu = torch.einsum("...ikil->...ikl", Cuu)
    Bv = torch.einsum("...jkjl->...jkl", Cvv)
    return VNBlocks(mu_u, mu_v, Cuu, Cuv, Cvv, Bu, Bv)


def vn_pred_mean_var(mean: torch.Tensor, cov: torch.Tensor, n: int, m: int,
                     d: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., n, m) predictive means and variances of R_ij = U_i^T V_j
    (replaces the reference's double loop over cells, active_pmf.py:301-322)."""
    b = vn_blocks(mean, cov, n, m, d)
    trA = torch.einsum("...ikjk->...ij", b.Cuv)
    pred_mean = b.mu_u @ b.mu_v.mT + trA
    var = (torch.einsum("...ik,...jkl,...il->...ij", b.mu_u, b.Bv, b.mu_u)
           + torch.einsum("...jk,...ikl,...jl->...ij", b.mu_v, b.Bu, b.mu_v)
           + 2 * torch.einsum("...jk,...ikjl,...il->...ij", b.mu_v, b.Cuv,
                              b.mu_u)
           + torch.einsum("...ikl,...jkl->...ij", b.Bu, b.Bv)
           + torch.einsum("...ikjl,...iljk->...ij", b.Cuv, b.Cuv))
    return pred_mean, var


def vn_exp_dotprod_sq(mean, cov, n: int, m: int, d: int) -> torch.Tensor:
    """(..., n, m) matrix of E[(U_i^T V_j)^2]
    (normal_exps_cy.exp_dotprod_sq:111, batched)."""
    pm, var = vn_pred_mean_var(mean, cov, n, m, d)
    return pm ** 2 + var


def vn_pred_covs(mean: torch.Tensor, cov: torch.Tensor, n: int, m: int,
                 d: int) -> torch.Tensor:
    """(..., n*m, n*m) covariance of the predicted matrix entries,
    cov(U_i.V_j, U_a.V_b), in six einsums (replaces the reference's Python
    double loop, active_pmf.py:324-390). Only the pred-entropy-bound
    criterion uses it, on small problems."""
    b = vn_blocks(mean, cov, n, m, d)
    lead = mean.shape[:-1]
    # indices: x1=U_ik, x2=V_jk, x3=U_al, x4=V_bl; see module docstring.
    out = torch.einsum("...ik,...jkbl,...al->...ijab", b.mu_u, b.Cvv, b.mu_u)
    out += torch.einsum("...ik,...aljk,...bl->...ijab", b.mu_u, b.Cuv, b.mu_v)
    out += torch.einsum("...jk,...ikbl,...al->...ijab", b.mu_v, b.Cuv, b.mu_u)
    out += torch.einsum("...jk,...ikal,...bl->...ijab", b.mu_v, b.Cuu, b.mu_v)
    out += torch.einsum("...ikal,...jkbl->...ijab", b.Cuu, b.Cvv)
    out += torch.einsum("...ikbl,...aljk->...ijab", b.Cuv, b.Cuv)
    return out.reshape(*lead, n * m, n * m)


# ---------------------------------------------------------------------------
# Matrix-normal (Kronecker) batched moments
# cov(X_{ik}, X_{jl}) = cov_rows[i, j] * cov_cols[k, l], X = vstack(U, V)
# (reference: matrix_normal_exps_cy.pyx:28-154)


def mn_pred_mean_var(
    mean: torch.Tensor,  # (..., n+m, d)
    cov_rows: torch.Tensor,  # (..., n+m, n+m)  "cov_useritems"
    cov_cols: torch.Tensor,  # (..., d, d)      "cov_latents"
    n: int,
    m: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., n, m) predictive means/variances under the Kronecker
    factorization: the VN formulas with A = S_uv[i,j] * Oc,
    Bu = S_uu[i,i] * Oc, Bv = S_vv[j,j] * Oc (mn_active_pmf.py:300-330)."""
    mu_u, mu_v = mean[..., :n, :], mean[..., n:, :]
    S_uv = cov_rows[..., :n, n:]  # (..., n, m)
    diag = torch.diagonal(cov_rows, dim1=-2, dim2=-1)
    s_u, s_v = diag[..., :n], diag[..., n:]
    tr_c = torch.diagonal(cov_cols, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    frob2 = (cov_cols * cov_cols).sum(dim=(-2, -1))[..., None, None]

    pred_mean = mu_u @ mu_v.mT + S_uv * tr_c

    uOu = torch.einsum("...ik,...kl,...il->...i", mu_u, cov_cols, mu_u)
    vOv = torch.einsum("...jk,...kl,...jl->...j", mu_v, cov_cols, mu_v)
    vOu = torch.einsum("...jk,...kl,...il->...ij", mu_v, cov_cols, mu_u)

    var = (uOu[..., :, None] * s_v[..., None, :]
           + vOv[..., None, :] * s_u[..., :, None]
           + 2 * S_uv * vOu
           + (s_u[..., :, None] * s_v[..., None, :]) * frob2
           + (S_uv ** 2) * frob2)
    return pred_mean, var


def mn_exp_dotprod_sq(mean, cov_rows, cov_cols, n: int, m: int
                      ) -> torch.Tensor:
    pm, var = mn_pred_mean_var(mean, cov_rows, cov_cols, n, m)
    return pm ** 2 + var
