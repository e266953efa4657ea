"""Matrix-normal (Kronecker-factored) variational approximation
(mirrors ``amf_tpu/models/mnormal.py``).

Capability parity with the reference's ``MNActivePMF`` approximation layer
(python-pmf/mn_active_pmf.py:119-330 + matrix_normal_exps_cy.pyx): the
posterior over X = vstack(U, V) is MN(mean, cov_useritems (x) cov_latents),
state (n+m)^2 + d^2 instead of ((n+m)d)^2. Every function takes one
approximation or a tile of lanes (leading dimensions), as ``vnormal``.

Reference bugs fixed, as in the JAX package: the item-trace regularization
term never accumulates (matrix_normal_exps_cy.pyx:176, :192) and the item
regularizer divides by sigma_u_sq (:196-197). The gradient is autograd of
the fixed KL value.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from amf_tpu_torch.models.pmf import PMFState
from amf_tpu_torch.models.vnormal import _tri_symmetrize, _value_and_grad
from amf_tpu_torch.ops.linesearch import DescentInfo, _bcast, adaptive_descent
from amf_tpu_torch.ops.moments import mn_pred_mean_var
from amf_tpu_torch.ops.psd import project_psd
from amf_tpu_torch.types import Problem


class MNConfig(NamedTuple):
    """Static knobs (reference defaults: mn_active_pmf.py:156-158)."""

    latent_d: int = 1
    learning_rate: float = 1e-4
    min_eig: float = 1e-5
    stop_thresh: float = 0.005
    min_lr: float = 1e-10
    max_fit_steps: int = 500


@dataclasses.dataclass(frozen=True)
class MNState:
    mean: torch.Tensor  # (..., n+m, d)
    cov_useritems: torch.Tensor  # (..., n+m, n+m)
    cov_latents: torch.Tensor  # (..., d, d)


def initialize_approx(
    pmf_state: PMFState, cfg: MNConfig, random_cov: bool = False,
    generator: Optional[torch.Generator] = None,
) -> MNState:
    """Mean at the MAP factors, identity covariances, or with
    ``random_cov`` a a^T and b b^T of standard normals a (n+m, n+m) and
    b (d, d) drawn from ``generator``
    (reference: mn_active_pmf.initialize_approx :202-219)."""
    mean = torch.cat([pmf_state.U, pmf_state.V], dim=-2)
    n_ui, d = mean.shape[-2:]
    lead = mean.shape[:-2]
    if random_cov:
        a, b = (torch.randn(lead + (k, k), generator=generator,
                            dtype=mean.dtype, device=mean.device)
                for k in (n_ui, d))
        return MNState(mean=mean, cov_useritems=a @ a.mT,
                       cov_latents=b @ b.mT)

    def eye(k):
        return torch.eye(k, dtype=mean.dtype, device=mean.device).expand(
            lead + (k, k))

    return MNState(mean=mean, cov_useritems=eye(n_ui), cov_latents=eye(d))


def kl_divergence(
    mn: MNState, pmf_state: PMFState, problem: Problem, cfg: MNConfig,
    mean=None, cov_useritems=None, cov_latents=None,
) -> torch.Tensor:
    """KL(approximation || PMF model), up to an additive constant, one
    value a lane (reference: matrix_normal_exps_cy.mn_kl_divergence
    :159-213, with the item-regularizer bugs fixed)."""
    mean = mn.mean if mean is None else mean
    Sr = mn.cov_useritems if cov_useritems is None else cov_useritems
    Sc = mn.cov_latents if cov_latents is None else cov_latents
    n, m = problem.shape
    d = mean.shape[-1]

    pred_mean, pred_var = mn_pred_mean_var(mean, Sr, Sc, n, m)
    r = problem.R_obs
    data = torch.where(problem.rated,
                       pred_mean ** 2 + pred_var - 2 * r * pred_mean + r * r,
                       0.0).sum(dim=(-2, -1))
    kl = data / (2 * pmf_state.sigma_sq)

    # entropy term
    logdet_r = torch.linalg.slogdet(Sr).logabsdet
    logdet_c = torch.linalg.slogdet(Sc).logabsdet
    kl = kl - (logdet_r * d + logdet_c * (n + m)) / 2

    # regularization: E||U||^2 = ||mean_u||^2 + tr(Sr_uu) tr(Sc), etc.
    tr_c = torch.diagonal(Sc, dim1=-2, dim2=-1).sum(-1)
    diag_r = torch.diagonal(Sr, dim1=-2, dim2=-1)
    kl = kl + ((mean[..., :n, :] ** 2).sum(dim=(-2, -1))
               + diag_r[..., :n].sum(-1) * tr_c) / (2 * pmf_state.sigma_u_sq)
    kl = kl + ((mean[..., n:, :] ** 2).sum(dim=(-2, -1))
               + diag_r[..., n:].sum(-1) * tr_c) / (2 * pmf_state.sigma_v_sq)
    return kl


def fit_normal(
    mn: MNState, pmf_state: PMFState, problem: Problem, cfg: MNConfig,
    max_steps: Optional[int] = None,
) -> Tuple[MNState, DescentInfo]:
    """Adaptive-LR KL descent, PSD-projecting both covariance factors
    (reference: mn_active_pmf.fit_normal_kls :242-288)."""
    max_steps = cfg.max_fit_steps if max_steps is None else max_steps

    def value_and_grad_fn(x):
        f, (gm, gr, gc) = _value_and_grad(
            lambda t: kl_divergence(mn, pmf_state, problem, cfg, *t), x)
        return f, (gm, _tri_symmetrize(gr), _tri_symmetrize(gc))

    def step_fn(x, g, lr):
        mean, Sr, Sc = (a - _bcast(lr, a) * b for a, b in zip(x, g))
        return (mean, project_psd(Sr, cfg.min_eig),
                project_psd(Sc, cfg.min_eig))

    (mean, Sr, Sc), info = adaptive_descent(
        (mn.mean, mn.cov_useritems, mn.cov_latents), value_and_grad_fn,
        step_fn, lr0=cfg.learning_rate, stop_thresh=cfg.stop_thresh,
        min_lr=cfg.min_lr, max_steps=max_steps)
    return MNState(mean=mean, cov_useritems=Sr, cov_latents=Sc), info


def approx_pred_means_vars(mn: MNState, problem: Problem
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., n, m) predictive means/variances
    (reference: mn_active_pmf.approx_pred_means_vars :317-330, batched)."""
    n, m = problem.shape
    return mn_pred_mean_var(mn.mean, mn.cov_useritems, mn.cov_latents, n, m)


def approx_entropy(mn: MNState, n: int, m: int) -> torch.Tensor:
    """log-det entropy of the Kronecker covariance, up to constants:
    d logdet(Sr) + (n+m) logdet(Sc)."""
    d = mn.mean.shape[-1]
    return (d * torch.linalg.slogdet(mn.cov_useritems).logabsdet
            + (n + m) * torch.linalg.slogdet(mn.cov_latents).logabsdet)


def mean_meandiff(mn: MNState, pmf_state: PMFState) -> torch.Tensor:
    p = torch.cat([pmf_state.U, pmf_state.V], dim=-2)
    return (mn.mean - p).abs().mean(dim=(-2, -1))
