"""Full-covariance variational normal approximation, the ActivePMF layer
(mirrors ``amf_tpu/models/vnormal.py``).

Capability parity with the reference's ``ActivePMF`` approximation machinery
(python-pmf/active_pmf.py:102-400): a multivariate normal over vec(U, V)
fit by gradient descent on KL(q || PMF model) with PSD projection after
every covariance step, plus the batched predictive quantities the
selection criteria consume.

Every function takes one approximation or a tile of lookahead lanes: the
state's mean is (..., K) and its covariance (..., K, K), K = (n + m) d, and
the problem's fields may carry the same lane dimensions
(``types.LaneCells.problems``). Lanes descend in lockstep; the KL value of
a lane depends on that lane's state only, so the gradient of the summed
value is every lane's own gradient.

  * the KL and all moments are the closed-form all-pairs einsums of
    ``ops.moments``;
  * the KL gradient is autograd of the KL value, with the covariance
    gradient symmetrized as G + G^T - diag(G), the reference's
    triangular-half convention (normal_exps_cy.pyx:140-303 differentiates
    w.r.t. one triangular half and mirrors);
  * ``fit_normal_kls``'s adaptive-LR loop (active_pmf.py:251-288) is
    ``ops.linesearch.adaptive_descent`` with PSD projection inside the step.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from amf_tpu_torch.models.pmf import PMFState
from amf_tpu_torch.ops.linesearch import DescentInfo, _bcast, adaptive_descent
from amf_tpu_torch.ops.moments import vn_pred_covs, vn_pred_mean_var
from amf_tpu_torch.ops.psd import project_psd
from amf_tpu_torch.types import Problem
from amf_tpu_torch.utils.linalg import cholesky_or_nan


class VNConfig(NamedTuple):
    """Static knobs (reference defaults: active_pmf.py:144-146, 251-288).

    cov_param selects the covariance descent parameterization:
      * "psd-project" (default, parity): descend on the full covariance and
        eigh-project to the PSD cone after every proposal, the reference's
        fit_normal_kls trajectory;
      * "chol": descend on a Cholesky factor L with cov = L L^T + min_eig I,
        PSD by construction, so the per-proposal eigh disappears. Same KL
        objective and stationary points, a different trajectory.
    """

    latent_d: int = 1
    learning_rate: float = 1e-4  # normal_learning_rate
    min_eig: float = 1e-5
    stop_thresh: float = 0.005
    min_lr: float = 1e-10
    max_fit_steps: int = 500
    cov_param: str = "psd-project"  # or "chol"


@dataclasses.dataclass(frozen=True)
class VNState:
    mean: torch.Tensor  # (..., (n+m)*d)
    cov: torch.Tensor  # (..., (n+m)*d, (n+m)*d)


def _map_mean(pmf_state: PMFState) -> torch.Tensor:
    """vec(U, V) of the MAP factors, (..., (n+m)*d)."""
    return torch.cat([pmf_state.U.flatten(-2), pmf_state.V.flatten(-2)], -1)


def initialize_approx(
    pmf_state: PMFState, cfg: VNConfig, noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> VNState:
    """Mean at the MAP values, covariance the PSD projection of 2 * noise
    (reference: active_pmf.initialize_approx :190-200).

    ``noise`` (..., K, K) standard normals, one matrix a lane: given (the
    tests hand in the JAX package's lane noise), else drawn from
    ``generator``."""
    mean = _map_mean(pmf_state)
    k = mean.shape[-1]
    if noise is None:
        noise = torch.randn(mean.shape[:-1] + (k, k), generator=generator,
                            dtype=mean.dtype, device=mean.device)
    return VNState(mean=mean,
                   cov=project_psd(2.0 * noise.to(mean.dtype), cfg.min_eig))


def kl_divergence(
    vn: VNState, pmf_state: PMFState, problem: Problem, cfg: VNConfig,
    mean: Optional[torch.Tensor] = None, cov: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """KL(approximation || PMF model) up to an additive constant, one value
    a lane (reference: active_pmf.kl_divergence :202-240)."""
    mean = vn.mean if mean is None else mean
    cov = vn.cov if cov is None else cov
    n, m = problem.shape
    d = cfg.latent_d

    pred_mean, pred_var = vn_pred_mean_var(mean, cov, n, m, d)
    r = problem.R_obs
    data = torch.where(problem.rated,
                       pred_mean ** 2 + pred_var - 2.0 * r * pred_mean + r * r,
                       0.0).sum(dim=(-2, -1))
    div = data / (2 * pmf_state.sigma_sq)

    nd = n * d
    diag = torch.diagonal(cov, dim1=-2, dim2=-1)
    div = div + ((mean[..., :nd] ** 2).sum(-1) + diag[..., :nd].sum(-1)) / (
        2 * pmf_state.sigma_u_sq)
    div = div + ((mean[..., nd:] ** 2).sum(-1) + diag[..., nd:].sum(-1)) / (
        2 * pmf_state.sigma_v_sq)
    return div - torch.linalg.slogdet(cov).logabsdet / 2


def _tri_symmetrize(g: torch.Tensor) -> torch.Tensor:
    """The reference's triangular-half gradient convention: off-diagonals
    doubled (G + G^T), diagonal kept."""
    return g + g.mT - torch.diag_embed(torch.diagonal(g, dim1=-2, dim2=-1))


def _value_and_grad(value_fn, x: Tuple[torch.Tensor, ...]):
    """(value, gradients) of ``value_fn`` at x by autograd: the gradient of
    the lanes' summed value is each lane's own."""
    with torch.enable_grad():
        leaves = tuple(t.detach().requires_grad_() for t in x)
        f = value_fn(leaves)
        grads = torch.autograd.grad(f.sum(), leaves)
    return f.detach(), grads


def _descent(x0, value_and_grad_fn, step_fn, cfg, max_steps):
    return adaptive_descent(
        x0, value_and_grad_fn, step_fn, lr0=cfg.learning_rate,
        stop_thresh=cfg.stop_thresh, min_lr=cfg.min_lr, max_steps=max_steps)


def fit_normal(
    vn: VNState, pmf_state: PMFState, problem: Problem, cfg: VNConfig,
    max_steps: Optional[int] = None,
) -> Tuple[VNState, DescentInfo]:
    """Gradient descent on the KL with adaptive LR + PSD projection
    (reference: active_pmf.fit_normal_kls :251-288), every lane its own."""
    max_steps = cfg.max_fit_steps if max_steps is None else max_steps
    if cfg.cov_param == "chol":
        return _fit_normal_chol(vn, pmf_state, problem, cfg, max_steps)
    if cfg.cov_param != "psd-project":
        raise ValueError(f"unknown cov_param {cfg.cov_param!r}")

    def value_and_grad_fn(x):
        f, (gm, gc) = _value_and_grad(
            lambda t: kl_divergence(vn, pmf_state, problem, cfg, *t), x)
        return f, (gm, _tri_symmetrize(gc))

    def step_fn(x, g, lr):
        return (x[0] - _bcast(lr, x[0]) * g[0],
                project_psd(x[1] - _bcast(lr, x[1]) * g[1], cfg.min_eig))

    (mean, cov), info = _descent((vn.mean, vn.cov), value_and_grad_fn,
                                 step_fn, cfg, max_steps)
    return VNState(mean=mean, cov=cov), info


def _fit_normal_chol(vn, pmf_state, problem, cfg, max_steps):
    """KL descent on a lower-triangular L with cov = L L^T + min_eig I
    (VNConfig cov_param="chol"): every proposal is PSD by construction.

    Same KL objective as the projected descent; a different trajectory.
    The state keeps the plain (mean, cov) layout: one Cholesky at entry
    (a tiny jitter keeps it safe in float32), one L L^T at exit.
    """
    k = vn.cov.shape[-1]
    eye = torch.eye(k, dtype=vn.cov.dtype, device=vn.cov.device)
    trace = torch.diagonal(vn.cov, dim1=-2, dim2=-1).sum(-1)
    L0 = cholesky_or_nan(vn.cov + (1e-6 * trace / k)[..., None, None] * eye)

    def cov_of(L):
        Lt = torch.tril(L)
        return Lt @ Lt.mT + cfg.min_eig * eye

    def value_and_grad_fn(x):
        return _value_and_grad(
            lambda t: kl_divergence(vn, pmf_state, problem, cfg, t[0],
                                    cov_of(t[1])), x)

    def step_fn(x, g, lr):
        # the gradient through tril is zero above the diagonal
        return tuple(a - _bcast(lr, a) * b for a, b in zip(x, g))

    (mean, L), info = _descent((vn.mean, L0), value_and_grad_fn, step_fn,
                               cfg, max_steps)
    return VNState(mean=mean, cov=cov_of(L)), info


# ---------------------------------------------------------------------------
# Predictive quantities consumed by criteria


def approx_pred_means_vars(vn: VNState, problem: Problem, cfg: VNConfig
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., n, m) predictive mean and variance matrices
    (reference: active_pmf.approx_pred_means_vars :301-322, batched)."""
    n, m = problem.shape
    return vn_pred_mean_var(vn.mean, vn.cov, n, m, cfg.latent_d)


def approx_pred_covs(vn: VNState, problem: Problem,
                     cfg: VNConfig) -> torch.Tensor:
    """(..., n*m, n*m) prediction covariance
    (reference: active_pmf.approx_pred_covs :324-390, batched)."""
    n, m = problem.shape
    return vn_pred_covs(vn.mean, vn.cov, n, m, cfg.latent_d)


def approx_entropy(vn: VNState) -> torch.Tensor:
    """log-det entropy of the approximation, up to constants
    (reference: active_pmf._approx_entropy :526-530)."""
    return torch.linalg.slogdet(vn.cov).logabsdet


def mean_meandiff(vn: VNState, pmf_state: PMFState) -> torch.Tensor:
    return (vn.mean - _map_mean(pmf_state)).abs().mean(-1)
