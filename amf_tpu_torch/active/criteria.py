"""Selection-criterion registry for the variational-PMF models
(mirrors ``amf_tpu/active/criteria.py``).

CLI-name parity with the reference registries ``KEY_FUNCS``
(python-pmf/active_pmf.py:901-923 and mn_active_pmf.py:897-919). Each
criterion is either:

  * ``direct``: one batched (n, m) scoring pass over the current state, or
  * ``lookahead``: a statistic of the refit model under each hypothesized
    (candidate, rating value), integrated over the predictive distribution
    (the reference's ``_exp_with_rij``, active_pmf.py:635-704), here tiles
    of lanes in lockstep (``active.lookahead``).

Intentionally replicated quirk: the reference passes the predictive
*variance* as scipy's ``scale`` (a standard deviation) in ``_prob_ge_cutoff``
(active_pmf.py:432-439) and ``_last_step_lookahead_helper`` (:492-500); so
does this registry, so criterion maps are comparable.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from amf_tpu_torch.ops.quadrature import norm_sf


class Criterion(NamedTuple):
    name: str
    nice_name: str
    maximize: bool
    needs_approx: bool  # reference decorator: do_normal_fit
    kind: str  # 'direct' | 'lookahead'
    stat: Optional[str] = None  # lookahead statistic name
    use_map: bool = True  # lookahead expectation under MAP vs approx
    cutoff: Optional[float] = None


def _c(*args, **kw):
    return Criterion(*args, **kw)


KEY_FUNCS = {
    "random": _c("random", "Random", True, False, "direct"),
    "pred": _c("pred", "Pred Mag", True, False, "direct"),
    "pred-variance": _c("pred-variance", "Pred Variance", True, True, "direct"),
    "prob-ge-3.5": _c("prob-ge-3.5", "Prob >= 3.5", True, True, "direct", cutoff=3.5),
    "prob-ge-.5": _c("prob-ge-.5", "Prob >= .5", True, True, "direct", cutoff=0.5),
    "total-variance": _c(
        "total-variance", "E[Pred Total Variance] (MAP)", False, True,
        "lookahead", stat="total-variance", use_map=True,
    ),
    "total-variance-approx": _c(
        "total-variance-approx", "E[Pred Total Variance] (Approx)", False, True,
        "lookahead", stat="total-variance", use_map=False,
    ),
    "uv-entropy": _c(
        "uv-entropy", "E[U/V Entropy] (MAP)", False, True,
        "lookahead", stat="uv-entropy", use_map=True,
    ),
    "uv-entropy-approx": _c(
        "uv-entropy-approx", "E[U/V Entropy] (Approx)", False, True,
        "lookahead", stat="uv-entropy", use_map=False,
    ),
    "pred-entropy-bound": _c(
        "pred-entropy-bound", "E[Pred Entropy Bound] (MAP)", False, True,
        "lookahead", stat="pred-entropy-bound", use_map=True,
    ),
    "pred-entropy-bound-approx": _c(
        "pred-entropy-bound-approx", "E[Pred Entropy Bound] (Approx)", False, True,
        "lookahead", stat="pred-entropy-bound", use_map=False,
    ),
    "1step-ge-3.5": _c(
        "1step-ge-3.5", "1 step >= 3.5 (MAP)", True, True,
        "lookahead", stat="1step-ge", use_map=True, cutoff=3.5,
    ),
    "1step-ge-3.5-approx": _c(
        "1step-ge-3.5-approx", "1 step >= 3.5 (Approx)", True, True,
        "lookahead", stat="1step-ge", use_map=False, cutoff=3.5,
    ),
    "1step-ge-.5": _c(
        "1step-ge-.5", "1 step >= .5 (MAP)", True, True,
        "lookahead", stat="1step-ge", use_map=True, cutoff=0.5,
    ),
    "1step-ge-.5-approx": _c(
        "1step-ge-.5-approx", "1 step >= .5 (Approx)", True, True,
        "lookahead", stat="1step-ge", use_map=False, cutoff=0.5,
    ),
}

# The matrix-normal model supports the same set minus pred-entropy-bound
# (commented out in the reference, mn_active_pmf.py:907-908).
MN_KEY_FUNCS = {
    k: v for k, v in KEY_FUNCS.items() if not k.startswith("pred-entropy-bound")
}


def direct_scores(
    crit: Criterion,
    pred_matrix: torch.Tensor,
    approx_mean_var,
    generator: Optional[torch.Generator],
) -> torch.Tensor:
    """Score every cell for a 'direct' criterion in one pass.

    pred_matrix: MAP predictions (n, m); approx_mean_var: (mean, var) pair of
    (n, m) matrices from the approximation (or None for criteria that don't
    need it); ``generator`` draws the 'random' scores.
    """
    if crit.name == "random":
        return torch.rand(pred_matrix.shape, generator=generator,
                          dtype=pred_matrix.dtype, device=pred_matrix.device)
    if crit.name == "pred":
        return pred_matrix
    mean, var = approx_mean_var
    if crit.name == "pred-variance":
        return var
    if crit.cutoff is not None:
        # sf with scale=variance — reference quirk, see module docstring
        return norm_sf(crit.cutoff, mean, var.clamp(min=1e-30))
    raise ValueError(f"unknown direct criterion {crit.name}")
