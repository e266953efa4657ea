"""MMMF active-learning loop (mirrors ``amf_tpu/active/mmmf_loop.py``).

Capability parity with the reference's MATLAB driver
(mmmf/evaluate_active.m:1-91) and its Python bridge (mmmf/active_mmmf.py):
initial solve, per-selector query loop with a warm-started re-solve,
misclassification on the test set, results rows of
(num_known, misclass, [i,j], evals[, predictions]), on the shared driver
(``active/driver.drive_active``) with checkpoint/resume.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from amf_tpu_torch.active.driver import Family, drive_active
from amf_tpu_torch.models import mmmf
from amf_tpu_torch.types import Problem
from amf_tpu_torch.utils.checkpoint import LoopCheckpointer
from amf_tpu_torch.utils.platform import resolve_device
from amf_tpu_torch.utils.rng import fold_in, generator


def binarize(real: np.ndarray, cutoff: Optional[float]) -> np.ndarray:
    """Map ratings to +-1 labels via cutoff (reference: active_mmmf.py:55-61);
    data already in {-1, +1} passes through."""
    real = np.asarray(real, dtype=np.float64)
    vals = set(np.unique(real[np.isfinite(real) & (real != 0)]))
    if vals <= {-1.0, 1.0}:
        return real
    if cutoff is None:
        raise ValueError("non-binary data needs --cutoff")
    out = np.where(real >= cutoff, 1.0, -1.0)
    out[~np.isfinite(real) | (real == 0)] = 0.0
    return out


def run_active_mmmf(
    problem: Problem,
    y_real: np.ndarray,  # +-1/0 full label matrix (0 = unknowable)
    key_names: Sequence[str],
    C: float = 1.0,
    steps: Optional[int] = None,
    seed: int = 0,
    cfg: Optional[mmmf.MMMFConfig] = None,
    mode: str = "avg",  # 'avg' = nuclear norm (solveD 'a'), 'max' = max-norm
    dtype=torch.float64,
    device=None,
    keep_predictions: bool = False,
    verbose: bool = False,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 20,
) -> Dict[str, object]:
    """Multi-selector MMMF active loop; returns the results dict (``_real``,
    ``_rating_vals`` and one record list per selector).

    ``avg`` warm-starts every ADMM re-solve from the step before; ``max``
    draws its initial factors from a generator seeded with
    ``fold_in(seed, 7)`` and warm-starts the subgradient descent after.
    The error is the test misclassification, ``sign(0)`` counted wrong,
    over ``max(#test, 1)`` cells. ``keep_predictions`` appends the learned
    X to every record (mmmf/evaluate_active.m:82). ``device``: the card by
    default; without one that raises.
    """
    for k in key_names:
        if k not in mmmf.MMMF_KEYS:
            raise ValueError(f"unknown MMMF selector {k!r}")
    cfg = cfg or mmmf.MMMFConfig(C=C)
    device = resolve_device(device)
    problem = problem.to(device=device, dtype=dtype)
    y_real_t = torch.as_tensor(np.asarray(y_real, dtype=np.float64),
                               device=device).to(dtype)

    if mode == "max":
        mcfg = mmmf.MaxNormConfig(C=cfg.C, max_iters=cfg.max_iters)

        def solve_for(rated, state):
            y_tr = torch.where(rated, y_real_t, 0.0)
            return mmmf.solve_maxnorm(
                y_tr, mcfg, state, generator=generator(fold_in(seed, 7),
                                                       device))[0]
    else:

        def solve_for(rated, state):
            y_tr = torch.where(rated, y_real_t, 0.0)
            return mmmf.solve(y_tr, cfg, state)[0]

    def misclass(X, test):
        wrong = torch.sign(X) != y_real_t
        cnt = torch.clamp(test.sum(), min=1)
        return (test & wrong).sum().to(dtype) / cnt

    st0 = solve_for(problem.rated, None)

    results: Dict[str, object] = {
        "_real": np.asarray(y_real),
        "_rating_vals": (-1.0, 1.0),
    }

    # reference analogue: partial_results.mat saved every 20 steps mid-run
    # (mmmf/evaluate_active.m:84-86)
    ckpt = LoopCheckpointer.for_problem(
        checkpoint_path, problem, y_real, every=checkpoint_every,
        era=mmmf.SOLVER_ERA)

    family = Family(
        nice_name=lambda kname: kname,
        score=lambda kname, st, prob, k: mmmf.selector_evals(
            kname, st.X, prob.queryable, generator(k, device)),
        refit=lambda st, prob, k: solve_for(prob.rated, st),  # warm start
        err=lambda st, prob: misclass(st.X, prob.test),
        extra=((lambda st: (st.X.cpu().numpy(),)) if keep_predictions
               else None),
    )
    results.update(
        drive_active(problem, y_real, key_names, family, st0, seed,
                     steps=steps, ckpt=ckpt, verbose=verbose))
    return results
