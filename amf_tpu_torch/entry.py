"""The flagship step of the port (mirrors ``__graft_entry__.entry()``) and
its sharded dry run (``dryrun_multichip``).

    step, (pst, ast, prob) = entry()       # on the card; entry("cpu")
    scores = step(pst, ast, prob)

One batched pred-variance scoring pass of the variational active-PMF
model: a budgeted PMF MAP refit, a budgeted KL refit of the full-covariance
approximation, the all-pairs predictive variances, -inf off the query pool.
The data, configurations and budgets are those of the JAX package's entry;
its random initial factors and covariance come from the port's generators.
"""

from __future__ import annotations

import numpy as np
import torch

from amf_tpu_torch import types
from amf_tpu_torch.data.synthetic import make_fake_data
from amf_tpu_torch.models import pmf, vnormal
from amf_tpu_torch.utils.platform import resolve_device
from amf_tpu_torch.utils.rng import fold_in, generator

PCFG = pmf.PMFConfig(latent_d=3, max_fit_steps=100)
VCFG = vnormal.VNConfig(latent_d=3, max_fit_steps=30)
STEP_FIT_STEPS = 30


def step(pst: pmf.PMFState, ast: vnormal.VNState,
         prob: types.Problem) -> torch.Tensor:
    """One scoring pass -> (n, m) predictive variances, -inf off the pool."""
    pst, _ = pmf.fit(pst, prob, PCFG, max_steps=STEP_FIT_STEPS)
    ast, _ = vnormal.fit_normal(ast, pst, prob, VCFG,
                                max_steps=STEP_FIT_STEPS)
    _, pred_var = vnormal.approx_pred_means_vars(ast, prob, VCFG)
    return torch.where(prob.queryable, pred_var, -torch.inf)


def entry(device=None, dtype=torch.float32):
    """(step, (pst, ast, prob)) on ``device`` (None: the card)."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    real, known, _ = make_fake_data(num_users=16, num_items=12, rank=3,
                                    mask_type=0.3, rng=rng)
    prob = types.problem_from_dense(real, known, dtype=dtype, device=device)
    seed = 0
    pst = pmf.init_state(generator(seed, device), *prob.shape, PCFG, prob,
                         dtype=dtype, device=device)
    pst, _ = pmf.fit(pst, prob, PCFG)
    ast = vnormal.initialize_approx(pst, VCFG,
                                    generator=generator(fold_in(seed, 1),
                                                        device))
    return step, (pst, ast, prob)


def dryrun_multichip(n_devices: int, device=None, backend=None):
    """One sharded active step and every sharded lookahead family on
    ``n_devices`` ranks, one a card (``parallel/dryrun.run_dryrun``; on
    ``device="cpu"`` gloo processes). Returns rank 0's results."""
    from amf_tpu_torch.parallel.dryrun import run_dryrun

    return run_dryrun(n_devices, device=device, backend=backend)
