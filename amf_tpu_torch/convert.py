"""State conversion between the JAX package's field layout and the port's.

The JAX package keeps its state in flax dataclasses and NamedTuples; the
port keeps the same fields, under the same names, as tensors. Here each
port type is built from a source that holds those fields as arrays: a
mapping keyed by the JAX field names, or any object with those attributes
(a JAX state itself works, read through ``numpy.asarray``, so this module
never imports JAX). ``to_numpy`` goes back the other way, so both packages
can start from identical parameters. ``device`` None means the card
(``utils.platform.resolve_device``); the CPU is named.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from amf_tpu_torch.models.bpmf_gibbs import ChainState, PredStats
from amf_tpu_torch.models.bpmf_hmc import BPMFState
from amf_tpu_torch.models.mmmf import MaxNormState, MMMFState
from amf_tpu_torch.models.mnormal import MNState
from amf_tpu_torch.models.newitems import NewItemsState
from amf_tpu_torch.models.pmf import PMFState
from amf_tpu_torch.models.ratingconc import RCData
from amf_tpu_torch.models.vnormal import VNState
from amf_tpu_torch.types import Problem
from amf_tpu_torch.utils.platform import resolve_device


def _field(src, name: str):
    return src[name] if isinstance(src, Mapping) else getattr(src, name)


def _tensor(x, device, dtype) -> Optional[torch.Tensor]:
    """A copy of array ``x`` on ``device``; floats cast to ``dtype``."""
    if x is None:
        return None
    t = torch.as_tensor(np.array(x), device=device)
    if t.is_floating_point() and dtype is not None:
        t = t.to(dtype)
    return t


def _build(cls, src, device, dtype):
    device = resolve_device(device)
    names = (cls._fields if hasattr(cls, "_fields")
             else [f.name for f in dataclasses.fields(cls)])
    return cls(**{k: _tensor(_field(src, k), device, dtype) for k in names})


def problem(src, device=None, dtype=None) -> Problem:
    """``Problem`` from R_obs, rated, queryable, test."""
    return _build(Problem, src, device, dtype)


def pmf_state(src, device=None, dtype=None) -> PMFState:
    """``PMFState`` from U, V, sigma_sq, sigma_u_sq, sigma_v_sq, mean_rating."""
    return _build(PMFState, src, device, dtype)


def chain_state(src, device=None, dtype=None) -> ChainState:
    """``ChainState`` from U, V, mean_rating."""
    return _build(ChainState, src, device, dtype)


def pred_stats(src, device=None, dtype=None) -> PredStats:
    """``PredStats`` from mean, var, prob_ge, bin_counts (may be None)."""
    return _build(PredStats, src, device, dtype)


def hmc_state(src, device=None, dtype=None) -> BPMFState:
    """``BPMFState`` (NUTS BPMF) from mode_q, mode_lp, mean_rating,
    adapt_eps, adapt_inv_mass."""
    return _build(BPMFState, src, device, dtype)


def rc_state(x, data, device=None, dtype=None
             ) -> Tuple[torch.Tensor, RCData]:
    """The maxent multipliers ``x`` and their ``RCData`` (from F, prior,
    log_prior, mu, nu, alpha, beta, c, d, qmask)."""
    return (_tensor(x, resolve_device(device), dtype),
            _build(RCData, data, device, dtype))


def newitems_state(src, device=None, dtype=None) -> NewItemsState:
    """``NewItemsState`` (cold-start BPMF) from mode_q, mode_lp,
    mean_rating, U_fixed, V_fixed."""
    return _build(NewItemsState, src, device, dtype)


def vn_state(src, device=None, dtype=None) -> VNState:
    """``VNState`` from mean, cov."""
    return _build(VNState, src, device, dtype)


def mn_state(src, device=None, dtype=None) -> MNState:
    """``MNState`` from mean, cov_useritems, cov_latents."""
    return _build(MNState, src, device, dtype)


def mmmf_state(src, device=None, dtype=None) -> MMMFState:
    """``MMMFState`` (the ADMM variables) from X, Z, W."""
    return _build(MMMFState, src, device, dtype)


def maxnorm_state(src, device=None, dtype=None) -> MaxNormState:
    """``MaxNormState`` (the max-norm factors) from U, V."""
    return _build(MaxNormState, src, device, dtype)


def to_numpy(state) -> Dict[str, Optional[np.ndarray]]:
    """The fields of any port state as numpy arrays, keyed by field name."""
    if hasattr(state, "_fields"):
        items = state._asdict().items()
    else:
        items = ((f.name, getattr(state, f.name))
                 for f in dataclasses.fields(state))
    return {k: None if v is None else v.detach().cpu().numpy()
            for k, v in items}
