"""Sharded lookahead scoring over ranks (mirrors
``amf_tpu/parallel/sharding.py``).

The candidate axis of one-step lookahead is the scaling axis: each
candidate's refits are independent until the final argmax. So every rank
scores a contiguous shard of the candidate cells, and one all-gather gives
every rank the whole score vector, from which every rank takes the same
pick. Lane streams are keyed by the GLOBAL candidate index
(``utils/rng.lane_seeds``) and NUTS chain c draws from ``fold_in(seed, c)``,
so a partition changes no lane's result. This replaces the reference's
lock-guarded process pool (active_pmf.py:1064-1082).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from amf_tpu_torch.parallel.mesh import CandidateMesh
from amf_tpu_torch.utils import profiling


def shard_range(n_cells: int, size: int, rank: int) -> Tuple[int, int]:
    """[start, stop) of rank ``rank``'s shard of ``n_cells`` cells padded to
    a multiple of ``size`` (indices past ``n_cells - 1`` are padding)."""
    per = -(-n_cells // size)
    return rank * per, (rank + 1) * per


def sharded_candidate_scores(
    score_flat_fn: Callable[[torch.Tensor, int], torch.Tensor],
    n_cells: int,
    mesh: Optional[CandidateMesh],
    cand: Optional[torch.Tensor] = None,
) -> Callable[[int], torch.Tensor]:
    """Wrap a flat-candidate scorer for sharded execution.

    ``score_flat_fn(cand (C,), seed) -> (C,)`` scores, each candidate's
    independent of the others. ``cand`` are the flat cells to score
    (default ``arange(n_cells)``, as in the JAX package; the port's
    families pass their queryable cells). Returns ``run(seed) ->
    (n_cells,)`` scores, NaN off ``cand``.

    The cells are split into contiguous shards, padded to a multiple of
    the mesh size with copies of the last cell, and the padding is dropped
    after the gather. A rank whose share is all padding still scores and
    gathers. ``mesh`` None scores every cell in this process. A rank's
    scoring and its gather are the spans ``parallel.score`` and
    ``parallel.gather``, which wait for the device while tracing is on.
    """

    def run(seed: int) -> torch.Tensor:
        dev = mesh.device if mesh is not None else None
        c = (torch.arange(n_cells, device=dev) if cand is None
             else torch.as_tensor(cand, device=dev).long())
        if not c.numel():
            raise ValueError("no candidate cells to score")
        if mesh is None:
            scores = score_flat_fn(c, seed)
            out = torch.full((n_cells,), torch.nan, dtype=scores.dtype,
                             device=scores.device)
            out[c] = scores
            return out
        C = int(c.numel())
        start, stop = shard_range(C, mesh.size, mesh.rank)
        idx = torch.arange(start, stop, device=c.device).clamp_(max=C - 1)
        with profiling.span("parallel.score"):
            local = score_flat_fn(c[idx], seed)
            profiling.synchronize(local.device)
        with profiling.span("parallel.gather"):
            gathered = torch.cat(mesh.all_gather(local))[:C]
            profiling.synchronize(gathered.device)
        out = torch.full((n_cells,), torch.nan, dtype=local.dtype,
                         device=local.device)
        out[c] = gathered
        return out

    return run


def best_candidate(scores: torch.Tensor, queryable_flat: torch.Tensor,
                   maximize: bool) -> torch.Tensor:
    """The pick over gathered scores (the JAX package's ``best_candidate``;
    reference analogue: the chooser over pool.map results,
    active_pmf.py:729-737): argmax (argmin) over the queryable cells, a NaN
    among them taken first as numpy's and JAX's argmax take it, and the
    first queryable cell when the chosen score is not finite (the
    reference's selectors only see queryable cells, so they never pick off
    the pool)."""
    fill = -torch.inf if maximize else torch.inf
    masked = torch.where(queryable_flat, scores, fill)
    nan = torch.isnan(masked)
    if bool(nan.any()):
        best = torch.argmax(nan.to(torch.int8))
    else:
        best = torch.argmax(masked) if maximize else torch.argmin(masked)
    if bool(torch.isfinite(masked[best])):
        return best
    return torch.argmax(queryable_flat.to(torch.int8))


def _tree_gather(tree, mesh: CandidateMesh):
    """Each leaf gathered over the ranks, rank-major along dim 0."""
    if isinstance(tree, torch.Tensor):
        return torch.cat(mesh.all_gather(tree))
    if isinstance(tree, dict):
        return {k: _tree_gather(v, mesh) for k, v in tree.items()}
    fields = [_tree_gather(v, mesh) for v in tree]
    return type(tree)(*fields) if hasattr(tree, "_fields") else tuple(fields)


def sharded_chain_map(run_chains: Callable[[List[int]], object],
                      n_chains: int, mesh: Optional[CandidateMesh]):
    """Run ``n_chains`` independent chains with the chain axis split over the
    ranks (the JAX package's ``sharded_chain_map``; the reference's
    process-parallel Stan chains, stan-bpmf/bpmf.py:314).

    ``run_chains(chain_ids) -> tree`` runs the given chains as lanes of one
    lockstep run; every leaf of the tree has the chain axis first. Each
    rank runs its contiguous share and the leaves are gathered chain-major,
    so every rank returns what ``run_chains(range(n_chains))`` returns, up
    to the lanes' batching. ``n_chains`` must be a multiple of the mesh
    size. ``mesh`` None runs every chain here.
    """
    if mesh is None:
        return run_chains(list(range(n_chains)))
    if n_chains % mesh.size:
        raise ValueError(f"chains ({n_chains}) must be a multiple of the "
                         f"mesh size ({mesh.size})")
    start, stop = shard_range(n_chains, mesh.size, mesh.rank)
    return _tree_gather(run_chains(list(range(start, stop))), mesh)
