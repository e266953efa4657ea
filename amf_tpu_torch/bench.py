"""The port's benchmark: the counterpart of the JAX package's ``bench.py``.

    python -m amf_tpu_torch.bench                # on the card
    python -m amf_tpu_torch.bench --device cpu   # on the host, named

Prints ONE JSON line with ``bench.py``'s keys (``bench.py:387-403``) and one
more, ``device``: the card's name and power limit as ``nvidia-smi`` gives
them. Its rows, at ``bench.py``'s constants (``Workload``):

  * the headline, Gibbs ``exp-variance`` at the MovieLens-100k shape (943 x
    1682, ~5 % known, d = 10, ratings 1..5): per (candidate, value) lane a
    MAP refit and a fresh 30-sample Gibbs chain (the Cholesky
    solve-and-sample kernel, fed from the masked Gram products, draws every
    row), 256 candidates in tiles of 32. ``value`` is candidates/s over 8
    tiles after a warm one, the host clock around work that ends in
    ``torch.cuda.synchronize()``; ``device_only_scores_per_sec`` is a
    tile's candidates over half the time 3 tiles take beyond 1 tile;
  * the pool baseline: ``multiprocessing.Pool`` (``spawn``) of
    ``min(cpu_count, 16)`` processes, one numpy Gibbs lane each
    (``bench_pool``), lanes/s over 5 values; ``vs_baseline`` = ``value`` /
    that;
  * the vn ``total-variance`` lookahead with approximation refits on 24 x
    24, d = 2, both covariance parametrisations, in host tiles of 64;
  * the PMF-refit row: 1,024 candidates in tiles of 128, 8 steps, the
    lane-blocked bf16 value+gradient kernel; on the card only (``null`` on
    the CPU, as in ``bench.py``).

A secondary row that raises is recorded under ``secondary_bench_faults``; the
headline raising ends the run with a non-zero exit. A row whose scores are
not all finite raises. Without a card the bench raises unless ``--device
cpu`` is named; the CPU runs ``bench.py``'s host constants (``HOST``) and
no other shape.

This module imports numpy and the pool's module alone at import time, and
``torch`` inside its functions: a pool worker imports the main module, and
its start-up falls inside the pool's timed window.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import subprocess
import sys
import time
import traceback
from typing import Optional

import numpy as np

from amf_tpu_torch import bench_pool

VALS = (1.0, 2.0, 3.0, 4.0, 5.0)
# seeds of the port's streams: the headline's MAP init, base chain and lane
# tiles; the refit row's MAP init; the vn rows' MAP init (their
# approximation takes fold_in(VN_SEED, 1), tile t fold_in(VN_SEED, 2 + t))
HEAD_INIT_SEED, HEAD_CHAIN_SEED, HEAD_TILE_SEED = 1, 2, 3
REFIT_INIT_SEED, VN_SEED = 7, 0
# the pool's lanes end within this (a lane at the card's shape takes seconds
# to a minute); a pool whose workers fail to start replaces them forever
POOL_TIMEOUT_S = 900


@dataclasses.dataclass(frozen=True)
class Workload:
    """The bench's constants (``bench.py:29-42``, ``:184-256``)."""

    n: int = 943
    m: int = 1682
    d: int = 10
    known: float = 0.05 * 100000  # expected known cells (~5 %)
    n_cand: int = 256
    tile: int = 32  # candidates a tile (x 5 value lanes)
    base_samps: int = 128
    la_samps: int = 30
    pk_n_cand: int = 1024
    pk_tile: int = 128
    pk_steps: int = 8
    pk_lane_block: int = 8
    pk_block_rows: int = 256
    vn_n: int = 24
    vn_d: int = 2
    vn_mask: float = 0.2
    vn_pmf_steps: int = 200
    vn_fit_steps: int = 100
    vn_refit_steps: int = 50
    vn_nodes: int = 8
    vn_tile: int = 64

    def describe(self) -> str:
        return (f"{self.n}x{self.m} d={self.d} 5-value lookahead, "
                f"{self.la_samps}-sample chains")


CARD = Workload()
# bench.py's host constants (bench.py:334-338), run only when the CPU is named
HOST = dataclasses.replace(CARD, n=189, m=336, n_cand=8, tile=8,
                           base_samps=64, pk_n_cand=128)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device):
    """(fn(), host seconds around it, ending in a synchronize)."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def _all_finite(scores, row: str) -> None:
    """A rate over a non-finite score is no result."""
    import torch

    bad = int((~torch.isfinite(scores)).sum())
    if bad:
        raise RuntimeError(
            f"{row}: {bad} of {scores.numel()} scores non-finite")


def make_problem(w: Workload, device):
    """``bench.py:340-352``: synthetic ratings of rank d, noise 0.5, ``known``
    cells known in expectation, rounded, shifted and clipped to 1..5; (real, known, Problem)."""
    import torch

    from amf_tpu_torch import types
    from amf_tpu_torch.data.synthetic import make_fake_data

    rng = np.random.default_rng(0)
    real, known, _ = make_fake_data(
        num_users=w.n, num_items=w.m, rank=w.d, noise=0.5,
        mask_type=w.known / (w.n * w.m), rng=rng)
    real = np.clip(np.round(real - real.mean() + 3.0), 1.0, 5.0)
    prob = types.problem_from_dense(real, known, dtype=torch.float32,
                                    device=device)
    return real, known, prob


def headline_cells(queryable: np.ndarray, n_cand: int) -> np.ndarray:
    """The headline's candidates: the first queryable flat cells."""
    return np.flatnonzero(np.asarray(queryable).ravel())[:n_cand]


def refit_cells(queryable: np.ndarray, n_cand: int) -> np.ndarray:
    """The refit row's candidates: a stable argsort of ~queryable."""
    return np.argsort(~np.asarray(queryable).ravel(), kind="stable")[:n_cand]


def gibbs_row(prob, w: Workload, device) -> dict:
    """The headline (``bench.py:111-163``): the MAP fit and base chain, one
    warm tile, the timed tiles, then 1 and 3 tiles for the device-only
    rate. Returns the rates, the timed tiles' scores, the count of tiles
    run and the state (pst, stats, pcfg, gcfg)."""
    import torch

    from amf_tpu_torch import types
    from amf_tpu_torch.models import bpmf_gibbs, pmf
    from amf_tpu_torch.utils.rng import fold_in, generator

    pcfg = pmf.PMFConfig(latent_d=w.d, subtract_mean=True)
    gcfg = bpmf_gibbs.GibbsConfig(latent_d=w.d, subtract_mean=True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    t0 = time.perf_counter()
    pst = pmf.init_state(generator(HEAD_INIT_SEED, device), w.n, w.m, pcfg,
                         prob, dtype=torch.float32, device=device)
    pst, _ = pmf.fit(pst, prob, pcfg)
    _, stats, _ = bpmf_gibbs.run_chain(
        bpmf_gibbs.init_chain(pst), prob, gcfg, w.base_samps,
        generator=generator(HEAD_CHAIN_SEED, device),
        value_bounds=tuple(types.rating_bounds(VALS)))
    _sync(device)
    setup_s = time.perf_counter() - t0
    cand = torch.as_tensor(headline_cells(prob.queryable.cpu().numpy(),
                                          w.n_cand), device=device)
    chunks = [cand[t:t + w.tile] for t in range(0, len(cand), w.tile)]

    def tile(seed, c):
        return bpmf_gibbs.exp_variance_scores(
            seed, pst, prob, pcfg, gcfg, stats, VALS, num_samps=w.la_samps,
            n_base_samples=w.base_samps, cand=c)

    warm, warm_s = _timed(lambda: tile(HEAD_TILE_SEED, chunks[0]), device)
    outs, tiles_s = _timed(
        lambda: [tile(HEAD_TILE_SEED, c) for c in chunks], device)
    # one tile, then three in a row, each under another seed (the stream
    # orders them; the same seed would repeat the lane streams): the
    # difference cancels the fixed cost of a timed call
    one, t1 = _timed(lambda: [tile(fold_in(HEAD_TILE_SEED, 0), chunks[0])],
                     device)
    three, t3 = _timed(lambda: [tile(fold_in(HEAD_TILE_SEED, r), chunks[0])
                                for r in range(3)], device)
    for s in (warm, *outs, *one, *three):
        _all_finite(s, "gibbs exp-variance")
    peak = (torch.cuda.max_memory_allocated(device) / 2**30
            if device.type == "cuda" else None)
    return dict(value=len(cand) / tiles_s,
                device_only=len(chunks[0]) / max((t3 - t1) / 2, 1e-9),
                setup_s=setup_s, warm_s=warm_s, tiles_s=tiles_s, t1_s=t1,
                t3_s=t3, tiles_run=2 + len(chunks) + 3, peak_mem_gib=peak,
                cand=cand, scores=outs, state=(pst, stats, pcfg, gcfg))


def pool_row(pst, prob, beta: float, cand, w: Workload,
             procs: Optional[int] = None) -> dict:
    """The pool baseline (``bench.py:164-181``): one (candidate, value) lane
    a process over the first ``procs`` candidates, timed from the map's
    call (the workers' start-up included) to its end."""
    U0 = pst.U.double().cpu().numpy()
    V0 = pst.V.double().cpu().numpy()
    rated = prob.rated.cpu().numpy()
    r_obs = prob.R_obs.double().cpu().numpy()
    procs = procs or min(multiprocessing.cpu_count(), 16)
    # one (cand, value) lane per task; a candidate costs len(VALS) lanes
    lanes = [(int(c) // w.m, int(c) % w.m, VALS[t % len(VALS)], t)
             for t, c in enumerate(np.asarray(cand.cpu())[:procs])]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(procs, initializer=bench_pool._pool_init,
                  initargs=(U0, V0, rated, r_obs, float(beta),
                            w.la_samps)) as pool:
        t0 = time.perf_counter()
        var = pool.map_async(bench_pool._pool_gibbs_lane, lanes).get(
            POOL_TIMEOUT_S)
        lane_s = time.perf_counter() - t0
    if not np.isfinite(var).all():
        raise RuntimeError(f"pool lanes non-finite: {var}")
    return dict(rate=len(lanes) / lane_s / len(VALS), procs=procs,
                lanes=len(lanes), s=lane_s, var=var)


def vn_problem(w: Workload, device, dtype=None, n: Optional[int] = None):
    """``bench.py:196-203``: a ``n`` x ``n`` problem (the workload's 24) of
    rank d, mask 0.2, from ``default_rng(1)``, and its PMF fit; (real,
    prob, pcfg, pst)."""
    import torch

    from amf_tpu_torch import types
    from amf_tpu_torch.data.synthetic import make_fake_data
    from amf_tpu_torch.models import pmf
    from amf_tpu_torch.utils.rng import generator

    n = w.vn_n if n is None else n
    dtype = torch.float32 if dtype is None else dtype
    rng = np.random.default_rng(1)
    real, known, _ = make_fake_data(num_users=n, num_items=n, rank=w.vn_d,
                                    mask_type=w.vn_mask, rng=rng)
    prob = types.problem_from_dense(real, known, dtype=dtype, device=device)
    pcfg = pmf.PMFConfig(latent_d=w.vn_d, max_fit_steps=w.vn_pmf_steps)
    pst = pmf.init_state(generator(VN_SEED, device), n, n, pcfg, prob,
                         dtype=dtype, device=device)
    pst, _ = pmf.fit(pst, prob, pcfg)
    return real, prob, pcfg, pst


def vn_approx(w: Workload, pst, prob, cov_param: str, device):
    """``bench.py:204-208``: the base approximation, a random covariance
    fit for ``vn_fit_steps``; (vcfg, ast)."""
    from amf_tpu_torch.models import vnormal
    from amf_tpu_torch.utils.rng import fold_in, generator

    vcfg = vnormal.VNConfig(latent_d=w.vn_d, max_fit_steps=w.vn_fit_steps,
                            cov_param=cov_param)
    ast = vnormal.initialize_approx(
        pst, vcfg, generator=generator(fold_in(VN_SEED, 1), device))
    return vcfg, vnormal.fit_normal(ast, pst, prob, vcfg)[0]


def vn_lookahead_config(w: Workload):
    """``bench.py:215-217``: refits of 50 + 50 steps, 8 nodes."""
    from amf_tpu_torch.active.lookahead import LookaheadConfig

    return LookaheadConfig(rating_values=(), refit_lookahead=True,
                           pmf_refit_steps=w.vn_refit_steps,
                           approx_refit_steps=w.vn_refit_steps,
                           n_integration_nodes=w.vn_nodes)


def vn_row(w: Workload, device, cov_param: str = "psd-project",
           cap: Optional[int] = None) -> dict:
    """A vn ``total-variance`` row (``bench.py:184-253``): every queryable
    cell (the first ``cap`` where given) in host tiles of ``vn_tile`` (of
    all the candidates where fewer), the tail padded with its last
    candidate; one warm tile, then every tile timed; the rate counts the
    real candidates."""
    import torch

    from amf_tpu_torch.active import criteria, lookahead
    from amf_tpu_torch.utils.rng import fold_in

    _, prob, pcfg, pst = vn_problem(w, device)
    vcfg, ast = vn_approx(w, pst, prob, cov_param, device)
    lcfg = vn_lookahead_config(w)
    crit = criteria.KEY_FUNCS["total-variance"]
    adapter = lookahead.vn_adapter(vcfg)
    cand_all = np.flatnonzero(prob.queryable.cpu().numpy().ravel())[:cap]
    n_cand = len(cand_all)
    if n_cand == 0:
        raise RuntimeError("vn bench: problem has no queryable cells")
    vt = min(w.vn_tile, n_cand)
    padded = np.concatenate([cand_all,
                             np.full((-n_cand) % vt, cand_all[-1])])
    tiles = [torch.as_tensor(padded[t:t + vt], device=device)
             for t in range(0, len(padded), vt)]

    def scores(seed, c):
        return lookahead.lookahead_scores(crit, pst, ast, prob, seed, pcfg,
                                          adapter, lcfg, cand=c)

    _, warm_s = _timed(lambda: scores(VN_SEED, tiles[0]), device)
    outs, s = _timed(lambda: [scores(fold_in(VN_SEED, 2 + t), c)
                              for t, c in enumerate(tiles)], device)
    got = torch.cat(outs)[:n_cand]
    _all_finite(got, f"vn {cov_param}")
    return dict(rate=n_cand / s, s=s, warm_s=warm_s, candidates=n_cand,
                tiles=len(tiles), tile=vt, scores=got,
                state=(prob, pcfg, pst, vcfg, ast, lcfg))


def refit_row(prob, w: Workload, device) -> dict:
    """The PMF-refit row (``bench.py:256-288``): a fitted MAP, the first
    ``pk_n_cand`` queryable cells at their predictions, tiles of
    ``pk_tile`` lanes refit ``pk_steps`` steps on the lane-blocked bf16
    value+gradient kernel; one warm sweep, then one timed."""
    import torch

    from amf_tpu_torch.models import pmf
    from amf_tpu_torch.utils.rng import generator

    pcfg = pmf.PMFConfig(latent_d=w.d, max_fit_steps=200)
    pst = pmf.init_state(generator(REFIT_INIT_SEED, device), w.n, w.m, pcfg,
                         prob, dtype=torch.float32, device=device)
    pst, _ = pmf.fit(pst, prob, pcfg)
    cand = torch.as_tensor(refit_cells(prob.queryable.cpu().numpy(),
                                       w.pk_n_cand), device=device)
    di, dj = cand // w.m, cand % w.m
    dv = (pst.U[di] * pst.V[dj]).sum(1)
    tiles = [slice(s, s + w.pk_tile) for s in range(0, len(cand), w.pk_tile)]

    def sweep():
        return torch.cat([pmf.fit_lookahead_batch(
            pst, prob, di[s], dj[s], dv[s], pcfg, max_steps=w.pk_steps,
            lane_block=w.pk_lane_block, block_rows=w.pk_block_rows,
            bf16=True)[2] for s in tiles])

    _, warm_s = _timed(sweep, device)
    neg_ll, s = _timed(sweep, device)
    _all_finite(neg_ll, "pmf refit")
    return dict(rate=len(cand) / s, s=s, warm_s=warm_s, tiles=len(tiles),
                neg_ll=neg_ll, state=(pst, pcfg), cells=(di, dj, dv))


def device_line(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them; the
    word ``cpu`` on the host."""
    if device.type != "cuda":
        return "cpu"
    import torch

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return (f"{torch.cuda.get_device_name(device)}, power limit not "
                f"read ({type(e).__name__})")


def _fault(faults: dict, key: str, e: Exception) -> None:
    traceback.print_exc(file=sys.stderr)
    faults[key] = f"{type(e).__name__}: {e}"[:200]


def run(w: Workload, device, psd_cap: Optional[int] = None,
        procs: Optional[int] = None):
    """Every row, then the line: (the line as a dict, each row's readings
    and state under "gibbs", "pool", "psd-project", "chol", "refit", and
    the headline's (real, known, Problem) under "problem").
    ``psd_cap`` cuts the psd-project row to its first candidates, in one
    tile; ``procs`` sets the pool's processes."""
    real, known, prob = make_problem(w, device)
    head = gibbs_row(prob, w, device)
    pst, _, _, gcfg = head["state"]
    pool = pool_row(pst, prob, gcfg.beta, head["cand"], w, procs)
    rows = {"problem": (real, known, prob), "gibbs": head, "pool": pool}
    # secondary rows never kill the headline's line (bench.py:360-385)
    faults, rates = {}, {}
    for key, cov_param, cap in (("vn_total_variance", "psd-project", psd_cap),
                                ("vn_total_variance_chol", "chol", None)):
        try:
            rows[cov_param] = vn_row(w, device, cov_param, cap)
            rates[key] = rows[cov_param]["rate"]
        except Exception as e:  # noqa: BLE001 (a device fault has any type)
            _fault(faults, key, e)
    # the refit row's rate is the kernel's: on the CPU the plain version
    # would stand in for it, so the row is null there (bench.py:376)
    if device.type == "cuda":
        try:
            rows["refit"] = refit_row(prob, w, device)
            rates["pmf_refit_kernel"] = rows["refit"]["rate"]
        except Exception as e:  # noqa: BLE001
            _fault(faults, "pmf_refit_kernel", e)

    def rounded(key):
        return round(rates[key], 2) if key in rates else None

    line = {
        "metric": "gibbs_exp_variance_scores_per_sec",
        "platform": device.type,
        "device": device_line(device),
        "value": round(head["value"], 2),
        "unit": "candidates/s",
        "vs_baseline": round(head["value"] / pool["rate"], 1),
        "baseline": "multiprocessing.Pool numpy Gibbs lanes, measured",
        "pool_procs": pool["procs"],
        "pool_scores_per_sec": round(pool["rate"], 4),
        "device_only_scores_per_sec": round(head["device_only"], 2),
        "workload": w.describe(),
        "vn_total_variance_scores_per_sec": rounded("vn_total_variance"),
        "vn_total_variance_chol_scores_per_sec":
            rounded("vn_total_variance_chol"),
        "pmf_refit_kernel_scores_per_sec": rounded("pmf_refit_kernel"),
        **({"secondary_bench_faults": faults} if faults else {}),
    }
    return line, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m amf_tpu_torch.bench",
        description="The port's benchmark: one JSON line.")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu "
                         "(bench.py's host constants, no refit row)")
    args = ap.parse_args(argv)
    from amf_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    line, _ = run(CARD if device.type == "cuda" else HOST, device)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
