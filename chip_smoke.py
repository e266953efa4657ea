#!/usr/bin/env python3
"""Smoke run of the PyTorch port (amf_tpu_torch) on one CUDA card.

Drives the port's main path once — the Gibbs BPMF ``exp-variance`` one-step
lookahead and its active loop — at the MovieLens-100k shape of the JAX
package's ``bench.py`` (943 x 1682, d=10, ratings 1..5, a 128-sample base
chain, 30-sample lane chains, 32 candidates x 5 values = 160 lanes a tile),
and checks every hand-written kernel of that path against its plain
PyTorch version on the card.

    python3 chip_smoke.py

Phases (each raises on failure):
  1. environment and kernel build (nvcc, at first use, into build/);
  2. kernel vs plain version at the main path's batch sizes and at other d;
  3. the f32 lookahead tile: finite scores, kernel launched, plain unused;
  4. the active loop (run_active_gibbs), 3 records on a 64-cell pool;
  5. the same tile in f64 through the kernel and through the plain version.
The launch counts are reset before phase 3 and read after phase 4. The
line before the last is the kernels' JSON; the last line is
{"ok": true, "device": {...}}. With no CUDA device, or without the package
beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N, M, D = 943, 1682, 10
VALS = (1.0, 2.0, 3.0, 4.0, 5.0)
BASE_SAMPS, LA_SAMPS, TILE, FIT_BUDGET = 128, 30, 32, 200
POOL, LOOP_STEPS = 64, 3
# kernel vs plain version: |kernel - plain| <= TOL * (1 + |plain|). The two
# differ only in rounding (one forward + one back substitution against two
# back substitutions); the bound allows ~1e3 ulp-scaled error at the
# condition numbers of the chain-like matrices below.
KERNEL_TOL = {"float32": 1e-4, "float64": 1e-10}
# f64 lookahead through the kernel vs through the plain version, relative
SCORE_RTOL_F64 = 1e-8


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def chain_like_spd(B, d, dtype, gen, device):
    """B SPD matrices alpha + beta * Gram, built like the chain's: a
    Wishart-like prior precision plus beta times a Gram of 32 factor rows."""
    import torch

    A = torch.randn(B, d, d, generator=gen, dtype=dtype, device=device)
    W = torch.randn(B, 32, d, generator=gen, dtype=dtype, device=device)
    eye = torch.eye(d, dtype=dtype, device=device)
    return A @ A.mT / d + 0.5 * eye + 2.0 * (W.mT @ W)


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def kernel_rows(device):
    import torch
    from amf_tpu_torch.ops import chol_kernel as ck

    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    cases = [(150880, 10), (269120, 10), (4097, 1), (4097, 5), (4097, 20),
             (4097, 32)]
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        for B, d in cases:
            S = chain_like_spd(B, d, dtype, gen, device)
            rhs = torch.randn(B, d, generator=gen, dtype=dtype, device=device)
            z = torch.randn(B, d, generator=gen, dtype=dtype, device=device)
            got = ck.chol_solve_sample_cuda(S, rhs, z)
            want = ck.chol_solve_sample_reference(S, rhs, z)
            torch.cuda.synchronize()
            diff = (got - want).abs()
            max_abs = diff.max().item()
            scaled = (diff / (1 + want.abs())).max().item()
            ms = cuda_ms(lambda: ck.chol_solve_sample_cuda(S, rhs, z), 20)
            plain_ms = cuda_ms(
                lambda: ck.chol_solve_sample_reference(S, rhs, z), 5)
            # the launch alone, on buffers already in the kernel's layout
            s_t = S.reshape(B, d * d).t().contiguous()
            rhs_t, z_t = rhs.t().contiguous(), z.t().contiguous()
            launch_ms = cuda_ms(
                lambda: ck.chol_solve_sample_batch_minor(s_t, rhs_t, z_t), 20)
            row = dict(dtype=name, B=B, d=d, max_abs_err=max_abs,
                       scaled_err=scaled, tol=KERNEL_TOL[name], ms=ms,
                       launch_only_ms=launch_ms, plain_ms=plain_ms)
            rows.append(row)
            print("kernel-check " + json.dumps(row), flush=True)
            check(math.isfinite(scaled) and scaled <= KERNEL_TOL[name],
                  f"kernel disagrees with plain version: {row}")
            del S, rhs, z, got, want, diff, s_t, rhs_t, z_t
    return rows


def main() -> int:
    if not (ROOT / "amf_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: amf_tpu_torch/ is not beside this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on a GPU and "
              "has no CPU fallback", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from amf_tpu_torch import types
    from amf_tpu_torch.active.gibbs_loop import run_active_gibbs
    from amf_tpu_torch.data.synthetic import make_fake_data
    from amf_tpu_torch.models import bpmf_gibbs, pmf
    from amf_tpu_torch.ops import chol_kernel as ck
    from amf_tpu_torch.utils.platform import resolve_device
    from amf_tpu_torch.utils.rng import generator

    # ---- 1. environment and build
    device = resolve_device("cuda")
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    ck._entry_points()
    print(f"kernel build+load s {time.perf_counter() - t0:.1f}", flush=True)

    # ---- 2. kernel vs plain version on the card
    kern = kernel_rows(device)
    main_row = next(r for r in kern if r["dtype"] == "float32"
                    and r["B"] == 269120)

    # ---- 3. the f32 lookahead tile at the bench shape
    rng = np.random.default_rng(0)
    real, known, _ = make_fake_data(
        num_users=N, num_items=M, rank=D, noise=0.5,
        mask_type=0.05 * 100000 / (N * M), rng=rng)
    real = np.clip(np.round(real - real.mean() + 3.0), 1.0, 5.0)
    prob = types.problem_from_dense(real, known, dtype=torch.float32,
                                    device=device)
    pcfg = pmf.PMFConfig(latent_d=D, subtract_mean=True)
    gcfg = bpmf_gibbs.GibbsConfig(latent_d=D, subtract_mean=True)
    bounds = tuple(types.rating_bounds(VALS))
    t0 = time.perf_counter()
    pst = pmf.init_state(generator(1, device), N, M, pcfg, prob,
                         dtype=torch.float32, device=device)
    pst, info = pmf.fit(pst, prob, pcfg)
    _, stats, _ = bpmf_gibbs.run_chain(
        bpmf_gibbs.init_chain(pst), prob, gcfg, BASE_SAMPS,
        generator=generator(2, device), value_bounds=bounds)
    torch.cuda.synchronize()
    print(f"MAP fit ({int(info.n_iters)} proposals) + {BASE_SAMPS}-sample "
          f"base chain s {time.perf_counter() - t0:.2f}", flush=True)
    cand = torch.nonzero(prob.queryable.flatten())[:TILE, 0]

    def tile(dtype_pst, dtype_prob, dtype_stats, kernel=True):
        return bpmf_gibbs.exp_variance_scores(
            3, dtype_pst, dtype_prob, pcfg, gcfg, dtype_stats, VALS,
            num_samps=LA_SAMPS, fit_budget=FIT_BUDGET, cand=cand,
            n_base_samples=BASE_SAMPS, poly_ls=True, chol_kernel=kernel)

    ck.chol_solve_sample_batch_minor.launches = 0
    ck.chol_solve_sample_reference.calls = 0
    tile_s = []
    for _ in range(2):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        scores = tile(pst, prob, stats)
        torch.cuda.synchronize()
        tile_s.append(time.perf_counter() - t0)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    la_launches = ck.chol_solve_sample_batch_minor.launches
    check(scores.shape == (TILE,), f"scores shape {tuple(scores.shape)}")
    check(bool(torch.isfinite(scores).all()), f"non-finite scores {scores}")
    check(bool((scores > 0).all()), f"non-positive scores {scores}")
    check(la_launches > 0, "the lookahead never launched the kernel")
    check(ck.chol_solve_sample_reference.calls == 0,
          "the plain version ran on the CUDA main path")
    print(json.dumps(dict(
        phase="lookahead_f32", lanes=TILE * len(VALS), tile_s=tile_s,
        candidates_per_s=TILE / tile_s[1], peak_mem_gib=peak_gib,
        kernel_launches=la_launches,
        scores_min=scores.min().item(), scores_max=scores.max().item())),
        flush=True)

    # ---- 4. the active loop on a 64-cell pool
    q = np.flatnonzero(prob.queryable.cpu().numpy().ravel())
    pool = np.zeros(N * M, bool)
    pool[rng.choice(q, size=POOL, replace=False)] = True
    pool = pool.reshape(N, M)
    prob_pool = types.problem_from_dense(real, known, queryable=pool,
                                         dtype=torch.float32, device=device)
    before = ck.chol_solve_sample_batch_minor.launches
    t0 = time.perf_counter()
    res = run_active_gibbs(
        prob_pool, real, ["exp-variance"], latent_d=D, rating_values=VALS,
        num_samps=BASE_SAMPS, lookahead_samps=LA_SAMPS, lookahead_tile=TILE,
        steps=LOOP_STEPS, seed=0, dtype=torch.float32, device=device,
        verbose=True)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    loop_launches = ck.chol_solve_sample_batch_minor.launches - before
    main_launches = ck.chol_solve_sample_batch_minor.launches
    plain_calls = ck.chol_solve_sample_reference.calls
    recs = res["exp-variance"]
    picks = [r[2] for r in recs[1:]]
    check(len(recs) == LOOP_STEPS, f"{len(recs)} records")
    check(all(math.isfinite(r[1]) for r in recs), f"RMSE {[r[1] for r in recs]}")
    check(len(set(picks)) == len(picks) and all(pool[p] for p in picks),
          f"picks {picks} not distinct or outside the pool")
    check(loop_launches > 0, "the active loop never launched the kernel")
    check(plain_calls == 0, "the plain version ran on the CUDA main path")
    print(json.dumps(dict(
        phase="active_loop_f32", records=len(recs), picks=picks,
        rmse=[r[1] for r in recs], loop_s=loop_s,
        s_per_scored_step_upper=loop_s / (LOOP_STEPS - 1),
        kernel_launches=loop_launches)), flush=True)

    # ---- 5. the same tile in f64, through the kernel and the plain version
    def f64(x):
        return x.double() if torch.is_tensor(x) and x.is_floating_point() else x

    pst64 = dataclasses.replace(pst, **{
        f.name: f64(getattr(pst, f.name)) for f in dataclasses.fields(pst)})
    stats64 = bpmf_gibbs.PredStats(*(None if x is None else f64(x)
                                     for x in stats))
    prob64 = prob.to(dtype=torch.float64)
    t0 = time.perf_counter()
    s_kernel = tile(pst64, prob64, stats64, kernel=True)
    torch.cuda.synchronize()
    t_kernel = time.perf_counter() - t0
    t0 = time.perf_counter()
    s_plain = tile(pst64, prob64, stats64, kernel=False)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    rel = ((s_kernel - s_plain).abs() / s_plain.abs()).max().item()
    print(json.dumps(dict(
        phase="lookahead_f64_kernel_vs_plain", max_rel_diff=rel,
        rtol=SCORE_RTOL_F64, tile_s_kernel=t_kernel, tile_s_plain=t_plain)),
        flush=True)
    check(bool(torch.isfinite(s_kernel).all()), "non-finite f64 scores")
    check(rel <= SCORE_RTOL_F64, f"f64 kernel vs plain scores differ by {rel}")

    print(json.dumps({"kernels": [{
        "name": "chol_solve_sample", "route": "cuda",
        "source": "amf_tpu_torch/csrc/chol_solve_sample.cu",
        "replaces": "amf_tpu/ops/chol_kernel.py:41",
        "launches": main_launches,
        "max_abs_err": max(r["max_abs_err"] for r in kern),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
