#!/usr/bin/env python3
"""Smoke run of the PyTorch port (amf_tpu_torch) on one CUDA card.

Drives the port's two main paths at the MovieLens-100k shape of the JAX
package's ``bench.py`` (943 x 1682, d=10, ratings 1..5) and checks every
hand-written kernel of them against its plain PyTorch version on the card:

  * the Gibbs BPMF ``exp-variance`` one-step lookahead and its active loop
    (a 128-sample base chain, 30-sample lane chains, 32 candidates x 5
    values = 160 lanes a tile), through the Cholesky solve-and-sample kernel;
  * the PMF-refit lookahead (``fit_lookahead_batch``, tiles of 128 lanes)
    and its ``add_rmse_boosts`` CLI, through the value+gradient kernel.

    python3 chip_smoke.py

Phases (each raises on failure):
  1. environment and kernel builds (one nvcc per source, in parallel, at
     first use, into build/);
  2. Cholesky kernel vs plain version at the main path's batch sizes and
     at other d;
  3. the f32 Gibbs lookahead tile: finite scores, kernel launched, plain
     unused;
  4. the active loop (run_active_gibbs), 3 records on a 64-cell pool;
  5. the same tile in f64 through the kernel and through the plain version;
  6. value+gradient kernel vs plain version, both layouts, f32 and bf16, at
     L=128 lanes and at ragged shapes, with times;
  7. the bench's lane-blocked refit: 1024 candidates in 8 tiles, bf16 and
     f32, and the f32 kernel tile vs the plain refit;
  8. the add_rmse_boosts CLI on a 256-cell pool (2 tiles, 200 refit steps).
The launch counts are reset before phases 3, 7 and 8 and read after phases
4, 7 and 8. The line before the last is the kernels' JSON; the last line is
{"ok": true, "device": {...}}. With no CUDA device, or without the package
beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pickle
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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
# value+gradient kernel vs plain version. The value to 1e-5 relative and
# the gradients to 1e-4 scaled (|k - p| / (1 + |p|)): both sum in float32,
# over ~1682 and ~943 terms, in different orders. The bf16 (L, d, rows)
# variant rounds the residual and the gradients to bf16 (8 mantissa bits):
# a residual or an output near a rounding boundary may round the other way
# in one of the two, which moves a gradient by up to ~2^-8 of its largest
# term; hence 2e-2 scaled there.
VG_TOL = {False: dict(val=1e-5, grad=1e-4), True: dict(val=1e-5, grad=2e-2)}
VG_LANES = 128
# the bench's PMF-refit row (bench.py:37-42, 256-288)
PK_N_CAND, PK_TILE, PK_REFIT_STEPS, PK_LANE_BLOCK = 1024, 128, 8, 8
# f32 kernel tile vs plain refit, as tests/test_pallas_kernels.py:219 holds
# the JAX paths
REFIT_RTOL = 1e-4
CLI_POOL, CLI_TILE = 256, 128
# the card's published peaks (H100 SXM data sheet, dense)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {"float32": 67e12, "bfloat16": 989e12}


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


def bound_ms(n_bytes: float, flops: float, dtype: str):
    """(least time in ms the card could take, what sets it)."""
    t_bytes = n_bytes / PEAK_BYTES_S
    t_ops = flops / PEAK_FLOPS_S[dtype]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def value_grad_case(pk, R, rated, L, d, bf16, transposed, gen, time_it):
    """Kernel vs plain version of one variant on random factors."""
    import torch

    dev = R.device
    n, m = R.shape
    io = torch.bfloat16 if bf16 else torch.float32
    U = 0.5 * torch.rand(L, n, d, generator=gen, device=dev)
    V = 0.5 * torch.rand(L, m, d, generator=gen, device=dev)
    di = torch.randint(0, n, (L,), generator=gen, device=dev)
    dj = torch.randint(0, m, (L,), generator=gen, device=dev)
    # a quarter of the lanes hypothesise a cell that is already rated
    on = torch.nonzero(rated)
    pick = torch.randint(0, len(on), (L // 4,), generator=gen, device=dev)
    di[:L // 4], dj[:L // 4] = on[pick, 0], on[pick, 1]
    dv = torch.randint(1, 6, (L,), generator=gen, device=dev).float()
    sig = torch.tensor([0.9, 10.0, 10.0], device=dev)
    if transposed:
        fn = pk.pmf_batched_value_grad_t
        U, V = U.mT.contiguous(), V.mT.contiguous()
    else:
        fn = pk.pmf_batched_value_grad
    args = (U.to(io), V.to(io), R.to(io), rated, di, dj, dv, sig)
    got = fn(*args, bf16=bf16)
    want = fn(*args, bf16=bf16, kernel=False)
    torch.cuda.synchronize()
    tol = VG_TOL[bf16 and transposed]
    val_err = ((got[0] - want[0]).abs() / want[0].abs()).max().item()
    grad_err = max(((g.float() - w.float()).abs() / (1 + w.float().abs()))
                   .max().item() for g, w in zip(got[1:], want[1:]))
    max_abs = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(got, want))
    row = dict(layout="L,d,rows" if transposed else "L,rows,d",
               dtype=str(io).split(".")[1], L=L, n=n, m=m, d=d,
               max_abs_err=max_abs, val_rel_err=val_err,
               grad_scaled_err=grad_err, tol=tol)
    if time_it:
        row["ms"] = cuda_ms(lambda: fn(*args, bf16=bf16), 20)
        row["plain_ms"] = cuda_ms(lambda: fn(*args, bf16=bf16, kernel=False),
                                  3)
        # what the data needs: the rated cells of every lane, plus the
        # lane's own cell where it is not rated; 3 d multiply-adds a cell
        cells = L * int(rated.sum()) + int((~rated[di, dj]).sum())
        isz = 2 if bf16 else 4
        osz = 2 if bf16 and transposed else 4
        n_bytes = (n * m * (isz + 1) + L * (n + m) * d * (isz + osz)
                   + L * 4 * 4)
        row["bound_ms"], row["bound_by"] = bound_ms(
            n_bytes, 6.0 * d * cells, row["dtype"])
    print("value-grad-check " + json.dumps(row), flush=True)
    check(math.isfinite(val_err) and val_err <= tol["val"]
          and math.isfinite(grad_err) and grad_err <= tol["grad"],
          f"value+grad kernel disagrees with plain version: {row}")
    return row


def value_grad_rows(device, R, rated):
    """Phase 6: every variant at the main path's shape, then ragged."""
    import torch
    from amf_tpu_torch.ops import pmf_kernels as pk

    gen = torch.Generator(device=device).manual_seed(6)
    variants = [(False, False), (False, True), (True, True), (True, False)]
    rows = [value_grad_case(pk, R, rated, VG_LANES, D, bf16, tr, gen, True)
            for bf16, tr in variants]
    small_R = torch.randint(1, 6, (37, 53), generator=gen,
                            device=device).float()
    small_rated = torch.rand(37, 53, generator=gen, device=device) < 0.3
    for d in (1, 5, 32):
        for bf16, tr in variants:
            rows.append(value_grad_case(pk, small_R, small_rated, 5, d, bf16,
                                        tr, gen, False))
    return rows


def device_split(fn, top=8):
    """torch.profiler over one call of ``fn``: wall ms, device-busy ms and
    the ``top`` device kernels by their own device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # device-side events only: a CPU op's own device time repeats its kernels'
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda r: -r[1])
    busy = sum(r[1] for r in kernels)
    return dict(wall_ms=wall_ms, device_busy_ms=busy,
                busy_share=busy / wall_ms,
                top=[dict(name=k[:80], ms=t, calls=c)
                     for k, t, c in kernels[:top]])


def spearman(a, b) -> float:
    import numpy as np

    ra = np.argsort(np.argsort(a)).astype(float)
    rb = np.argsort(np.argsort(b)).astype(float)
    return float(np.corrcoef(ra, rb)[0, 1])


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
    from amf_tpu_torch.data.loaders import save_npz_schema
    from amf_tpu_torch.ops import chol_kernel as ck
    from amf_tpu_torch.ops import cuda_build
    from amf_tpu_torch.ops import pmf_kernels as pk
    from amf_tpu_torch.run import add_rmse_boosts
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
    with ThreadPoolExecutor(2) as pool:  # one nvcc per source, together
        list(pool.map(cuda_build.build,
                      ["chol_solve_sample", "pmf_value_grad"]))
    ck._entry_points()
    pk._entry_point()
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

    # ---- 6. value+gradient kernel vs plain version, every variant
    vg = value_grad_rows(device, prob.R_obs, prob.rated)

    # ---- 7. the bench's lane-blocked PMF refit: 1024 candidates, 8 tiles
    rcfg = pmf.PMFConfig(latent_d=D, max_fit_steps=200)
    rst = pmf.init_state(generator(7, device), N, M, rcfg, prob,
                         dtype=torch.float32, device=device)
    rst, _ = pmf.fit(rst, prob, rcfg)
    cand = torch.nonzero(prob.queryable.flatten())[:PK_N_CAND, 0]
    di, dj = cand // M, cand % M
    dv = (rst.U[di] * rst.V[dj]).sum(1)
    tiles = [slice(s, s + PK_TILE) for s in range(0, PK_N_CAND, PK_TILE)]

    def refit(s, **kw):
        return pmf.fit_lookahead_batch(
            rst, prob, di[s], dj[s], dv[s], rcfg, max_steps=PK_REFIT_STEPS,
            **kw)[2]

    def sweep(bf16):
        return torch.cat([refit(s, lane_block=PK_LANE_BLOCK, block_rows=256,
                                bf16=bf16) for s in tiles])

    pk.pmf_value_grad_cuda.launches.clear()
    pk.pmf_value_grad_plain.calls = 0
    refit_rate, refit_f = {}, {}
    for bf16 in (True, False):
        sweep(bf16)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refit_f[bf16] = sweep(bf16)
        torch.cuda.synchronize()
        refit_rate[bf16] = PK_N_CAND / (time.perf_counter() - t0)
    refit_launches = dict(pk.pmf_value_grad_cuda.launches)
    check(pk.pmf_value_grad_plain.calls == 0,
          "the plain value+grad version ran on the refit path")
    for bf16 in (True, False):
        check(bool(torch.isfinite(refit_f[bf16]).all()),
              f"non-finite refit values (bf16={bf16})")
        key = ("L,d,rows", "torch.bfloat16" if bf16 else "torch.float32")
        check(refit_launches.get(key, 0) > 0,
              f"the refit never launched the kernel {key}")
    f_plain = refit(tiles[0], use_pallas=False)
    f_kern = refit_f[False][tiles[0]]
    rel = ((f_kern - f_plain).abs() / f_plain.abs()).cpu()
    for lane in torch.nonzero(rel > REFIT_RTOL)[:, 0].tolist():
        print(f"refit lane {lane}: kernel {f_kern[lane].item()!r} plain "
              f"{f_plain[lane].item()!r}", flush=True)
    f16, f32 = refit_f[True].cpu().numpy(), refit_f[False].cpu().numpy()
    print(json.dumps(dict(
        phase="pmf_refit_lane_block", candidates=PK_N_CAND, tile=PK_TILE,
        max_steps=PK_REFIT_STEPS,
        candidates_per_s_bf16=refit_rate[True],
        candidates_per_s_f32=refit_rate[False],
        kernel_launches={"/".join(k): v for k, v in refit_launches.items()},
        f32_kernel_vs_plain_max_rel=rel.max().item(), rtol=REFIT_RTOL,
        bf16_vs_f32_max_rel=float(np.max(np.abs(f16 - f32) / np.abs(f32))),
        bf16_vs_f32_spearman=spearman(f16, f32))), flush=True)
    check(rel.max().item() <= REFIT_RTOL,
          f"f32 refit kernel vs plain differ by {rel.max().item()}")

    # ---- 8. the add_rmse_boosts CLI on a 256-cell pool
    work = ROOT / "build" / "amf_tpu_torch" / "smoke"
    work.mkdir(parents=True, exist_ok=True)
    known_np = prob.rated.cpu().numpy()
    knowable = np.isfinite(real) & (real != 0)
    pool = np.zeros(N * M, bool)
    pool[rng.choice(np.flatnonzero(knowable & ~known_np), size=CLI_POOL,
                    replace=False)] = True
    pool = pool.reshape(N, M)
    data_path, out_path = work / "boosts_data.npz", work / "boosts.pkl"
    save_npz_schema(str(data_path), {"_real": real, "_known": known_np,
                                     "_test_on": knowable & ~known_np & ~pool})
    tile_log = []
    inner_tile_rmses = add_rmse_boosts.tile_rmses
    inner_descent = pmf.adaptive_descent

    def descent(*a, **kw):  # records the slowest lane's proposals
        x, info = inner_descent(*a, **kw)
        if tile_log:  # not the CLI's base fit
            tile_log[-1]["proposals"] = int(info.n_iters.max())
        return x, info

    def timed_tile(*a, **kw):
        tile_log.append({})
        t0 = time.perf_counter()
        out = inner_tile_rmses(*a, **kw)
        torch.cuda.synchronize()
        tile_log[-1]["s"] = time.perf_counter() - t0
        return out

    add_rmse_boosts.tile_rmses, pmf.adaptive_descent = timed_tile, descent
    pk.pmf_value_grad_cuda.launches.clear()
    pk.pmf_value_grad_plain.calls = 0
    try:
        t0 = time.perf_counter()
        add_rmse_boosts.main(["--load-data", str(data_path), "-D", str(D),
                              "--tile", str(CLI_TILE), "--out", str(out_path)])
        cli_s = time.perf_counter() - t0
    finally:
        add_rmse_boosts.tile_rmses = inner_tile_rmses
        pmf.adaptive_descent = inner_descent
    cli_launches = dict(pk.pmf_value_grad_cuda.launches)
    cli_plain = pk.pmf_value_grad_plain.calls
    with open(out_path, "rb") as f:
        res = pickle.load(f)
    boosts = res["boosts"]
    print(json.dumps(dict(
        phase="add_rmse_boosts_cli", pool=CLI_POOL, tile=CLI_TILE,
        cli_s=cli_s, tiles=tile_log, base_rmse=res["base_rmse"],
        kernel_launches={"/".join(k): v for k, v in cli_launches.items()},
        boost_mean=float(np.nanmean(boosts)),
        boost_max=float(np.nanmax(boosts)))), flush=True)
    check(set(res) == {"_real", "base_rmse", "boosts"}, f"keys {set(res)}")
    check(math.isfinite(res["base_rmse"]), f"base RMSE {res['base_rmse']}")
    check(bool((np.isfinite(boosts) == pool).all()),
          "boosts not finite exactly on the pool")
    check(cli_launches.get(("L,rows,d", "torch.float32"), 0) > 0,
          "the CLI never launched the (L, rows, d) kernel")
    check(cli_plain == 0, "the plain value+grad version ran in the CLI")
    # where a CLI-shaped refit tile spends its time: 128 lanes at their true
    # values, up to the CLI's 200 steps, the (L, rows, d) kernel
    ti, tj = di[tiles[0]], dj[tiles[0]]
    tv = torch.as_tensor(real, dtype=torch.float32, device=device)[ti, tj]
    split = device_split(lambda: pmf.fit_lookahead_batch(
        rst, prob, ti, tj, tv, rcfg, max_steps=200))
    print(json.dumps(dict(phase="refit_tile_profile", **split)), flush=True)

    def vg_entry(layout, dtype, replaces, launches):
        row = next(r for r in vg if r["layout"] == layout
                   and r["dtype"] == dtype and r["L"] == VG_LANES)
        return {
            "name": f"pmf_value_grad ({layout}) {dtype}", "route": "cuda",
            "source": "amf_tpu_torch/csrc/pmf_value_grad.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in vg
                               if r["layout"] == layout
                               and r["dtype"] == dtype),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None}

    chol_bound = bound_ms(
        (D * (D + 1) // 2 + 3 * D) * 4 * main_row["B"],
        (D ** 3 / 3 + 2 * D ** 2) * main_row["B"], "float32")
    b4 = "amf_tpu/ops/pallas_kernels.py:39"
    b2 = "amf_tpu/ops/pallas_kernels.py:194"
    print(json.dumps({"kernels": [{
        "name": "chol_solve_sample", "route": "cuda",
        "source": "amf_tpu_torch/csrc/chol_solve_sample.cu",
        "replaces": "amf_tpu/ops/chol_kernel.py:41",
        "launches": main_launches,
        "max_abs_err": max(r["max_abs_err"] for r in kern),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": chol_bound[0], "bound_by": chol_bound[1],
        "library_ms": None,
    },
        vg_entry("L,rows,d", "float32", b4,
                 cli_launches[("L,rows,d", "torch.float32")]),
        vg_entry("L,d,rows", "float32", b2,
                 refit_launches[("L,d,rows", "torch.float32")]),
        vg_entry("L,d,rows", "bfloat16", b2,
                 refit_launches[("L,d,rows", "torch.bfloat16")]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
