#!/usr/bin/env python3
"""Smoke run of the PyTorch port (amf_tpu_torch) on one CUDA card.

Drives the port's two main paths at the MovieLens-100k shape of the JAX
package's ``bench.py`` (943 x 1682, d=10, ratings 1..5) and checks every
hand-written kernel of them against its plain PyTorch version on the card:

  * the Gibbs BPMF ``exp-variance`` one-step lookahead and its active loop
    (a 128-sample base chain, 30-sample lane chains, 32 candidates x 5
    values = 160 lanes a tile), through the Cholesky solve-and-sample kernel;
  * the PMF-refit lookahead (``fit_lookahead_batch``, tiles of 128 lanes)
    and its ``add_rmse_boosts`` CLI, through the value+gradient kernel;
    its poly-LS epoch loop through the value+gradient and line-coefficient
    kernels; its fused branch through the whole-line-search kernel.

    python3 chip_smoke.py

Phases (each raises on failure):
  1. environment and kernel builds (one nvcc per library, in parallel, at
     first use, into build/; the fused line search is one library a factor
     width);
  2. Cholesky kernel vs plain version, both entry points: S given, at the
     main path's batch sizes and at other d; fed from the Gram, at the main
     path's two row draws (160 lanes, r = 943 and 1682), ragged and at
     other d, with and without centre and cells; and the time from the
     Gram products to x the earlier way (assembly in PyTorch, then the
     S-given entry) beside the Gram-fed one;
  3. the f32 Gibbs lookahead tile: finite scores, the Gram-fed kernel
     launched 120 times a tile, plain unused;
  4. the active loop (run_active_gibbs), 3 records on a 64-cell pool;
  5. the same tile in f64 through the kernel and through the plain version;
  6. value+gradient kernel vs plain version, both layouts, f32 and bf16, at
     L=128 lanes and at ragged shapes, with times; the variant that leaves
     the factors in global memory at d=32; the value bit for bit over two
     runs;
  7. the bench's lane-blocked refit: 1024 candidates in 8 tiles, bf16 and
     f32, and the f32 kernel tile vs the plain refit;
  8. the add_rmse_boosts CLI on a 256-cell pool (2 tiles, 200 refit steps),
     and the profile of one such tile (one index build, no mask scan);
  9. line-coefficient kernel vs plain version, f32 and bf16, on an index of
     the rated cells built once: at L=128 lanes from the fitted refit state
     and its gradients, at ragged shapes walked by row and by column with a
     lane on a rated cell, and at d=32 at the full shape, where the
     gathered side stays in global memory; the sums bit for bit over two
     runs; wrapper, public call and device times;
 10. the poly-LS refit sweep (scripts/probe_poly_kernel.py's workload):
     1024 candidates, poly-LS and proposal loop side by side, bf16 and f32,
     and the f32 kernel tile vs the plain tile at the bench's values and at
     the CLI's true values (8, 40 and 200 steps), with the epochs each
     took;
 11. the fused refit: one 128-lane tile at 8 and 200 steps, f32 and bf16,
     vs the unfused kernel path (one index build a refit), and the kernel's
     own outputs (per lane the evaluations, neg_ll and the factors) vs the
     plain version's, bit for bit over two runs, with wrapper and device
     times; its global-memory variant at d=32; and, as a figure, the rank
     correlation of the float32 boosts of phase 8's pool against a float64
     plain refit.
The launch counts are reset before phases 3, 7, 8, 10 and 11 and read
after phases 4, 7, 8, 10 and 11, before the comparisons with the plain
versions; phases 7, 8 and 10 also count the index builds (one a refit).
The line before the last is the kernels' JSON; the last line is
{"ok": true, "device": {...}}. With no CUDA device, or without the package
beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
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
# line-coefficient kernel vs plain version, |k - p| / (1 + |p|) on c1..c4:
# the same products summed in other orders (c2 is a difference of two such
# sums). bf16 rounds R and the factors identically on both sides; it is held
# to 10x the float32 bound, for the larger terms of the rounded inputs.
COEFF_TOL = {"float32": 1e-4, "bfloat16": 1e-3}
# fused refit: f32 vs the unfused kernel path to rtol 1e-4
# (tests/test_pallas_kernels.py:176); bf16 vs f32 to 1e-2 (8 mantissa bits;
# a residual rounded the other way may change one accept). At the CLI's
# values and budget these are figures (phase 11 says why)
FUSED_RTOL, FUSED_BF16_RTOL = 1e-4, 1e-2
# the fused kernel vs its plain version, both dtypes, on its own outputs:
# per lane the same evaluations, neg_ll to 1e-4 relative and the factors to
# 1e-4 scaled, |k - p| / (1 + |p|). Both sides round the state identically
# and differ in summation order only (readings <= 3.1e-6 on neg_ll and
# <= 3.5e-8 on the factors: PERF.md, PR 4). Over the CLI's 200 steps in
# float32, where lr grows 1.25x an accept, the gradients' last bits add up
# in the factors (reading 3.4e-4) while neg_ll, at a flat optimum, moves by
# their square: the factors get 1e-3 there. From random factors far from
# the optimum a bf16 state does move (at the fitted state no lane's does),
# and a stored value near a rounding boundary may round the other way in
# one of the two: one bf16 rounding, 2^-8.
FUSED_KERNEL_TOL = dict(f=1e-4, factors=1e-4, factors_long=1e-3,
                        factors_bf16_moving=2 ** -8)
# where lanes reject steps in float32, near-tie accepts move with the
# summation order (phases 10, 11): there at least this many of the 128
# lanes must make the plain version's proposals (poly-LS, 40 steps) or
# evaluations (fused, 200 steps), and those lanes are held to the bounds
# (readings: 127 and 127)
SAME_COUNT_MIN = 120
POLY_RTOL = 1e-4  # f32 poly kernel tile vs plain tile
# a poly-LS budget at the CLI's values where rungs are rejected (at 8 steps
# none is) and summation order has moved few lanes (at 200, 20 of 128)
POLY_LADDER_STEPS = 40
# the card's published peaks (H100 SXM data sheet, dense)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {"float32": 67e12, "float64": 67e12, "bfloat16": 989e12}


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


def sample_rows_assembled(ck, mask, masked_r, other, mu, alpha, beta, z,
                          center, cells):
    """The row draw with S and the right-hand side assembled in PyTorch as
    (L, r, d, d) and (L, r, d), then the S-given kernel entry: the path the
    Gram-fed entry replaced, kept here to time the two side by side."""
    import torch

    L, c, d = other.shape
    r = mask.shape[0]
    vv = (other[..., :, None] * other[..., None, :]).reshape(L, c, d * d)
    G = torch.bmm(mask.expand(L, r, c), torch.cat([vv, other], dim=-1))
    S = alpha[:, None] + beta * G[..., :d * d].reshape(L, r, d, d)
    mr = torch.bmm(masked_r.expand(L, r, c), other)
    if center is not None:
        mr = mr - center[:, None, None] * G[..., d * d:]
    rhs = beta * mr + (alpha @ mu[..., None])[:, None, :, 0]
    if cells is not None:
        row, col, dm, dr = cells
        lane = torch.arange(L, device=other.device)
        o = other[lane, col]
        S[lane, row] += (beta * dm)[:, None, None] * (o[:, :, None]
                                                      * o[:, None, :])
        shift = dr if center is None else dr - dm * center
        rhs[lane, row] += (beta * shift)[:, None] * o
    return ck.chol_solve_sample(S, rhs, z)


def gram_rows(device):
    """Phase 2, the Gram-fed entry: kernel vs plain version, and Gram-to-x
    the earlier way beside the new."""
    import torch
    from amf_tpu_torch.models import bpmf_gibbs
    from amf_tpu_torch.ops import chol_kernel as ck

    gen = torch.Generator(device=device).manual_seed(2)
    beta = 2.0
    lanes = TILE * len(VALS)
    # (L, r, c, d, center, cells, timed)
    cases = [(lanes, N, M, D, True, True, True),
             (lanes, M, N, D, True, True, True),
             (3, 301, 64, D, True, True, False)]
    cases += [(5, 301, 64, d, ce, cl, False) for d in (1, 5, 20, 32)
              for ce, cl in ((True, True), (False, False))]
    cases += [(5, 301, 64, D, True, False, False),
              (5, 301, 64, D, False, True, False)]
    rows = []
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        for L, r, c, d, with_center, with_cells, timed in cases:
            def rand(*shape):
                return torch.randn(*shape, generator=gen, dtype=dtype,
                                   device=device)

            density = 5000 / (N * M) if timed else 0.3
            mask = (torch.rand(r, c, generator=gen, device=device)
                    < density).to(dtype)
            masked_r = mask * torch.randint(1, 6, (r, c), generator=gen,
                                            device=device).to(dtype)
            other = 0.5 * rand(L, c, d)
            A = rand(L, d, d)
            alpha = A @ A.mT / d + 0.5 * torch.eye(d, dtype=dtype,
                                                   device=device)
            mu, z = rand(L, d), rand(L, r, d)
            center = 3 + 0.1 * rand(L) if with_center else None
            cells = None
            if with_cells:
                row = torch.randint(0, r, (L,), generator=gen, device=device)
                row[0] = r - 1  # the ragged last block
                col = torch.randint(0, c, (L,), generator=gen, device=device)
                dm = (torch.arange(L, device=device) % 2).to(dtype)
                cells = (row, col, dm, rand(L))
            Gt, mrt = bpmf_gibbs._gram_products(mask, masked_r, other)
            args = (Gt, mrt, z, alpha, mu, beta, center, cells, other)
            got = ck.chol_gram_solve_sample(*args)
            want = ck.chol_gram_solve_sample(*args, kernel=False)
            torch.cuda.synchronize()
            diff = (got - want).abs()
            scaled = (diff / (1 + want.abs())).max().item()
            row_out = dict(entry="gram", dtype=name, L=L, r=r, c=c, d=d,
                           center=with_center, cells=with_cells,
                           max_abs_err=diff.max().item(), scaled_err=scaled,
                           tol=KERNEL_TOL[name])
            if timed:
                row_out["ms"] = cuda_ms(
                    lambda: ck.chol_gram_solve_sample(*args), 20)
                row_out["plain_ms"] = cuda_ms(
                    lambda: ck.chol_gram_solve_sample(*args, kernel=False), 3)
                row_out["device_ms"] = kernel_device_ms(
                    lambda: ck.chol_gram_solve_sample(*args),
                    "chol_gram_kernel")
                p = d * (d + 1) // 2
                row_out["bound_ms"], row_out["bound_by"] = bound_ms(
                    (p + 4 * d) * z.element_size() * L * r,
                    (d ** 3 / 3 + 2 * d ** 2 + 2 * p + 4 * d) * L * r, name)
                # from the Gram products to x: earlier way, new, new, earlier
                sr = (mask, masked_r, other, mu, alpha, beta, z)

                def old():
                    return sample_rows_assembled(ck, *sr, center, cells)

                def new():
                    return bpmf_gibbs._sample_rows(*sr, center=center,
                                                   cells=cells)

                both = (old().sub_(new()).abs_() / (1 + want.abs())).max()
                t = [cuda_ms(f, 5) for f in (old, new, new, old)]
                row_out.update(
                    gram_to_x_assembled_ms=(t[0] + t[3]) / 2,
                    gram_to_x_ms=(t[1] + t[2]) / 2,
                    assembled_vs_gram_fed=both.item())
                check(both.item() <= KERNEL_TOL[name],
                      f"the two row-draw paths disagree: {row_out}")
            rows.append(row_out)
            print("kernel-check " + json.dumps(row_out), flush=True)
            check(math.isfinite(scaled) and scaled <= KERNEL_TOL[name],
                  f"Gram-fed kernel disagrees with plain version: {row_out}")
            del Gt, mrt, args, got, want, diff, z, other, mask, masked_r
            torch.cuda.empty_cache()
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
    # the rated cells indexed once, as a refit tile does
    index = pk.rated_index(rated, R, bf16=bf16)
    variants = dict(pk.pmf_value_grad_cuda.variants)
    got = fn(*args, bf16=bf16, index=index)
    variant = next(k for k, v in pk.pmf_value_grad_cuda.variants.items()
                   if v != variants.get(k, 0))
    want = fn(*args, bf16=bf16, kernel=False)
    again = fn(*args, bf16=bf16, index=index)
    torch.cuda.synchronize()
    check(torch.equal(got[0], again[0]),
          "the value is not bitwise the same over two runs")
    tol = VG_TOL[bf16 and transposed]
    val_err = ((got[0] - want[0]).abs() / want[0].abs()).max().item()
    grad_err = max(((g.float() - w.float()).abs() / (1 + w.float().abs()))
                   .max().item() for g, w in zip(got[1:], want[1:]))
    max_abs = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(got, want))
    row = dict(layout="L,d,rows" if transposed else "L,rows,d",
               dtype=str(io).split(".")[1], L=L, n=n, m=m, d=d,
               factors_in=variant, max_abs_err=max_abs, val_rel_err=val_err,
               grad_scaled_err=grad_err, tol=tol)
    if time_it:
        # the kernel's wrapper (allocations, checks and the launch) against
        # the plain version of the same function; then the public function,
        # which adds the prior terms of the value with PyTorch ops; then the
        # launch alone, by the profiler's device time
        kw = dict(transposed=transposed, round_resid=bf16 and transposed,
                  out_dtype=io if transposed else torch.float32, index=index)

        def launch():
            return pk.pmf_value_grad_cuda(*args, **kw)

        rows_args = [x.mT.float() if transposed else x.float()
                     for x in args[:2]] + [args[2].float(), *args[3:]]
        row["ms"] = cuda_ms(launch, 20)
        row["plain_ms"] = cuda_ms(lambda: pk.pmf_value_grad_plain(
            *rows_args, round_resid=kw["round_resid"]), 3)
        row["call_ms"] = cuda_ms(
            lambda: fn(*args, bf16=bf16, index=index), 20)
        row["plain_call_ms"] = cuda_ms(
            lambda: fn(*args, bf16=bf16, kernel=False), 3)
        row["device_ms"] = kernel_device_ms(launch, "value_grad")
        # what the data needs: the rated cells of every lane, plus the
        # lane's own cell where it is not rated; 3 d multiply-adds a cell.
        # Bytes: the index (pointers, columns, R's values, rows, positions)
        # once, the factors in, the gradients out, the lanes' cells and sums
        cells = L * index.nnz + int((~rated[di, dj]).sum())
        isz = 2 if bf16 else 4
        osz = 2 if bf16 and transposed else 4
        n_bytes = ((n + m + 2) * 4 + index.nnz * (12 + isz)
                   + L * (n + m) * d * (isz + osz) + L * (8 + 8 + 4 + 4))
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
    check(all(r["factors_in"] == "shared" for r in rows),
          "a case that fits shared memory took the global-memory variant")
    # at d = 32 a lane's factors (336 KB) do not fit a block's shared memory:
    # the same walk on the factors in global memory
    for bf16, tr in ((False, False), (True, True)):
        row = value_grad_case(pk, R, rated, 8, 32, bf16, tr, gen, True)
        check(row["factors_in"] == "global",
              f"d = 32 at full shape did not take the global variant: {row}")
        rows.append(row)
    return rows


def device_split(fn, top=8):
    """torch.profiler over one call of ``fn``: wall ms, device-busy ms, the
    ``top`` device kernels by their own device time, and how often the host
    called ``aten::nonzero`` (the index build; it synchronises)."""
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
    nonzero = sum(e.count for e in prof.key_averages()
                  if e.key == "aten::nonzero")
    return dict(wall_ms=wall_ms, device_busy_ms=busy,
                busy_share=busy / wall_ms, nonzero_calls=nonzero,
                device_launches=sum(r[2] for r in kernels),
                top=[dict(name=k[:80], ms=t, calls=c)
                     for k, t, c in kernels[:top]])


def kernel_device_ms(fn, name_part: str, reps: int = 10) -> float:
    """Mean device time in ms of the kernels whose name holds ``name_part``,
    over ``reps`` calls of ``fn`` under torch.profiler: the launch alone,
    without the host's share of the call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and name_part in e.key]
    # the profiler may drop a launch at the window's edge: average over those
    # it recorded
    seen = sum(e.count for e in hits)
    check(0 < seen <= reps,
          f"profiler saw {[(e.key, e.count) for e in hits]} for {name_part}")
    return sum(e.self_device_time_total for e in hits) / 1e3 / seen


def spearman(a, b) -> float:
    import numpy as np

    ra = np.argsort(np.argsort(a)).astype(float)
    rb = np.argsort(np.argsort(b)).astype(float)
    return float(np.corrcoef(ra, rb)[0, 1])


def timed_ms(fn):
    """(fn(), its time in ms by CUDA events, one call)."""
    import torch

    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


@contextlib.contextmanager
def plain_versions(pk):
    """``fit_lookahead_batch`` through the plain versions on the card."""
    names = ("pmf_batched_value_grad_t", "pmf_line_coeffs_t",
             "pmf_lookahead_fused_t")
    saved = {k: getattr(pk, k) for k in names}
    try:
        for k, fn in saved.items():
            setattr(pk, k, functools.partial(fn, kernel=False))
        yield
    finally:
        for k, fn in saved.items():
            setattr(pk, k, fn)


def own_cells(rated, di, dj) -> int:
    """Cells the lanes' own cells add to the rated ones."""
    return int((~rated[di, dj]).sum())


def coeff_case(pk, args, bf16, time_it):
    """Line-coefficient kernel vs plain version on ``args`` (Ut, Vt, Gut,
    Gvt, R, rated, di, dj, dv, sigmas), on an index built once."""
    import torch

    Ut, Vt, _, _, R, rated, di, dj = args[:8]
    L, d, n = Ut.shape
    m = Vt.shape[2]
    dtype = "bfloat16" if bf16 else "float32"
    io = torch.bfloat16 if bf16 else torch.float32
    index = pk.rated_index(rated, R, bf16=bf16)
    builds = pk.rated_index.calls
    variants = dict(pk.pmf_line_coeffs_cuda.variants)
    got = torch.stack(pk.pmf_line_coeffs_t(*args, bf16=bf16, index=index))
    variant = next(k for k, v in pk.pmf_line_coeffs_cuda.variants.items()
                   if v != variants.get(k, 0))
    want = torch.stack(pk.pmf_line_coeffs_t(*args, bf16=bf16, kernel=False))
    again = torch.stack(pk.pmf_line_coeffs_t(*args, bf16=bf16, index=index))
    torch.cuda.synchronize()
    check(pk.rated_index.calls == builds,
          "the line-coefficient kernel built an index of its own")
    check(torch.equal(got, again),
          "the coefficients are not bitwise the same over two runs")
    diff = (got - want).abs()
    scaled = (diff / (1 + want.abs())).max().item()
    row = dict(dtype=dtype, L=L, n=n, m=m, d=d, factors_in=variant,
               lanes_on_rated_cells=int(rated[di, dj].sum()),
               max_abs_err=diff.max().item(), scaled_err=scaled,
               tol=COEFF_TOL[dtype])
    if time_it:
        # the kernel's wrapper (checks, the (L, 4) result and the launch);
        # the public function, which adds the directions' norms with
        # PyTorch ops (what earlier readings of this kernel timed); the
        # launch alone by the profiler's device time
        ins = [x.to(io) for x in args[:4]]

        def launch():
            return pk.pmf_line_coeffs_cuda(*ins, *args[4:9], index=index)

        row["ms"] = cuda_ms(launch, 20)
        row["call_ms"] = cuda_ms(
            lambda: pk.pmf_line_coeffs_t(*args, bf16=bf16, index=index), 20)
        row["plain_ms"] = cuda_ms(
            lambda: pk.pmf_line_coeffs_t(*args, bf16=bf16, kernel=False), 3)
        row["device_ms"] = kernel_device_ms(launch, "line_coeffs")
        # the index once (pointers, columns, R's values, rows, positions),
        # the factors and directions and the lanes' cells in, 4 sums out; on
        # each rated cell and lane cell pred (2d), P1 (4d), P2 (2d), 8 more
        cells = L * index.nnz + own_cells(rated, di, dj)
        isz = 2 if bf16 else 4
        n_bytes = ((n + m + 2) * 4 + index.nnz * (12 + isz)
                   + 2 * L * (n + m) * d * isz + L * (8 + 8 + 4 + 16))
        row["bound_ms"], row["bound_by"] = bound_ms(
            n_bytes, (8 * d + 8) * cells, dtype)
    print("line-coeffs-check " + json.dumps(row), flush=True)
    check(math.isfinite(scaled) and scaled <= COEFF_TOL[dtype],
          f"line-coefficient kernel disagrees with plain version: {row}")
    return row


def coeff_rows(pk, rst, prob, di, dj, dv, sig, device):
    """Phase 9: the refit state and its gradients at L=128; ragged shapes
    that walk the rows (13 x 9: the 9 columns are gathered) and the columns
    (9 x 13); d = 32 at the full shape, where the gathered side stays in
    global memory. Lane 0 of every random case sits on a rated cell."""
    import torch

    L = PK_TILE
    rows = []
    for bf16 in (False, True):
        io = torch.bfloat16 if bf16 else torch.float32
        Ut = rst.U.mT.to(io).expand(L, D, N).contiguous()
        Vt = rst.V.mT.to(io).expand(L, D, M).contiguous()
        base = (prob.R_obs, prob.rated, di[:L], dj[:L], dv[:L], sig)
        _, Gut, Gvt = pk.pmf_batched_value_grad_t(Ut, Vt, *base, bf16=bf16)
        rows.append(coeff_case(pk, (Ut, Vt, Gut, Gvt, *base), bf16, True))
    check(all(r["factors_in"] == "shared" for r in rows),
          "the main path's shape took the global-memory variant")
    gen = torch.Generator(device=device).manual_seed(9)
    csig = torch.tensor([0.8, 10.0, 7.0], device=device)

    def random_case(L, n, m, d, R, rated, scale):
        fac = [scale * torch.randn(L, d, k, generator=gen, device=device)
               for k in (n, m, n, m)]
        cdi = torch.randint(0, n, (L,), generator=gen, device=device)
        cdj = torch.randint(0, m, (L,), generator=gen, device=device)
        on = torch.nonzero(rated)[0]  # lane 0 on a rated cell
        cdi[0], cdj[0] = on[0], on[1]
        cdv = torch.randint(1, 6, (L,), generator=gen, device=device).float()
        return (*fac, R, rated, cdi, cdj, cdv, csig)

    for d in (3, 16, 32):
        for n, m in ((13, 9), (9, 13)):
            for bf16 in (False, True):
                R = torch.randint(1, 6, (n, m), generator=gen,
                                  device=device).float()
                rated = torch.rand(n, m, generator=gen, device=device) < 0.5
                row = coeff_case(pk, random_case(3, n, m, d, R, rated, 1.0),
                                 bf16, False)
                check(row["factors_in"] == "shared"
                      and row["lanes_on_rated_cells"] >= 1, f"{row}")
                rows.append(row)
    # at d = 32 the 943 rows' factor and direction (249 KB) do not fit a
    # block's shared memory: the same walk on them in global memory
    for bf16 in (False, True):
        row = coeff_case(pk, random_case(8, N, M, 32, prob.R_obs, prob.rated,
                                         0.3), bf16, True)
        check(row["factors_in"] == "global"
              and row["lanes_on_rated_cells"] >= 1,
              f"d = 32 at full shape did not take the global variant: {row}")
        rows.append(row)
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
    # one nvcc per library, all together; the fused line search is built
    # for one factor width a library: the main paths' and phase 11's d = 32
    libraries = [("chol_solve_sample", ()), ("pmf_value_grad", ()),
                 ("pmf_line_coeffs", ()),
                 *(("pmf_lookahead_fused", pk.fused_defines(d))
                   for d in (D, 32))]
    def build_s(lib):
        cuda_build.build(*lib)
        return round(time.perf_counter() - t0, 1)

    with ThreadPoolExecutor(len(libraries)) as pool:
        each = list(pool.map(build_s, libraries))
    ck._entry_points()
    for lib in libraries[1:]:
        pk._entry_point(*lib)
    # a CLI run pays a library's seconds at its first use of a new source,
    # the fused line search's at its first use of a new -D
    print(f"kernel build+load s {time.perf_counter() - t0:.1f} (each nvcc, "
          f"side by side: "
          f"{dict(zip((' '.join((n, *d)) for n, d in libraries), each))})",
          flush=True)

    # ---- 2. kernel vs plain version on the card
    kern = kernel_rows(device)
    main_row = next(r for r in kern if r["dtype"] == "float32"
                    and r["B"] == 269120)
    gram = gram_rows(device)
    gram_row = next(r for r in gram if r["dtype"] == "float32"
                    and r["r"] == M and r["L"] == TILE * len(VALS))

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

    ck.chol_gram_solve_sample_cuda.launches = 0
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
    la_launches = ck.chol_gram_solve_sample_cuda.launches
    check(scores.shape == (TILE,), f"scores shape {tuple(scores.shape)}")
    check(bool(torch.isfinite(scores).all()), f"non-finite scores {scores}")
    check(bool((scores > 0).all()), f"non-positive scores {scores}")
    # a tile: 30 rounds of 2 sweeps, a U and a V draw each, one launch a draw
    draws = LA_SAMPS * gcfg.num_gibbs * 2
    check(la_launches == 2 * draws,
          f"two lookahead tiles launched the Gram-fed kernel {la_launches} "
          f"times: want {draws} a tile")
    check(ck.chol_solve_sample_batch_minor.launches == 0,
          "the S-given entry ran on the CUDA main path")
    check(ck.chol_solve_sample_reference.calls == 0,
          "the plain version ran on the CUDA main path")
    print(json.dumps(dict(
        phase="lookahead_f32", lanes=TILE * len(VALS), tile_s=tile_s,
        candidates_per_s=TILE / tile_s[1], peak_mem_gib=peak_gib,
        kernel_launches=la_launches, launches_a_tile=draws,
        scores_min=scores.min().item(), scores_max=scores.max().item())),
        flush=True)

    # where a warm tile spends its time (profiled apart from the timed tiles
    # and from the launch counts above)
    split = device_split(lambda: tile(pst, prob, stats), top=14)
    ck.chol_gram_solve_sample_cuda.launches = la_launches
    print(json.dumps(dict(phase="lookahead_tile_profile", **split)),
          flush=True)

    # ---- 4. the active loop on a 64-cell pool
    q = np.flatnonzero(prob.queryable.cpu().numpy().ravel())
    pool = np.zeros(N * M, bool)
    pool[rng.choice(q, size=POOL, replace=False)] = True
    pool = pool.reshape(N, M)
    prob_pool = types.problem_from_dense(real, known, queryable=pool,
                                         dtype=torch.float32, device=device)
    before = ck.chol_gram_solve_sample_cuda.launches
    t0 = time.perf_counter()
    res = run_active_gibbs(
        prob_pool, real, ["exp-variance"], latent_d=D, rating_values=VALS,
        num_samps=BASE_SAMPS, lookahead_samps=LA_SAMPS, lookahead_tile=TILE,
        steps=LOOP_STEPS, seed=0, dtype=torch.float32, device=device,
        verbose=True)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    loop_launches = ck.chol_gram_solve_sample_cuda.launches - before
    main_launches = ck.chol_gram_solve_sample_cuda.launches
    plain_calls = ck.chol_solve_sample_reference.calls
    recs = res["exp-variance"]
    picks = [r[2] for r in recs[1:]]
    check(len(recs) == LOOP_STEPS, f"{len(recs)} records")
    check(all(math.isfinite(r[1]) for r in recs), f"RMSE {[r[1] for r in recs]}")
    check(len(set(picks)) == len(picks) and all(pool[p] for p in picks),
          f"picks {picks} not distinct or outside the pool")
    check(loop_launches > 0, "the active loop never launched the kernel")
    check(plain_calls == 0
          and ck.chol_solve_sample_batch_minor.launches == 0,
          "the plain version or the S-given entry ran on the CUDA main path")
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
    check(ck.chol_gram_solve_sample_cuda.launches == main_launches + draws
          and ck.chol_solve_sample_reference.calls == 0,
          "the f64 tile did not go through the Gram-fed kernel alone")
    t0 = time.perf_counter()
    s_plain = tile(pst64, prob64, stats64, kernel=False)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    rel = ((s_kernel - s_plain).abs() / s_plain.abs()).max().item()
    print(json.dumps(dict(
        phase="lookahead_f64_kernel_vs_plain", max_rel_diff=rel,
        rtol=SCORE_RTOL_F64, tile_s_kernel=t_kernel, tile_s_plain=t_plain,
        plain_calls=ck.chol_solve_sample_reference.calls)),
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

    # every refit from here on is counted, to hold the index to one build a
    # fit_lookahead_batch call
    inner_fit, fit_calls = pmf.fit_lookahead_batch, [0]

    def counted_fit(*a, **kw):
        fit_calls[0] += 1
        return inner_fit(*a, **kw)

    pmf.fit_lookahead_batch = counted_fit

    def index_builds_per_refit(since):
        """(index builds, refits) since the counts ``since``."""
        return (pk.rated_index.calls - since[0], fit_calls[0] - since[1])

    pk.pmf_value_grad_cuda.launches.clear()
    pk.pmf_value_grad_cuda.variants.clear()
    pk.pmf_value_grad_plain.calls = 0
    since = (pk.rated_index.calls, fit_calls[0])
    refit_rate, refit_f = {}, {}
    for bf16 in (True, False):
        sweep(bf16)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refit_f[bf16] = sweep(bf16)
        torch.cuda.synchronize()
        refit_rate[bf16] = PK_N_CAND / (time.perf_counter() - t0)
    refit_launches = dict(pk.pmf_value_grad_cuda.launches)
    refit_index = index_builds_per_refit(since)
    check(pk.pmf_value_grad_plain.calls == 0,
          "the plain value+grad version ran on the refit path")
    check(refit_index[0] == refit_index[1] == 4 * len(tiles),
          f"index builds and refits of the sweeps: {refit_index}")
    check(pk.pmf_value_grad_cuda.variants["global"] == 0,
          "a refit tile left its factors in global memory")
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
        index_builds=refit_index[0], refits=refit_index[1],
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
    since = (pk.rated_index.calls, fit_calls[0])
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
    cli_index = index_builds_per_refit(since)
    with open(out_path, "rb") as f:
        res = pickle.load(f)
    boosts = res["boosts"]
    print(json.dumps(dict(
        phase="add_rmse_boosts_cli", pool=CLI_POOL, tile=CLI_TILE,
        cli_s=cli_s, tiles=tile_log, base_rmse=res["base_rmse"],
        kernel_launches={"/".join(k): v for k, v in cli_launches.items()},
        index_builds=cli_index[0], refits=cli_index[1],
        boost_mean=float(np.nanmean(boosts)),
        boost_max=float(np.nanmax(boosts)))), flush=True)
    check(set(res) == {"_real", "base_rmse", "boosts"}, f"keys {set(res)}")
    check(math.isfinite(res["base_rmse"]), f"base RMSE {res['base_rmse']}")
    check(bool((np.isfinite(boosts) == pool).all()),
          "boosts not finite exactly on the pool")
    check(cli_launches.get(("L,rows,d", "torch.float32"), 0) > 0,
          "the CLI never launched the (L, rows, d) kernel")
    check(cli_plain == 0, "the plain value+grad version ran in the CLI")
    check(cli_index[0] == cli_index[1] == CLI_POOL // CLI_TILE,
          f"index builds and refit tiles of the CLI: {cli_index}")
    # one launch an evaluation: the init, each proposal, and the final
    # re-evaluations of the loop
    check(cli_launches[("L,rows,d", "torch.float32")]
          <= sum(t["proposals"] + 4 for t in tile_log),
          f"more launches than evaluations: {cli_launches}, {tile_log}")
    # where a CLI-shaped refit tile spends its time: 128 lanes at their true
    # values, up to the CLI's 200 steps, the (L, rows, d) kernel
    ti, tj = di[tiles[0]], dj[tiles[0]]
    tv = torch.as_tensor(real, dtype=torch.float32, device=device)[ti, tj]
    split = device_split(lambda: pmf.fit_lookahead_batch(
        rst, prob, ti, tj, tv, rcfg, max_steps=200))
    print(json.dumps(dict(phase="refit_tile_profile", **split)), flush=True)
    check(split["nonzero_calls"] == 1,
          f"the profiled tile called nonzero {split['nonzero_calls']} times: "
          "want the one index build, none in the proposal loop")

    # ---- 9. line-coefficient kernel vs plain version
    sig = torch.stack([rst.sigma_sq, rst.sigma_u_sq, rst.sigma_v_sq])
    lc = coeff_rows(pk, rst, prob, di, dj, dv, sig, device)

    # ---- 10. the poly-LS refit sweep (scripts/probe_poly_kernel.py)
    def poly_sweep(poly, bf16):
        return torch.cat([refit(s, lane_block=PK_LANE_BLOCK, block_rows=256,
                                bf16=bf16, poly_ls=poly) for s in tiles])

    def launch_total(counter):
        return sum(counter.launches.values())

    pk.pmf_value_grad_cuda.launches.clear()
    pk.pmf_line_coeffs_cuda.launches.clear()
    pk.pmf_value_grad_plain.calls = pk.pmf_line_coeffs_plain.calls = 0
    since = (pk.rated_index.calls, fit_calls[0])
    poly_runs = []
    poly_f = {}
    for bf16 in (True, False):
        for poly in (True, False):
            poly_sweep(poly, bf16)  # warm
            torch.cuda.synchronize()
            b2 = launch_total(pk.pmf_value_grad_cuda)
            b3 = launch_total(pk.pmf_line_coeffs_cuda)
            t0 = time.perf_counter()
            poly_f[bf16, poly] = poly_sweep(poly, bf16)
            torch.cuda.synchronize()
            poly_runs.append(dict(
                poly_ls=poly, bf16=bf16,
                candidates_per_s=PK_N_CAND / (time.perf_counter() - t0),
                b2_launches=launch_total(pk.pmf_value_grad_cuda) - b2,
                b3_launches=launch_total(pk.pmf_line_coeffs_cuda) - b3))
    poly_launches = dict(pk.pmf_line_coeffs_cuda.launches)
    poly_index = index_builds_per_refit(since)
    check(poly_index[0] == poly_index[1] == 8 * len(tiles),
          f"index builds and refits of the poly sweeps: {poly_index}")
    check(pk.pmf_value_grad_plain.calls == 0
          and pk.pmf_line_coeffs_plain.calls == 0,
          "a plain version ran on the poly-LS refit path")
    for bf16 in (True, False):
        check(bool(torch.isfinite(poly_f[bf16, True]).all()),
              f"non-finite poly-LS refit values (bf16={bf16})")
        check(poly_launches.get(
            "torch.bfloat16" if bf16 else "torch.float32", 0) > 0,
            f"the poly-LS refit never launched the kernel (bf16={bf16})")
    # the f32 poly kernel tile vs the plain tile, on one tile at the bench's
    # values (each cell at its prediction: every lane stops after one epoch,
    # on c1 alone) and at the CLI's (each cell at its true value: lr grows
    # and the step budget runs out at 8 steps; at 40 rungs are rejected and
    # lr falls by 0.5^consumed). An epoch is one B3 launch or one plain
    # call. Where rungs are rejected, lanes that examined the same number of
    # rungs are held to the bound; at the CLI's 200 steps even those part
    # (2.2e-4 on the chip), so that run is a figure.
    tile_vals = {"bench": dv[tiles[0]], "cli": tv}

    def refit_tile(vals, steps, bf16, **kw):
        return pmf.fit_lookahead_batch(rst, prob, ti, tj, tile_vals[vals],
                                       rcfg, max_steps=steps,
                                       lane_block=PK_LANE_BLOCK, bf16=bf16,
                                       **kw)

    def rel(a, b):
        """Largest relative difference of two neg_ll vectors, or inf."""
        return ((a - b).abs() / b.abs()).max().item() if len(b) else math.inf

    def poly_tile(vals, steps):
        """(neg_ll, proposals each lane examined) of one f32 poly tile."""
        inner, seen = pmf._poly_epochs, []

        def epochs(*a, **kw):
            out = inner(*a, **kw)
            seen.append(out[3])
            return out

        pmf._poly_epochs = epochs
        try:
            f = refit_tile(vals, steps, False, poly_ls=True)[2]
        finally:
            pmf._poly_epochs = inner
        return f, seen[0]

    poly_checks = {}
    for vals, steps in (("bench", PK_REFIT_STEPS), ("cli", PK_REFIT_STEPS),
                        ("cli", POLY_LADDER_STEPS), ("cli", FIT_BUDGET)):
        b3 = launch_total(pk.pmf_line_coeffs_cuda)
        kf, kn = poly_tile(vals, steps)
        plain_calls = pk.pmf_line_coeffs_plain.calls
        with plain_versions(pk):
            pf, pn = poly_tile(vals, steps)
        same = kn == pn
        epochs = launch_total(pk.pmf_line_coeffs_cuda) - b3
        row = poly_checks[f"{vals}/{steps}"] = dict(
            epochs=epochs,
            plain_epochs=pk.pmf_line_coeffs_plain.calls - plain_calls,
            # > 0: the longest lane examined more rungs than there were
            # epochs, so some epoch rejected its first rung
            rejected_rungs_min=int(kn.max()) - epochs,
            lanes_same_proposals=int(same.sum()),
            lanes_within_rtol=int(((kf - pf).abs()
                                   <= POLY_RTOL * pf.abs()).sum()),
            f32_kernel_vs_plain_max_rel=rel(kf, pf),
            same_lanes_max_rel=rel(kf[same], pf[same]))
        if steps == FIT_BUDGET:
            continue
        ladder = steps == POLY_LADDER_STEPS
        check(row["lanes_same_proposals"] >= (SAME_COUNT_MIN if ladder
                                              else PK_TILE)
              and row["same_lanes_max_rel"] <= POLY_RTOL
              and (row["rejected_rungs_min"] > 0 or not ladder),
              f"f32 poly-LS kernel tile vs plain tile ({vals}, {steps} "
              f"steps): {row}")
    loop32 = poly_f[False, False]
    print(json.dumps(dict(
        phase="poly_ls_refit", candidates=PK_N_CAND, tile=PK_TILE,
        max_steps=PK_REFIT_STEPS, runs=poly_runs,
        kernel_launches=poly_launches, checks=poly_checks, rtol=POLY_RTOL,
        f32_poly_vs_proposal_loop_max_rel=(
            (poly_f[False, True] - loop32).abs() / loop32.abs()).max().item(),
        bf16_poly_vs_f32_poly_max_rel=(
            (poly_f[True, True] - poly_f[False, True]).abs()
            / poly_f[False, True].abs()).max().item())), flush=True)

    # ---- 11. the fused refit on the same tile, at the bench's values
    # (lanes stop within a few steps) and at the CLI's (lanes run to the
    # step budget)
    pk.pmf_lookahead_fused_cuda.launches.clear()
    pk.pmf_lookahead_fused_cuda.variants.clear()
    pk.pmf_lookahead_fused_plain.calls = 0
    since = (pk.rated_index.calls, fit_calls[0])
    fused, fused_ms, n_calls = {}, {}, 0
    for vals in tile_vals:
        for steps in (8, FIT_BUDGET):
            for bf16 in (False, True):
                for _ in range(2):  # the second call is timed warm
                    fused[vals, steps, bf16], fused_ms[vals, steps, bf16] = (
                        timed_ms(lambda: refit_tile(vals, steps, bf16,
                                                    fused=True)))
                    n_calls += 1
    fused_launches = dict(pk.pmf_lookahead_fused_cuda.launches)
    fused_variants = dict(pk.pmf_lookahead_fused_cuda.variants)
    fused_index = index_builds_per_refit(since)
    check(sum(fused_launches.values()) == n_calls,
          f"{n_calls} fused refits launched {fused_launches}: want one "
          "launch a tile")
    check(fused_variants == {"shared": n_calls},
          f"a fused refit tile left its factors in global memory: "
          f"{fused_variants}")
    check(fused_index[0] == fused_index[1] == n_calls,
          f"index builds and refits of the fused tiles: {fused_index}")
    check(pk.pmf_lookahead_fused_plain.calls == 0,
          "the plain fused version ran on the fused refit path")
    fcheck = {}
    for vals in tile_vals:
        f_start = refit_tile(vals, 0, False)[2]
        for steps in (8, FIT_BUDGET):
            unfused, unfused_ms = timed_ms(
                lambda: refit_tile(vals, steps, False))
            k32, k16 = fused[vals, steps, False], fused[vals, steps, True]
            row = dict(
                f_start_max=f_start.max().item(),
                fused_ms=fused_ms[vals, steps, False],
                fused_bf16_ms=fused_ms[vals, steps, True],
                unfused_ms=unfused_ms, f32_vs_unfused=rel(k32[2], unfused[2]),
                bf16_vs_f32=rel(k16[2], k32[2]))
            check(all(bool(torch.isfinite(x).all()) for x in k32 + k16),
                  f"non-finite fused refit ({vals}, {steps} steps)")
            # every lane ends at or below its start (one ulp for the value's
            # other summation order; bf16 rounds the start itself)
            check(bool((k32[2] <= f_start * (1 + 1e-6)).all()
                       and (k16[2] <= f_start * (1 + 1e-2)).all()),
                  f"a fused refit lane ended above its start ({vals})")
            if not (vals == "cli" and steps == FIT_BUDGET):
                check(row["f32_vs_unfused"] <= FUSED_RTOL
                      and row["bf16_vs_f32"] <= FUSED_BF16_RTOL,
                      f"fused refit disagrees ({vals}, {steps} steps): {row}")
            else:
                # a figure: at the edge of stability, accept tests compare
                # values ~20 float32 ulps apart, so summation order alone
                # changes where a lane stops. Shown by the proposal loop
                # through its kernel against its plain version.
                with plain_versions(pk):
                    loop_plain = refit_tile(vals, steps, False)
                row["unfused_kernel_vs_plain"] = rel(unfused[2], loop_plain[2])
            fcheck[f"{vals}/{steps}"] = row

    # the kernel's own outputs against its plain version's, per lane: the
    # evaluations, neg_ll and the factors. Every lane makes the plain
    # version's evaluations, except at the CLI's values and budget in
    # float32, where near-tie accepts move (above): there at least
    # SAME_COUNT_MIN lanes must, and those are held to the bounds.
    ls = torch.tensor([rcfg.learning_rate, rcfg.stop_thresh,
                       rcfg.min_learning_rate], device=device)
    b5 = {dtype: dict(max_abs_err=0.0) for dtype in ("float32", "bfloat16")}
    b5_checks = {}
    b5_index = {bf16: pk.rated_index(prob.rated, prob.R_obs, bf16=bf16)
                for bf16 in (False, True)}
    for vals in tile_vals:
        fargs = (rst.U.mT.contiguous(), rst.V.mT.contiguous(), prob.R_obs,
                 prob.rated, ti, tj, tile_vals[vals], sig, ls)
        for steps in (8, FIT_BUDGET):
            for bf16 in (False, True):
                dtype = "bfloat16" if bf16 else "float32"
                got = pk.pmf_lookahead_fused_cuda(*fargs, steps, bf16,
                                                  index=b5_index[bf16])
                again = pk.pmf_lookahead_fused_cuda(*fargs, steps, bf16,
                                                    index=b5_index[bf16])
                check(all(torch.equal(g, a) for g, a in zip(got, again)),
                      f"the fused kernel's value, factors, evaluations or "
                      f"accepts are not bitwise the same over two runs "
                      f"({vals}, "
                      f"{steps} steps, {dtype})")
                want, plain_ms = timed_ms(lambda: pk.pmf_lookahead_fused_plain(
                    *fargs, steps, bf16))
                evals, accepts = got[3], got[4]
                same = evals == want[3]
                n_same = int(same.sum())
                row = dict(lanes_same_evals=n_same,
                           lanes_same_accepts=int((accepts == want[4]).sum()),
                           evals_max=int(evals.max()),
                           evals_mean=float(evals.float().mean()),
                           f_rel_all_lanes=rel(got[0], want[0]))
                if n_same:
                    k, p = ([x[same].float() for x in out[:3]]
                            for out in (got, want))
                    row.update(
                        f_rel=rel(k[0], p[0]),
                        factor_scaled=max(
                            ((a - b).abs() / (1 + b.abs())).max().item()
                            for a, b in zip(k[1:], p[1:])),
                        max_abs_err=max((a - b).abs().max().item()
                                        for a, b in zip(k, p)))
                    b5[dtype]["max_abs_err"] = max(b5[dtype]["max_abs_err"],
                                                   row["max_abs_err"])
                b5_checks[f"{vals}/{steps}/{dtype}"] = row
                near_tie = vals == "cli" and steps == FIT_BUDGET and not bf16
                tol = FUSED_KERNEL_TOL
                check(n_same >= (SAME_COUNT_MIN if near_tie else PK_TILE)
                      and row["f_rel"] <= tol["f"]
                      and row["factor_scaled"] <= tol[
                          "factors_long" if near_tie else "factors"],
                      f"fused kernel disagrees with plain version ({vals}, "
                      f"{steps} steps, {dtype}): {row}")
                if vals != "cli" or steps != FIT_BUDGET:
                    continue
                # timed at the CLI's values and budget: the kernel's
                # wrapper on the refit's index (buffers, the check of the
                # cells, the launch); the public function without an index,
                # which builds one (what earlier readings of this kernel
                # timed); the launch alone by the profiler's device time.
                # Bytes: the index once (pointers, columns, R's values,
                # rows, positions), the base factors and the lanes' cells
                # in, the lanes' factors, values and evaluations out;
                # operations, on each rated cell and lane cell: pred, 2 d
                # flops, at every evaluation each lane made; Gu and Gv, 4 d,
                # at the start and where a proposal was accepted (a rejected
                # proposal's gradients are not part of the function)
                def launch():
                    return pk.pmf_lookahead_fused_cuda(
                        *fargs, steps, bf16, index=b5_index[bf16])

                ms = cuda_ms(launch, 3)
                call_ms = cuda_ms(lambda: pk.pmf_lookahead_fused_t(
                    *fargs, max_steps=steps, bf16=bf16), 3)
                device_ms = kernel_device_ms(launch, "fused", reps=3)
                nnz = b5_index[bf16].nnz
                lane_cells = nnz + (~prob.rated[ti, tj]).to(torch.int64)
                flops = D * int(((2 * evals.to(torch.int64)
                                  + 4 * (1 + accepts.to(torch.int64)))
                                 * lane_cells).sum())
                isz = 2 if bf16 else 4
                n_bytes = ((N + M + 2) * 4 + nnz * (12 + isz)
                           + (N + M) * D * 4 + PK_TILE * (N + M) * D * isz
                           + PK_TILE * (12 + 8))
                bms, bby = bound_ms(n_bytes, flops, dtype)
                b5[dtype].update(
                    ms=ms, call_ms=call_ms, device_ms=device_ms,
                    plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
                    flops=flops, bytes=n_bytes, evals_max=int(evals.max()),
                    accepts_mean=float(accepts.float().mean()),
                    accepts_of_slowest_lane=int(accepts[evals.argmax()]),
                    evals_mean=float(evals.float().mean()),
                    us_per_evaluation=1e3 * device_ms / int(evals.max()))
    # a lane's factors at d = 32 (336 KB) do not fit a block's shared
    # memory: the same search with the gathers on the spare set in global
    # memory and e in a scratch buffer, held to the plain version
    gen = torch.Generator(device=device).manual_seed(11)
    wide = [0.2 * torch.rand(32, k, generator=gen, device=device)
            for k in (N, M)]
    b5_global = {}
    for bf16 in (False, True):
        dtype = "bfloat16" if bf16 else "float32"
        gargs = (*wide, prob.R_obs, prob.rated, ti[:8], tj[:8], tv[:8], sig,
                 ls)
        before = pk.pmf_lookahead_fused_cuda.variants["global"]
        got = pk.pmf_lookahead_fused_cuda(*gargs, PK_REFIT_STEPS, bf16,
                                          index=b5_index[bf16])
        again = pk.pmf_lookahead_fused_cuda(*gargs, PK_REFIT_STEPS, bf16,
                                            index=b5_index[bf16])
        check(pk.pmf_lookahead_fused_cuda.variants["global"] == before + 2,
              "d = 32 at full shape did not take the global variant")
        want = pk.pmf_lookahead_fused_plain(*gargs, PK_REFIT_STEPS, bf16)
        row = b5_global[dtype] = dict(
            lanes=8, d=32, steps=PK_REFIT_STEPS,
            lanes_same_evals=int((got[3] == want[3]).sum()),
            evals_max=int(got[3].max()), f_rel=rel(got[0], want[0]),
            factor_scaled=max(
                ((a.float() - b.float()).abs() / (1 + b.float().abs()))
                .max().item() for a, b in zip(got[1:3], want[1:3])),
            ms=cuda_ms(lambda: pk.pmf_lookahead_fused_cuda(
                *gargs, PK_REFIT_STEPS, bf16, index=b5_index[bf16]), 3))
        check(all(torch.equal(g, a) for g, a in zip(got, again))
              and row["lanes_same_evals"] == 8 and row["evals_max"] > 1
              and row["f_rel"] <= FUSED_KERNEL_TOL["f"]
              and row["factor_scaled"] <= FUSED_KERNEL_TOL[
                  "factors_bf16_moving" if bf16 else "factors"],
              f"fused kernel, global-memory variant ({dtype}): {row}")
    b5_variants = dict(pk.pmf_lookahead_fused_cuda.variants)
    check(b5_variants.get("shared", 0) > 0 and b5_variants.get("global", 0) > 0,
          f"not both variants of the fused kernel ran: {b5_variants}")

    print(json.dumps(dict(phase="fused_refit", lanes=PK_TILE,
                          kernel_launches=fused_launches,
                          index_builds=fused_index[0], refits=fused_index[1],
                          variants=b5_variants, checks=fcheck,
                          rtol=FUSED_RTOL, bf16_rtol=FUSED_BF16_RTOL,
                          kernel_vs_plain=b5_checks,
                          global_variant=b5_global,
                          kernel_tol=FUSED_KERNEL_TOL, kernel=b5)), flush=True)

    # A figure, no gate: how much of the add_rmse_boosts ranking survives
    # the float32 refit's sensitivity to summation order. On the pool of
    # phase 8, the boosts from the float32 fused kernel (and from the
    # unfused float32 kernel path the CLI takes) against those of the plain
    # proposal loop run in float64, all at the CLI's 200 steps.
    from amf_tpu_torch.ops.linesearch import adaptive_descent

    real_t = torch.as_tensor(real, device=device)  # float64
    test_t = torch.as_tensor(knowable & ~known_np & ~pool, device=device)
    pool_flat = torch.nonzero(torch.as_tensor(pool, device=device).flatten())
    pi, pj = pool_flat[:, 0] // M, pool_flat[:, 0] % M
    pv = real_t[pi, pj]

    def rmses(U, V):
        return torch.cat([add_rmse_boosts.masked_rmse(
            U[c:c + 8].double() @ V[c:c + 8].double().mT, real_t, test_t)
            for c in range(0, U.shape[0], 8)])

    def refit_f64(s):
        U0 = rst.U.double().expand(CLI_TILE, N, D).contiguous()
        V0 = rst.V.double().expand(CLI_TILE, M, D).contiguous()
        a64 = (prob.R_obs.double(), prob.rated, pi[s], pj[s], pv[s],
               sig.double())

        def value_and_grad(uv):
            f, gu, gv = pk.pmf_batched_value_grad_reference(*uv, *a64)
            return f, (gu, gv)

        (U, V), info = adaptive_descent(
            (U0, V0), value_and_grad,
            lambda uv, g, lr: tuple(x + lr[:, None, None] * gx
                                    for x, gx in zip(uv, g)),
            lr0=rcfg.learning_rate, stop_thresh=rcfg.stop_thresh,
            min_lr=rcfg.min_learning_rate, max_steps=FIT_BUDGET)
        return U, V

    r0 = float(add_rmse_boosts.masked_rmse(
        rst.U.double() @ rst.V.double().mT, real_t, test_t))
    boosts = {"f64_plain": [], "f32_fused": [], "f32_unfused": []}
    t0 = time.perf_counter()
    for c in range(0, CLI_POOL, CLI_TILE):
        s = slice(c, c + CLI_TILE)
        lane = (rst, prob, pi[s], pj[s], pv[s].float(), rcfg)
        boosts["f64_plain"].append(r0 - rmses(*refit_f64(s)))
        boosts["f32_fused"].append(r0 - rmses(*pmf.fit_lookahead_batch(
            *lane, max_steps=FIT_BUDGET, lane_block=PK_LANE_BLOCK,
            fused=True)[:2]))
        boosts["f32_unfused"].append(r0 - rmses(*pmf.fit_lookahead_batch(
            *lane, max_steps=FIT_BUDGET)[:2]))
    torch.cuda.synchronize()
    boosts = {k: torch.cat(v).cpu().numpy() for k, v in boosts.items()}
    b64 = boosts["f64_plain"]
    print(json.dumps(dict(
        phase="boost_ranking_f32_vs_f64", pool=CLI_POOL, steps=FIT_BUDGET,
        seconds=time.perf_counter() - t0, base_rmse=r0,
        boost_f64_mean=float(b64.mean()), boost_f64_std=float(b64.std()),
        **{f"{k}_{name}": val for k in ("f32_fused", "f32_unfused")
           for name, val in (
               ("spearman_vs_f64", spearman(boosts[k], b64)),
               ("max_abs_diff_vs_f64", float(np.abs(boosts[k] - b64).max())),
               ("same_best_cell", bool(boosts[k].argmax() == b64.argmax())),
               ("top10_shared", len(set(np.argsort(-boosts[k])[:10])
                                    & set(np.argsort(-b64)[:10]))))})),
        flush=True)
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

    # the S-given entry's bound: S's lower triangle, b, z in and x out
    chol_bound = bound_ms(
        (D * (D + 1) // 2 + 3 * D) * 4 * main_row["B"],
        (D ** 3 / 3 + 2 * D ** 2) * main_row["B"], "float32")
    b4 = "amf_tpu/ops/pallas_kernels.py:39"
    b2 = "amf_tpu/ops/pallas_kernels.py:194"
    print(json.dumps({"kernels": [{
        # the entry the main path calls, fed from the Gram (160 lanes x 1682
        # rows); the S-given entry of the same source, which no main path
        # calls any more, rides along under its own keys
        "name": "chol_solve_sample (Gram-fed)", "route": "cuda",
        "source": "amf_tpu_torch/csrc/chol_solve_sample.cu",
        "replaces": "amf_tpu/ops/chol_kernel.py:41",
        "launches": main_launches,
        "max_abs_err": max(r["max_abs_err"] for r in gram),
        **{k: gram_row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "gram_to_x_ms", "gram_to_x_assembled_ms")},
        "library_ms": None,
        "s_given_entry": {
            "max_abs_err": max(r["max_abs_err"] for r in kern),
            "ms": main_row["ms"], "launch_only_ms": main_row["launch_only_ms"],
            "plain_ms": main_row["plain_ms"], "bound_ms": chol_bound[0],
            "bound_by": chol_bound[1]},
    },
        vg_entry("L,rows,d", "float32", b4,
                 cli_launches[("L,rows,d", "torch.float32")]),
        vg_entry("L,d,rows", "float32", b2,
                 refit_launches[("L,d,rows", "torch.float32")]),
        vg_entry("L,d,rows", "bfloat16", b2,
                 refit_launches[("L,d,rows", "torch.bfloat16")]),
        *({"name": f"pmf_line_coeffs {dtype}", "route": "cuda",
           "source": "amf_tpu_torch/csrc/pmf_line_coeffs.cu",
           "replaces": "amf_tpu/ops/pallas_kernels.py:386",
           "launches": poly_launches[f"torch.{dtype}"],
           "max_abs_err": max(r["max_abs_err"] for r in lc
                              if r["dtype"] == dtype),
           **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "device_ms", "call_ms")},
           "library_ms": None}
          for dtype in ("float32", "bfloat16")
          for row in [next(r for r in lc if r["dtype"] == dtype
                           and r["L"] == PK_TILE)]),
        *({"name": f"pmf_lookahead_fused {dtype}", "route": "cuda",
           "source": "amf_tpu_torch/csrc/pmf_lookahead_fused.cu",
           "replaces": "amf_tpu/ops/pallas_kernels.py:577",
           "launches": fused_launches[f"torch.{dtype}"],
           **{k: b5[dtype][k] for k in (
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "device_ms", "call_ms", "evals_max", "us_per_evaluation")},
           "library_ms": None}
          for dtype in ("float32", "bfloat16")),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
