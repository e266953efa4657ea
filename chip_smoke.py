#!/usr/bin/env python3
"""Smoke run of the PyTorch port (amf_tpu_torch) on one CUDA card.

Drives the port's two main paths at the MovieLens-100k shape of the JAX
package's ``bench.py`` (943 x 1682, d=10, ratings 1..5) and checks every
hand-written kernel of them against its plain PyTorch version on the card:

  * the Gibbs BPMF ``exp-variance`` one-step lookahead and its active loop
    (a 128-sample base chain, 30-sample lane chains, 32 candidates x 5
    values = 160 lanes a tile), through the Cholesky solve-and-sample kernel
    and the lane-noise kernel (every lane's round noise in one launch);
  * the PMF-refit lookahead (``fit_lookahead_batch``, tiles of 128 lanes)
    and its ``add_rmse_boosts`` CLI, through the value+gradient kernel;
    its poly-LS epoch loop through the value+gradient and line-coefficient
    kernels; its fused branch through the whole-line-search kernel;
  * the same paths at factor width d = 48, above the 32 that one library of
    each source serves, through libraries built for that width;
  * the variational ActivePMF lookahead at the shape of ``bench.py``'s vn
    workload (24 x 24, d = 2), its active loop (vn and mn) and the port's
    ``entry()`` step; this path runs PyTorch's linear algebra and no
    hand-written kernel;
  * the NUTS BPMF path (the reference's Stan path) at the reference's
    DrugBank stan shape (94 x 425, d = 20) and at the MovieLens shape: base
    chains, lookahead tiles, its stan loop with a checkpoint and a resume,
    and its ``bpmf`` CLI; this path runs autograd and no hand-written
    kernel;
  * RatingConcentration (the maxent dual on a lane-batched projected
    L-BFGS) at the MovieLens shape in float64, its loop and ``active_rc``
    CLI; cold-start BPMF at the MovieLens shape with 10 % new items, d =
    20, and its ``bpmf_newitems`` CLI; the PMF ``lbfgs`` and ``mini-valid``
    fit types; these run PyTorch's dense tensor code and no hand-written
    kernel.
  * MMMF (the ADMM nuclear-norm solver, max-norm and ordinal variants) at
    the reference's DrugBank shape (94 x 425), its loop and ``active_mmmf``
    CLI: cuSOLVER's eigh and cuBLAS, no hand-written kernel; and the scan
    sweeps of ``active/scan_loop`` (vn, Gibbs, stan) beside their host
    loops, the Gibbs exp-variance sweep through the Cholesky kernel.
  * the result tools and the experiment runner: ``get_samples`` at the
    MovieLens shape and ``get_criteria`` through the Cholesky kernel, the
    ``experiment`` runner's five arms of ``10x10_discrete2_d2`` (its bayes
    arm through the Cholesky kernel), the parity checks on what it wrote
    and on copies of committed experiment directories, and the text CLIs.
  * candidate and chain sharding (``parallel/``): phase 3's tile through
    ``sharded_candidate_scores`` on a world of one over NCCL and on two
    ranks sharing the card over gloo (and over NCCL on two cards where
    there are two), each rank's lane chains through the Cholesky kernel;
    ``bayes_pmf --shard-candidates 1``; the sharded dry run.
  * the port's bench (``python -m amf_tpu_torch.bench``) in this process:
    its rows (the Gibbs headline through the Cholesky kernel, with its
    numpy pool baseline; the PMF-refit row through the value+gradient
    kernel; the vn rows) and its one JSON line.

    python3 chip_smoke.py

Phases (each raises on failure):
  1. environment and kernel builds (one nvcc per library, in parallel, at
     first use, into build/: every source for d <= 32 and for d = 48, the
     fused line search, the masked Gram and the Cholesky kernel one library
     a factor width: the Cholesky kernel at every width phase 2 takes), each
     nvcc's seconds;
  2. Cholesky kernel vs plain version, both entry points: S given, at the
     main path's batch sizes and at other d; fed from the Gram, at the main
     path's two row draws (160 lanes, r = 943 and 1682), ragged and at
     other d, with and without centre and cells; and the time from the
     Gram products to x the earlier way (assembly in PyTorch, then the
     S-given entry) beside the Gram-fed one;
  3. the f32 Gibbs lookahead tile, the first timed tile of phase 37's
     headline (its rates are the bench's): finite scores, the Gram-fed
     kernel launched 120 times a tile, plain unused; the profile of a tile;
  4. the active loop (run_active_gibbs), 3 records on a 64-cell pool;
  5. the same tile in f64 through the kernel and through the plain version;
  6. value+gradient kernel vs plain version, both layouts, f32 and bf16, at
     L=128 lanes and at ragged shapes, with times; the variant that leaves
     the factors in global memory at d=32; the value bit for bit over two
     runs;
  7. the bench's lane-blocked refit: 1024 candidates in 8 tiles, bf16 (phase
     37's refit row) and f32, and the f32 kernel tile vs the plain refit;
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
     times; its global-memory variant at d=32 and d=48, its shared-memory
     variant at d=48 on a 97 x 131 problem; and, as a figure, the rank
     correlation of the float32 boosts of phase 8's pool against a float64
     plain refit.
 12. d = 48: one add_rmse_boosts -D 48 tile (128 lanes), a 10-lane Gibbs
     lookahead tile, one poly-LS and one fused refit tile of 8 lanes in
     float32 and in bfloat16, each launching its kernels and no plain
     version (phases 2, 6, 9 and 11 hold each kernel against its plain
     version at d = 48 at these lane counts: B1 at both row draws, B4 at
     128 lanes, B2, B3 and B5 at 8);
 13. the vn lookahead, bench.py's vn workload (total-variance, 50 + 50
     refit steps, 8 nodes, tiles of 64 candidates, f32): phase 37's vn
     rows (every candidate with cov_param="chol", one 8-candidate tile
     with "psd-project"), every score finite; a 4-candidate psd-project
     tile's host-side split (eigh, slogdet, autograd, the lane refit);
 14. float64 tiles of total-variance and pred-entropy-bound-approx on the
     card and on the CPU from the same inputs and lane noise, <= 1e-8;
 15. run_active_pmf: 2 records for vn (pred-variance, total-variance) and 2
     for mn (pred-variance, total-variance-approx, on a 12 x 12 problem);
 16. the port's entry() step.
 17. NUTS base chains at the DrugBank shape, f32, 100 draws after 50
     warmup: 4 chains as lanes and 1 chain, each from a PMF MAP warm start:
     wall time, leapfrogs/s, tree depth, divergences, lp__ split-R-hat and
     ESS, syncs a transition, peak memory;
 18. one NUTS base chain at the MovieLens shape (d = 5, 100 draws after
     50 warmup), the same readings;
 19. NUTS lookahead tiles at the DrugBank shape from phase 17's chain:
     exp-variance over 16 candidates x 5 values (80 lanes, 50 draws
     after 25 warmup) and exp-entropy-est over 2 (30 after 15): every
     score finite,
     tile time, lockstep against the lanes' mean leapfrogs, syncs; and the
     profiler's split of one 80-lane transition (potential, RNG, syncs);
 20. float64 card against CPU (12 x 10, d = 3, 6 lanes) on the same
     recorded noise: one transition, and each draw of a 20 + 10 chain from
     the card's draw before it, <= 1e-8 scaled; the chains' trees and
     adaptation the same; the freely run chains' drift as a figure;
 21. run_active_stan, 3 records (random, pred-variance, exp-variance) on a
     12-cell pool, against a run stopped at 2 records with a checkpoint and
     resumed to 3; the ``bpmf`` CLI with ``--checkpoint``.
 22. the maxent fit at the MovieLens shape, float64 (17 features, 89,250
     multipliers): iterations, final projected-gradient norm, search
     trials, wall time;
 23. a maxent lookahead tile there: 8 candidates x 5 values (40 lanes) of
     60 warm-started iterations, every score finite, tile time, peak
     memory, the lanes' mean iterations against the lockstep count; and
     float64 card against CPU on the 10 x 10 experiment data
     (experiments/10x10_discrete2_d2), every candidate, 20 iterations,
     <= 1e-8;
 24. run_active_rc on that data, all four keys, 3 records, against a run
     stopped at 2 with a checkpoint and resumed to 3; the ``active_rc``
     CLI stopped and resumed;
 25. cold start at the MovieLens shape, the last 168 columns new, d = 20,
     f32: phase 1 (60 draws after 30 on the old columns), the phase-2
     chain (100 after 50) and an exp-variance tile of 16 candidates x 5
     values (80 lanes, 100 after 50): wall times, tree depth,
     divergences, peak memory, every score finite;
 26. the ``bpmf_newitems`` CLI with ``--initial-fit-file`` and
     ``--checkpoint`` on a 12 x 10 problem, stopped and resumed;
 27. the PMF fit types at the MovieLens shape, d = 10, f32: batch, lbfgs
     and mini-valid (their log posteriors), one mini-valid epoch eager and
     as one CUDA graph, in turns, and three graphed epochs against three
     eager ones in float64, <= 1e-8.
 28. MMMF's ADMM solve at the DrugBank shape (94 x 425, f64, C = 1, to
     1e-6 within 2,000 iterations) and at 472 x 413 in f32 (to 1e-5), each
     against the same solve on the CPU by the objective, with its
     iterations, ms an iteration, eigh's share and host reads an
     iteration; a solve at the MovieLens shape capped at 100 iterations;
     the max-norm and the ordinal solvers once each at the DrugBank shape;
 29. run_active_mmmf at the DrugBank shape, 5 selectors x 3 records, f64,
     its re-solves capped at 500 ADMM iterations; a run stopped at 2
     records with a checkpoint and resumed to 3 against it; the
     ``active_mmmf`` CLI once;
 30. the scan sweeps: a device-only stub family under sync debug mode
     "error" (the sweep's own step reads nothing); beside each its host
     loop from the same state and seeds, with records, seconds and host
     reads a step: vn pred-variance on phase 15's problem (and phase 15's
     records), the Gibbs sweeps at the MovieLens shape (pred-variance, and
     exp-variance on a 64-cell pool through the Cholesky kernel, counted,
     never its plain version), the stan sweep on 12 x 10.
 31. the ``get_samples`` CLI at the MovieLens shape (phase 3's ratings,
     d = 10, f32, 128 draws): the draws' shapes, every draw finite, the
     Gram-fed kernel launched once a row draw, seconds a draw;
 32. the ``get_criteria`` CLI at its defaults (10 x 10, d = 2, 2 steps,
     f64): the Gram-fed kernel launched, the pairwise Kendall-tau lines,
     every map finite on exactly the cells still queryable;
 33. ``python -m amf_tpu_torch.run.experiment 10x10_discrete2_d2 --steps 2
     --device cuda`` with its five arms (apmf, stan, bayes, mmmf, rc) and
     the draws of the stan and bayes arms cut by the runner's ``--set``,
     each arm a process of its own that reports its Cholesky counts at its
     exit (the bayes arm launches the Gram-fed kernel); then, in this process,
     ``check_experiment_dir`` on what it wrote (the structural and
     initial-state rows must pass; the learning bands are printed, not
     asserted: two steps cannot show learning) and the text paths of
     ``plot_results --aucs``, ``plot_aucs`` and ``compare_firsts``;
 34. ``check_experiment_dir`` on copies of the committed
     ``experiments/10x10_discrete2_d2`` (99 rows, hard_ok true) and
     ``experiments/drugbank-94x425`` (25 rows, hard_ok false).
 35. sharding at phase 3's width: (a) a world of one over NCCL in this
     process scores phase 3's 32 candidates through
     ``parallel.sharding.sharded_candidate_scores``: bit for bit phase 3's
     scores where a rerun of phase 3's tile repeats them bit for bit, the
     Gram-fed kernel launched 120 times, the plain version never; (b) two
     ranks sharing the card over gloo (``parallel.mesh.launch``, gloo
     named), 64 candidates in tiles of 32 so that each rank scores one of
     the unsharded run's tiles: the scores to 1e-6 relative with the same
     argmin, each rank's tile (a warm-up run, then the one read) through
     the Gram-fed kernel alone, each rank's seconds, the gather's ms and
     the seconds from the launch to the first collective; (c) the same
     over NCCL on two cards where the host has two, else a line saying
     it was skipped; (d) the ``bayes_pmf`` CLI on 24 x 30 with and without
     ``--shard-candidates 1``: the same records.
 36. ``entry.dryrun_multichip(2)`` on two ranks sharing the card (gloo,
     float64) against ``parallel.dryrun.dryrun_step`` unsharded in this
     process: every family's scores to 1e-6 relative, 4 NUTS chains split
     2 ways against 4 as lanes (draws, mode, adaptation) to 1e-5, the same
     picks.
 37. (run after phase 1, before 2) the port's bench,
     ``amf_tpu_torch/bench.py``, in this process through ``bench.run``:
     the headline at full shape (the MAP fit, the 128-sample base chain, a
     warm tile, 8 timed tiles of 32 candidates, 1 and then 3 tiles for the
     device-only rate) with its numpy pool baseline, the refit row and the
     chol vn row in full, the psd-project row cut to one tile of 8
     candidates; its line printed (``bench-line``), parsed and checked:
     platform cuda, the card's nvidia-smi line, every rate non-null and
     positive, no secondary fault, vs_baseline = value / pool to its
     rounding; the Gram-fed kernel launched once a row draw (512 in the
     base chain, 120 a headline tile) and the plain version never, the
     refit row through the bf16 lane-blocked value+gradient kernel alone
     (one index build a refit tile).
 38. (run after phase 2, before 3) the lane-noise kernel, N1, against the
     per-lane ``normal_`` and ``_standard_gamma`` calls it replaces, at
     both lookahead cells' rounds (160 lanes of 105,840 normals and 512
     of 15,880, each with 40 Gamma variates at the cell's Bartlett shapes;
     f32 and f64): two rounds through ``LaneStreams`` against the per-lane
     calls on fresh copies of the same generators, ``torch.equal`` on
     every value and the generators' offsets after both, one launch a
     round; its times beside the per-lane calls' and its byte bound
     (``probe_kernels.noise_cell_rows``). Phase 4 counts N1's launches from
     0: one a Gibbs round of its chains.
Phases 31, 33 and 34 each run inside ``utils/profiling.device_trace`` (a
Chrome trace of the card under build/chip_smoke_results/; phase 32 outside
it, whose millions of launches take the profiler minutes to write), each
phase with the Cholesky counts set to 0 just before and read just after;
none imports matplotlib or JAX.
The launch counts are reset before phases 37, 7, 8, 10, 11, each run of
12, each Gibbs exp-variance run of 30 and each tile of 35 (in each rank's
own process), and read after phases 37, 4, 7, 8, 10, 11, each run of 12,
each such run of 30 and each tile of 35, before the
comparisons with the plain versions; phases 7, 8 and 10 also count the
index builds (one a refit).
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
import warnings
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
# the masked Gram from the rated-cell index against its plain version,
# relative Frobenius (other summation orders of the same products)
GRAM_INDEX_RTOL = {"float32": 1e-5, "float64": 1e-12}
# a poly-LS budget at the CLI's values where rungs are rejected (at 8 steps
# none is) and summation order has moved few lanes (at 200, 20 of 128)
POLY_LADDER_STEPS = 40
# the card's published peaks (H100 SXM data sheet, dense)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {"float32": 67e12, "float64": 67e12, "bfloat16": 989e12}
# a factor width above the 32 that one library of each source serves: its
# kernels come from libraries built for it; its Gibbs tile (candidates,
# chains) and its refit tiles' lanes
WIDE_D = 48
WIDE_GIBBS_CAND, WIDE_GIBBS_BASE, WIDE_GIBBS_LANE = 2, 16, 4
WIDE_REFIT_LANES = 8
# the vn workload of bench.py:184-250 (amf_tpu_torch/bench.py's CARD): 24 x
# 24, rank and d 2, mask 0.2, PMF fit 200 steps, base KL fit 100, lane
# refits 50 + 50 steps, 8 Gauss-Legendre nodes, tiles of 64 candidates,
# total-variance, float32
VN_N, VN_D, VN_REFIT_STEPS, VN_NODES, VN_TILE = 24, 2, 50, 8, 64
# the bench's psd-project row cut to one tile of 8 candidates (64 until
# phases 22-27 came: ~44 s, 97 % eigh; 16 until phases 31-34 came), so that
# the smoke keeps to its time; its host-side split on 4
VN_PSD_CAND, VN_SPLIT_CAND = 8, 4
VN_MN_N = 12
# card against CPU in float64: the same inputs and lane noise, the same
# operations in other kernels' orders; tiles of 8 and 4 candidates
VN_F64_TILE, VN_PEB_TILE, VN_F64_RTOL = 8, 4, 1e-8
# the NUTS BPMF path (phases 17-21). The reference's DrugBank stan
# configuration: 94 x 425, d = 20, 200 draws after 100 warmup
# (BENCHMARKS.md:243-244), here 100 after 50 so that the smoke keeps well
# inside its time (a transition runs ~220 leapfrogs: PERF.md §5; at 60
# after 30 the chains' acceptance fell to 0.0004-0.014), on synthetic
# ratings 1..5, f32; 1 chain and 4 chains as lanes
DB_N, DB_M, DB_D, DB_SAMPS, DB_WARMUP, DB_CHAINS = 94, 425, 20, 100, 50, 4
# MovieLens shape (bench.py) at HMCConfig's d = 5 and the CLI's 100 draws
# after 50 warmup
ML_D, ML_SAMPS, ML_WARMUP = 5, 100, 50
# a lookahead tile at the DrugBank shape: 16 candidates x 5 values = 80
# lanes (exp-variance; 32 until phases 31-34 came) at half the CLI's
# lookahead budget, 50 draws after 25 warmup (100 after 50 until phases
# 35-36 came), and 2 candidates (exp-entropy-est; 8 until phases 22-27
# came, 4 until phases 35-36) at 30 after 15, so that the smoke keeps to
# its time (its matrix-normal fit streams every draw at every sweep:
# PERF.md §5; at 20 draws after 10 its fits give NaN)
LA_CAND, LA_ENT_CAND = 16, 2
LA_BUDGET = {"total-variance": (50, 25), "entropy-est": (30, 15)}
# float64 card against CPU: 12 x 10, d = 3, 6 lanes, a chain of 20 warmup
# and 10 draws, the same noise on both. One transition, and each draw of
# the chain from the card's draw before it, agree to NUTS_F64_TOL; the
# chain run freely on each side drifts apart as a few-ulp change of its
# start does on one side (PERF.md §6), so that drift is a figure
NUTS_F64 = dict(n=12, m=10, d=3, lanes=6, warmup=20, draws=10)
NUTS_F64_TOL = 1e-8
# the stan loop: 3 records on a 24 x 30 problem with a 12-cell pool, a
# checkpoint after 2 and a resume to 3; the CLI on a 12 x 10 problem
STAN_N, STAN_M, STAN_D, STAN_POOL = 24, 30, 5, 12
# RatingConcentration (phases 22-24): the fit and a lookahead tile at the
# MovieLens shape in float64 (17 features for ratings 1..5, a dual of
# 2 (n + m) 17 = 89,250 multipliers), 8 candidates x 5 values = 40 lanes
# (16 until phases 31-34 came, so that the smoke keeps to its time) of 60
# warm-started iterations; the card against the CPU, the loop and the CLI
# on the reference experiment's own 10 x 10 data
RC_LA_CAND, RC_LA_ITERS, RC_F64_TOL = 8, 60, 1e-8
# the loop's and the CLI's refits are cut to 20 iterations (the CLI's
# default is 500) and their lookaheads, and the card-vs-CPU check's, to 20
# (60), so that phases 23-24 keep to their time: a refit there is
# launch-bound, ~30 search trials an iteration (PERF.md §5)
RC_LOOP_ITERS, RC_SHORT_LA_ITERS = 20, 20
RC_SMALL = ROOT / "experiments" / "10x10_discrete2_d2" / "data.pkl"
# cold start (phase 25): movielens-58k-newmovies-10pct-20d's configuration
# (experiments/README.md:48-49) on synthetic ratings at the MovieLens shape:
# the last 168 columns (10 %) new, d = 20, f32, the CLI's phase-2 chain of
# 100 draws after 50 and lookahead of 100 after 50 over 16 candidates x 5
# values (80 lanes; 32 until phases 31-34 came); phase 1 (the CLI: 200
# draws after 100) is cut to 60 draws after 30, so that the smoke keeps to
# its time
CS_NEW, CS_D, CS_SAMPS, CS_FIT, CS_LA_CAND = 168, 20, 100, 60, 16
# the fit types (phase 27) at the MovieLens shape, d = 10, f32: mini-valid
# with batches of 1,000 cells (1,587 steps an epoch), 500 validation cells,
# the learning rate of the JAX package's test (tests/test_pmf.py:158), at
# most 20 epochs
FT_D, FT_BATCH, FT_VALID, FT_LR, FT_MAX_EPOCHS = 10, 1000, 500, 0.2, 20
# the graphed mini-valid epochs against the eager ones, float64, scaled
FT_GRAPH_TOL = 1e-8
# MMMF (phases 28-29): the DrugBank MMMF configuration
# (experiments/drugbank-94x425-5to1: 94 x 425 +-1 labels, C = 1, float64,
# ADMM to 1e-6 within 2000 iterations, 500 labels known and 1,500 held
# out) on synthetic labels, 5 negatives to 1 positive; the newmovies-20d
# solve's shape (amf_tpu/models/mmmf.py:53-56: 472 x 413, float32, the
# CLI's f32 tolerance 1e-5) with 10 % of its labels known; the MovieLens
# shape's ratings >= 4 as labels, a solve capped at 100 iterations, as a
# figure. The max-norm solver runs its default 4,000 subgradient steps;
# the ordinal solver 500 of its 4,000 (every step an SVT), so that the
# phases keep to their time
MM_N, MM_M, MM_KNOWN, MM_TEST, MM_NEG_PER_POS = 94, 425, 500, 1500, 5
MM_F32_N, MM_F32_M, MM_F32_KNOWN = 472, 413, 0.1
MM_WIDE_ITERS, MM_ORD_ITERS = 100, 500
# card against CPU on a converged solve: the same program to the same
# tolerance, eigh in cuSOLVER against LAPACK (last bits, and so residual
# balancing, may differ): the objectives to 1e-6 relative in float64 and
# 1e-4 in float32
MM_OBJ_RTOL = {"float64": 1e-6, "float32": 1e-4}
# the loop: 5 selectors x 3 records, float64; the checkpointed run and its
# resume on one of them; the CLI, 2 records of one. Their re-solves run at
# most 500 ADMM iterations (the configuration's 2,000: at the synthetic
# DrugBank labels every solve runs to the cap, 4.4 s on an H100 80GB HBM3
# at 700 W, where the loop, its resume and the CLI took 96 s), so that the
# phases keep to their time
MM_LOOP_KEYS = ["max-margin", "max-margin-pos", "min-margin",
                "min-margin-pos", "random"]
MM_RESUME_KEYS = ["random"]
MM_LOOP_ADMM_ITERS = 500
# the scan sweeps (phase 30): phase 15's vn loop (pred-variance), 1 query;
# the Gibbs sweeps at the MovieLens shape: pred-variance 3 queries over the
# whole pool, exp-variance 2 queries over a 64-cell pool in tiles of 32
# candidates; the stan sweep on 12 x 10 (pred-variance, 2 queries, phase
# 21's 10 draws after 6); each beside the host loop from the same state
# and seeds
SCAN_GIBBS_STEPS, SCAN_EV_STEPS, SCAN_STAN_STEPS = 3, 2, 2
# the sweep against the host loop on the card: the same operations in the
# same order; errors to 1e-5 relative in float32 (scatter-adds' atomics
# may sum in either order), picks equal
SCAN_ERR_RTOL = 1e-5
# the result tools and the experiment runner (phases 31-34): get_samples
# at the MovieLens shape draws BASE_SAMPS; get_criteria at its defaults;
# the runner's five arms of 10x10_discrete2_d2 (the catalog's argv, the
# step budget set by the runner's --steps); parity on copies of two
# committed experiment directories, with the row counts and hard_ok the
# JAX package's checker gives there
EXP_NAME, EXP_ARMS, EXP_STEPS = (
    "10x10_discrete2_d2", ("apmf", "stan", "bayes", "mmmf", "rc"), 2)
# the runner's depth cut (--set), to phase 21's budget: the stan arm's
# draws 200 after 200 -> 10 after 6 and its lookahead's 100 after 50 -> 6
# after 4 (uncut, its nine NUTS fits of 400 transitions and two 450-lane
# lookaheads alone take far longer than the four phases may); the bayes
# arm's base chains 200 -> 10 draws and its lookahead chains 100 -> 6
EXP_SET = ("samps=10", "warmup=6", "lookahead-samps=6", "lookahead-warmup=4")
EXP_TIMEOUT_S = 600
COMMITTED_PARITY = {"10x10_discrete2_d2": (99, True),
                    "drugbank-94x425": (25, False)}


START = time.perf_counter()


def stamp(phase: str) -> None:
    """A phase's start, in seconds since the script began."""
    print(f"phase-start {phase} at {time.perf_counter() - START:.1f} s",
          flush=True)


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
             (4097, 32), (4097, WIDE_D)]
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
            # S's lower triangle, b, z in and x out; d^3/3 + 2 d^2 flops
            bms, bby = bound_ms(
                (d * (d + 1) // 2 + 3 * d) * S.element_size() * B,
                (d ** 3 / 3 + 2 * d ** 2) * B, name)
            # the launch alone, on buffers already in the kernel's layout
            s_t = S.reshape(B, d * d).t().contiguous()
            rhs_t, z_t = rhs.t().contiguous(), z.t().contiguous()
            launch_ms = cuda_ms(
                lambda: ck.chol_solve_sample_batch_minor(s_t, rhs_t, z_t), 20)
            row = dict(dtype=name, B=B, d=d, max_abs_err=max_abs,
                       scaled_err=scaled, tol=KERNEL_TOL[name], ms=ms,
                       launch_only_ms=launch_ms, plain_ms=plain_ms,
                       bound_ms=bms, bound_by=bby)
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
    from amf_tpu_torch.ops import gram_kernel

    gen = torch.Generator(device=device).manual_seed(2)
    beta = 2.0
    lanes = TILE * len(VALS)
    # (L, r, c, d, center, cells, timed): True times the entry both ways,
    # "light" times the wrapper and the plain version only
    wide_lanes = WIDE_GIBBS_CAND * len(VALS)  # phase 12's Gibbs tile
    cases = [(lanes, N, M, D, True, True, True),
             (lanes, M, N, D, True, True, True),
             (3, 301, 64, D, True, True, False),
             (wide_lanes, N, M, WIDE_D, True, True, "light"),
             (wide_lanes, M, N, WIDE_D, True, True, "light")]
    cases += [(5, 301, 64, d, ce, cl, False) for d in (1, 5, 20, 32, WIDE_D)
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
            Gt, mrt = gram_kernel.dense_gram(mask, masked_r, other)
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
                p = d * (d + 1) // 2
                row_out["bound_ms"], row_out["bound_by"] = bound_ms(
                    (p + 4 * d) * z.element_size() * L * r,
                    (d ** 3 / 3 + 2 * d ** 2 + 2 * p + 4 * d) * L * r, name)
            if timed is True:
                row_out["device_ms"] = kernel_device_ms(
                    lambda: ck.chol_gram_solve_sample(*args),
                    "chol_gram_kernel")
                # from the Gram products to x: earlier way, new, new, earlier
                sr = (other, mu, alpha, beta, z)
                side = gram_kernel.DenseRows(mask, masked_r)

                def old():
                    return sample_rows_assembled(ck, mask, masked_r, *sr,
                                                 center, cells)

                def new():
                    return bpmf_gibbs._sample_rows(side, *sr, center=center,
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
    for d in (1, 5, 32, WIDE_D):
        for bf16, tr in variants:
            rows.append(value_grad_case(pk, small_R, small_rated, 5, d, bf16,
                                        tr, gen, False))
    check(all(r["factors_in"] == "shared" for r in rows),
          "a case that fits shared memory took the global-memory variant")
    # at d = 32 a lane's factors (336 KB) do not fit a block's shared memory:
    # the same walk on the factors in global memory; d = 48 from a library
    # of that width, at the lanes phase 12 gives each layout: the CLI tile's
    # for (L, rows, d), the refit tile's for (L, d, rows)
    for d in (32, WIDE_D):
        for bf16, tr in ((False, False), (True, True)) if d == 32 else variants:
            L = CLI_TILE if d == WIDE_D and not tr else WIDE_REFIT_LANES
            row = value_grad_case(pk, R, rated, L, d, bf16, tr, gen, True)
            check(row["factors_in"] == "global",
                  f"d = {d} at full shape did not take the global variant: "
                  f"{row}")
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
    # device-side events only: a CPU op's own device time repeats its
    # kernels'. The events (~10^4 a tile) are averaged once
    averages = prof.key_averages()
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in averages
                      if e.device_type == DeviceType.CUDA),
                     key=lambda r: -r[1])
    busy = sum(r[1] for r in kernels)
    nonzero = sum(e.count for e in averages if e.key == "aten::nonzero")
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
    # the profiler may drop a launch at the window's edge: average over those
    # it recorded. Now and then it records no kernel of a window at all:
    # then the window is profiled again, up to three times, and if it still
    # records none, the ``reps`` calls are timed by CUDA events instead (the
    # launches queued back to back, so the wrapper's host time hides behind
    # the card's unless the kernel is shorter than it)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and name_part in e.key]
        seen = sum(e.count for e in hits)
        if seen:
            break
    if not seen:
        ms = cuda_ms(fn, reps)
        print(f"kernel-device-ms: the profiler recorded no {name_part} "
              f"kernel in 3 windows; {ms} ms a call by CUDA events",
              flush=True)
        return ms
    check(seen <= reps,
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

    for d in (3, 16, 32, WIDE_D):
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
    # block's shared memory: the same walk on them in global memory; d = 48
    # from a library of that width
    for d in (32, WIDE_D):
        for bf16 in (False, True):
            row = coeff_case(pk, random_case(WIDE_REFIT_LANES, N, M, d,
                                             prob.R_obs, prob.rated, 0.3),
                             bf16, True)
            check(row["factors_in"] == "global"
                  and row["lanes_on_rated_cells"] >= 1,
                  f"d = {d} at full shape did not take the global variant: "
                  f"{row}")
            rows.append(row)
    return rows


def wide_main_paths(device, prob, real, knowable, rng, work):
    """Phase 12: the main paths at d = 48, through the libraries built for
    that width: one ``add_rmse_boosts -D 48`` tile, a few lanes of the
    Gibbs lookahead, and one poly-LS and one fused refit tile in each
    dtype. The launch counts are reset before each and read after; no
    plain version may run. Returns each run's launches by kernel."""
    import numpy as np
    import torch
    from amf_tpu_torch.data.loaders import save_npz_schema
    from amf_tpu_torch.models import bpmf_gibbs, pmf
    from amf_tpu_torch.ops import chol_kernel as ck
    from amf_tpu_torch.ops import pmf_kernels as pk
    from amf_tpu_torch.run import add_rmse_boosts
    from amf_tpu_torch.types import rating_bounds
    from amf_tpu_torch.utils.rng import generator

    d = WIDE_D
    out = {}

    def reset():
        ck.chol_gram_solve_sample_cuda.launches = 0
        ck.chol_solve_sample_reference.calls = 0
        for k in (pk.pmf_value_grad_cuda, pk.pmf_line_coeffs_cuda,
                  pk.pmf_lookahead_fused_cuda):
            k.launches.clear()
        pk.pmf_value_grad_plain.calls = pk.pmf_line_coeffs_plain.calls = 0
        pk.pmf_lookahead_fused_plain.calls = 0

    def no_plain(what):
        check(ck.chol_solve_sample_reference.calls == 0
              and pk.pmf_value_grad_plain.calls == 0
              and pk.pmf_line_coeffs_plain.calls == 0
              and pk.pmf_lookahead_fused_plain.calls == 0,
              f"a plain version ran on the d = {d} {what}")

    # the add_rmse_boosts CLI, one tile of 128 lanes
    known_np = prob.rated.cpu().numpy()
    pool = np.zeros(N * M, bool)
    pool[rng.choice(np.flatnonzero(knowable & ~known_np), size=CLI_TILE,
                    replace=False)] = True
    pool = pool.reshape(N, M)
    data_path, out_path = work / "boosts48_data.npz", work / "boosts48.pkl"
    save_npz_schema(str(data_path), {"_real": real, "_known": known_np,
                                     "_test_on": knowable & ~known_np & ~pool})
    reset()
    t0 = time.perf_counter()
    add_rmse_boosts.main(["--load-data", str(data_path), "-D", str(d),
                          "--tile", str(CLI_TILE), "--out", str(out_path)])
    torch.cuda.synchronize()
    with open(out_path, "rb") as f:
        boosts = pickle.load(f)["boosts"]
    launches = pk.pmf_value_grad_cuda.launches[("L,rows,d", "torch.float32")]
    out["cli"] = dict(s=time.perf_counter() - t0, b4_launches=launches,
                      boosts_finite=int(np.isfinite(boosts).sum()))
    check(launches > 0, f"the d = {d} CLI tile never launched B4")
    check(bool((np.isfinite(boosts) == pool).all()),
          f"d = {d} boosts not finite exactly on the pool")
    no_plain("CLI tile")

    # the Gibbs exp-variance lookahead: 2 candidates x 5 values
    pcfg = pmf.PMFConfig(latent_d=d, subtract_mean=True)
    gcfg = bpmf_gibbs.GibbsConfig(latent_d=d, subtract_mean=True)
    pst = pmf.init_state(generator(48, device), N, M, pcfg, prob,
                         dtype=torch.float32, device=device)
    pst, _ = pmf.fit(pst, prob, pcfg, max_steps=100)
    reset()
    t0 = time.perf_counter()
    _, stats, _ = bpmf_gibbs.run_chain(
        bpmf_gibbs.init_chain(pst), prob, gcfg, WIDE_GIBBS_BASE,
        generator=generator(49, device),
        value_bounds=tuple(rating_bounds(VALS)))
    cand = torch.nonzero(prob.queryable.flatten())[:WIDE_GIBBS_CAND, 0]
    scores = bpmf_gibbs.exp_variance_scores(
        3, pst, prob, pcfg, gcfg, stats, VALS, num_samps=WIDE_GIBBS_LANE,
        fit_budget=50, cand=cand, n_base_samples=WIDE_GIBBS_BASE,
        poly_ls=True)
    torch.cuda.synchronize()
    out["gibbs"] = dict(s=time.perf_counter() - t0,
                        b1_launches=ck.chol_gram_solve_sample_cuda.launches,
                        scores=scores.tolist())
    check(bool(torch.isfinite(scores).all()),
          f"non-finite d = {d} Gibbs scores {scores}")
    check(ck.chol_gram_solve_sample_cuda.launches > 0,
          f"the d = {d} Gibbs tile never launched B1")
    no_plain("Gibbs tile")

    # one poly-LS and one fused refit tile of 8 lanes, in each dtype
    flat = torch.nonzero(prob.queryable.flatten())[:WIDE_REFIT_LANES, 0]
    di, dj = flat // M, flat % M
    dv = torch.as_tensor(real, dtype=torch.float32, device=device)[di, dj]
    for bf16 in (False, True):
        dtype = "bfloat16" if bf16 else "float32"
        reset()
        f_poly = pmf.fit_lookahead_batch(pst, prob, di, dj, dv, pcfg,
                                         max_steps=PK_REFIT_STEPS,
                                         lane_block=PK_LANE_BLOCK, bf16=bf16,
                                         poly_ls=True)[2]
        f_fused = pmf.fit_lookahead_batch(pst, prob, di, dj, dv, pcfg,
                                          max_steps=PK_REFIT_STEPS,
                                          lane_block=PK_LANE_BLOCK, bf16=bf16,
                                          fused=True)[2]
        torch.cuda.synchronize()
        row = out[f"refit_{dtype}"] = dict(
            b2_launches=pk.pmf_value_grad_cuda.launches[
                ("L,d,rows", f"torch.{dtype}")],
            b3_launches=pk.pmf_line_coeffs_cuda.launches[f"torch.{dtype}"],
            b5_launches=pk.pmf_lookahead_fused_cuda.launches[
                f"torch.{dtype}"],
            poly_vs_fused_max_rel=((f_poly - f_fused).abs()
                                   / f_fused.abs()).max().item())
        check(bool(torch.isfinite(f_poly).all()
                   and torch.isfinite(f_fused).all()),
              f"non-finite d = {d} {dtype} refit values")
        check(row["b2_launches"] > 0 and row["b3_launches"] > 0
              and row["b5_launches"] == 1,
              f"the d = {d} {dtype} refits did not launch B2, B3 and B5: "
              f"{row}")
        no_plain(f"{dtype} refit tiles")
    print(json.dumps(dict(phase="wide_d_main_paths", d=d, **out)),
          flush=True)
    return out


@contextlib.contextmanager
def timed_calls(targets):
    """Host wall time of every call of each (module, attribute) in
    ``targets`` while the block runs, the card synchronised around each
    call, as {"name": [ms, calls]}. A psd-project tile launches ~6 million
    kernels: too many for the profiler to trace and sort in the smoke's
    time, so its split is taken this way."""
    import torch

    totals = {f"{mod.__name__.split('.')[-1]}.{attr}": [0.0, 0]
              for mod, attr in targets}
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr in targets]

    def wrap(key, fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                totals[key][0] += 1e3 * (time.perf_counter() - t0)
                totals[key][1] += 1
        return call

    try:
        for (mod, attr, fn), key in zip(saved, totals):
            setattr(mod, attr, wrap(key, fn))
        yield totals
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def vn_split(fn):
    """Wall ms of one call of ``fn`` (a vn lookahead tile) and the host
    time of its stages and of the linear algebra inside them."""
    import torch
    from amf_tpu_torch.models import pmf, vnormal

    with timed_calls([(pmf, "fit"), (vnormal, "initialize_approx"),
                      (vnormal, "fit_normal"), (torch.linalg, "eigh"),
                      (torch.linalg, "slogdet"),
                      (torch.autograd, "grad")]) as totals:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    return dict(wall_ms=wall, **{k: dict(ms=v[0], calls=v[1])
                                 for k, v in totals.items()})


def vn_phases(device, bench_rows):
    """Phases 13-16: the variational (ActivePMF) path, which runs no
    hand-written kernel (its linear algebra is PyTorch's): the bench's vn
    rows (phase 37's ``bench_rows``), card against CPU in float64, the
    active loops, the entry step."""
    import numpy as np
    import torch
    from amf_tpu_torch import bench
    from amf_tpu_torch.active import criteria, lookahead
    from amf_tpu_torch.active.loop import run_active_pmf
    from amf_tpu_torch.entry import entry
    from amf_tpu_torch.utils.rng import lane_generators, lane_normals

    out = {}
    crit = criteria.KEY_FUNCS["total-variance"]
    f32 = torch.float32

    stamp("13")
    # ---- 13. the bench's vn rows (timed in phase 37: chol over every
    # candidate, psd-project over one tile) and where a tile's time goes
    sweep = {}
    for cov_param in ("chol", "psd-project"):
        bench_row = bench_rows[cov_param]
        scores = bench_row["scores"]
        finite = int(torch.isfinite(scores).sum())
        row = sweep[cov_param] = dict(
            candidates=bench_row["candidates"], tiles=bench_row["tiles"],
            lanes_a_tile=bench_row["tile"] * VN_NODES, s=bench_row["s"],
            warm_s=bench_row["warm_s"], candidates_per_s=bench_row["rate"],
            finite=finite, scores_min=scores.min().item(),
            scores_max=scores.max().item())
        check(finite == bench_row["candidates"] == len(scores),
              f"vn {cov_param} f32 scores not all finite: {row}")
        if cov_param == "psd-project":
            # a smaller tile under the host-side profiler that splits it. (A
            # chol tile's device split is no longer taken: its ~23,000
            # launches kept the profiler longer than the tile; PERF.md keeps
            # its last reading.)
            prob, pcfg, pst, vcfg, ast, lcfg = bench_row["state"]
            part = torch.nonzero(prob.queryable.flatten())[:VN_SPLIT_CAND, 0]
            row[f"split_{VN_SPLIT_CAND}_candidates"] = vn_split(
                lambda: lookahead.lookahead_scores(
                    crit, pst, ast, prob, 2, pcfg, lookahead.vn_adapter(vcfg),
                    lcfg, cand=part))
        print(json.dumps(dict(phase="vn_lookahead", cov_param=cov_param,
                              **row)), flush=True)
    out["sweep"] = sweep

    stamp("14")
    # ---- 14. card against CPU, float64, the same inputs and lane noise
    real64, prob64, pcfg64, pst64 = bench.vn_problem(
        bench.CARD, device, torch.float64)
    vcfg64, ast64 = bench.vn_approx(bench.CARD, pst64, prob64,
                                   "psd-project", device)
    adapter = lookahead.vn_adapter(vcfg64)
    q = torch.nonzero(prob64.queryable.flatten())[:, 0]

    def to_cpu(state):
        return dataclasses.replace(state, **{
            f.name: getattr(state, f.name).cpu()
            for f in dataclasses.fields(state)})

    f64 = {}
    for name, n_cand, nodes in (("total-variance", VN_F64_TILE, VN_NODES),
                                ("pred-entropy-bound-approx", VN_PEB_TILE,
                                 VN_NODES)):
        c = q[:n_cand]
        k = sum(prob64.shape) * VN_D
        noise = lane_normals(lane_generators(5, c.tolist(), nodes, "cpu"),
                             k * k, torch.float64, "cpu").reshape(
            n_cand, nodes, k, k)
        args = (criteria.KEY_FUNCS[name],)
        lc = bench.vn_lookahead_config(bench.CARD)
        card, card_ms = timed_ms(lambda: lookahead.lookahead_scores(
            *args, pst64, ast64, prob64, 5, pcfg64, adapter, lc, cand=c,
            noise=noise))
        t0 = time.perf_counter()
        host = lookahead.lookahead_scores(
            *args, to_cpu(pst64), to_cpu(ast64), prob64.to(device="cpu"), 5,
            pcfg64, adapter, lc, cand=c.cpu(), noise=noise)
        host_s = time.perf_counter() - t0
        card = card.cpu()
        rel_diff = ((card - host).abs() / host.abs()).max().item()
        row = f64[name] = dict(candidates=n_cand, card_s=card_ms / 1e3,
                               cpu_s=host_s, max_rel_diff=rel_diff,
                               rtol=VN_F64_RTOL,
                               scores_min=host.min().item())
        check(bool(torch.isfinite(card).all()) and rel_diff <= VN_F64_RTOL,
              f"vn f64 {name}: card against CPU {row}")
    out["card_vs_cpu_f64"] = f64
    print(json.dumps(dict(phase="vn_card_vs_cpu_f64", **f64)), flush=True)

    stamp("15")
    # ---- 15. the active loops: vn (chol) on the bench's problem, mn on a
    # 12 x 12 one (its row covariance then fits cuSOLVER's batched eigh)
    loops = {}
    for model, keys, steps, n in (
            ("vn", ["pred-variance", "total-variance"], 2, VN_N),
            ("mn", ["pred-variance", "total-variance-approx"], 2, VN_MN_N)):
        lreal, lprob, _, _ = bench.vn_problem(bench.CARD, device, f32, n=n)
        t0 = time.perf_counter()
        res = run_active_pmf(
            lprob, lreal, keys, latent_d=VN_D, refit_lookahead=True,
            steps=steps, seed=0, model=model, lookahead_budget=VN_REFIT_STEPS,
            lookahead_tile=VN_TILE, cov_param="chol", dtype=f32,
            device=device, verbose=True)
        torch.cuda.synchronize()
        pool = lprob.queryable.cpu().numpy()
        row = loops[model] = dict(s=time.perf_counter() - t0, steps=steps)
        for k in keys:
            recs = res[k]
            picks = [r[2] for r in recs[1:]]
            row[k] = dict(rmse=[r[1] for r in recs], picks=picks)
            # every step scores the cells still in the pool
            scored = [int(np.isfinite(r[3]).sum()) for r in recs[1:]]
            check(len(recs) == steps
                  and all(math.isfinite(r[1]) for r in recs)
                  and len(set(picks)) == len(picks)
                  and all(pool[p] for p in picks)
                  and scored == [int(pool.sum()) - t
                                 for t in range(steps - 1)],
                  f"{model} loop {k}: {row[k]}, finite scores {scored}")
    out["loops"] = loops
    print(json.dumps(dict(phase="active_pmf_loops", **loops)), flush=True)

    stamp("16")
    # ---- 16. the port's entry() step
    step, args = entry(device)
    step(*args)  # warm
    scores, step_ms = timed_ms(lambda: step(*args))
    queryable = args[2].queryable
    out["entry"] = dict(ms=step_ms, shape=list(scores.shape),
                        finite_on_pool=int(torch.isfinite(
                            scores[queryable]).sum()),
                        pool=int(queryable.sum()))
    check(tuple(scores.shape) == (16, 12)
          and bool(torch.isfinite(scores[queryable]).all())
          and bool((scores[~queryable] == -torch.inf).all()),
          f"entry step scores {out['entry']}")
    print(json.dumps(dict(phase="entry_step", **out["entry"])), flush=True)
    return out


def nuts_problem(device, n, m, dtype, seed, rank=5, mask=0.1):
    """Synthetic ratings 1..5 at n x m (``make_fake_data``, seeded), every
    cell knowable, ``mask`` of them known."""
    import numpy as np
    from amf_tpu_torch import types
    from amf_tpu_torch.data.synthetic import make_fake_data

    rng = np.random.default_rng(seed)
    real, known, _ = make_fake_data(num_users=n, num_items=m, rank=rank,
                                    noise=0.5, mask_type=mask, rng=rng)
    real = np.clip(np.round(real - real.mean() + 3.0), 1.0, 5.0)
    return real, known, types.problem_from_dense(
        real, known, dtype=dtype, device=device, zeros_unknowable=False)


def tree_stats(num_leaves) -> dict:
    """Mean and max tree depth (doublings: floor(log2(leaves)) + 1) and
    leaves of a chain's draws."""
    import torch

    leaves = num_leaves.double().clamp(min=1)
    depth = torch.floor(torch.log2(leaves)) + 1
    return dict(mean_depth=depth.mean().item(), max_depth=depth.max().item(),
                mean_leaves=leaves.mean().item(),
                max_leaves=leaves.max().item())


def base_chain(device, prob, d, samps, warmup, chains, seed=0):
    """One NUTS base chain run (``bpmf_hmc.samples``) from a PMF MAP warm
    start: its readings, the state after it and its draws."""
    import numpy as np
    import torch
    from amf_tpu_torch.analysis import metrics
    from amf_tpu_torch.mcmc import nuts
    from amf_tpu_torch.models import bpmf_hmc, pmf
    from amf_tpu_torch.utils.rng import generator

    n, m = prob.shape
    dtype = prob.R_obs.dtype
    pcfg = pmf.PMFConfig(latent_d=d, subtract_mean=True)
    pst = pmf.init_state(generator(seed, device), n, m, pcfg, prob,
                         dtype=dtype, device=device)
    pst, _ = pmf.fit(pst, prob, pcfg)
    cfg = bpmf_hmc.HMCConfig(latent_d=d)
    st = bpmf_hmc.init_state(prob, cfg, U=pst.U, V=pst.V, dtype=dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nuts.Counters.reset()
    t0 = time.perf_counter()
    st2, out = bpmf_hmc.samples(seed + 1, st, prob, cfg, samps, warmup,
                                chains=chains)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = nuts.Counters.read()
    lp = out["lp__"].cpu().numpy().reshape(chains, -1)
    finite = bool(torch.isfinite(out["U"]).all()) and bool(np.isfinite(lp).all())
    row = dict(n=n, m=m, d=d, chains=chains, draws=samps, warmup=warmup,
               dim=bpmf_hmc.ParamShapes(n, m, d).dim, s=wall,
               lockstep_leapfrogs=c["lockstep_leapfrogs"],
               lane_leapfrogs=c["lane_leaves"],
               lane_leapfrogs_per_s=c["lane_leaves"] / wall,
               lockstep_leapfrogs_per_s=c["lockstep_leapfrogs"] / wall,
               syncs_per_transition=c["syncs"] / c["transitions"],
               **tree_stats(out["num_leaves"]),
               divergences=int(out["diverging"].sum()),
               accept_mean=out["accept_prob"].mean().item(),
               lp_split_rhat=metrics.split_rhat(lp), lp_ess=metrics.ess(lp),
               mode_lp=st2.mode_lp.item(),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               finite=finite)
    return row, st2, out


class RecordedNoise:
    """A noise source that records what it serves (for the CPU run) and
    serves the recording again, moved to another device (for the card)."""

    def __init__(self, source=None, steps=None, searches=None):
        self.source = source
        self.steps = {} if steps is None else steps
        self.searches = {} if searches is None else searches

    def step(self, t):
        if self.source is not None and t not in self.steps:
            self.steps[t] = self.source.step(t)
        return self.steps[t]

    def search(self, t):
        if self.source is not None and t not in self.searches:
            self.searches[t] = self.source.search(t)
        return self.searches[t]

    def to(self, device):
        return RecordedNoise(
            steps={t: type(v)(*(x.to(device) for x in v))
                   for t, v in self.steps.items()},
            searches={t: v.to(device) for t, v in self.searches.items()})


def transition_split(fn):
    """torch.profiler over one call of ``fn`` (one lockstep transition):
    wall and device ms, the host's time in the potential's forward and
    backward (``nuts.potential``) and in the RNG (``nuts.rng``), the
    host-device synchronisations, and the top device kernels."""
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
    avg = prof.key_averages()
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in avg if e.device_type == DeviceType.CUDA),
                     key=lambda r: -r[1])

    def host_ms(key):
        return sum(e.cpu_time_total / 1e3 for e in avg if e.key == key)

    def count(key):
        return sum(e.count for e in avg if e.key == key)

    return dict(wall_ms=wall_ms,
                device_busy_ms=sum(r[1] for r in kernels),
                device_launches=sum(r[2] for r in kernels),
                potential_host_ms=host_ms("nuts.potential"),
                potential_calls=count("nuts.potential"),
                rng_host_ms=host_ms("nuts.rng"),
                stream_syncs=count("cudaStreamSynchronize"),
                dtoh_copies=count("cudaMemcpyAsync"),
                top=[dict(name=k[:70], ms=t, calls=c)
                     for k, t, c in kernels[:8]])


def nuts_phases(device):
    """Phases 17-21: the NUTS BPMF path (mcmc/nuts, models/bpmf_hmc,
    sample_stats, the stan loop and its CLI), which runs no hand-written
    kernel: its density and gradient are PyTorch's (autograd)."""
    import numpy as np
    import torch
    from amf_tpu_torch import types
    from amf_tpu_torch.active.stan_loop import run_active_stan
    from amf_tpu_torch.data.loaders import save_npz_schema
    from amf_tpu_torch.mcmc import nuts
    from amf_tpu_torch.models import bpmf_hmc, sample_stats
    from amf_tpu_torch.types import LaneCells
    from amf_tpu_torch.utils.rng import generator, lane_generators

    out = {}
    f32 = torch.float32
    vals = VALS

    stamp("17")
    # ---- 17. base chains at the DrugBank shape: 1 chain, 4 as lanes
    _, _, db_prob = nuts_problem(device, DB_N, DB_M, f32, seed=3)
    for chains in (DB_CHAINS, 1):
        row, st, samps = base_chain(device, db_prob, DB_D, DB_SAMPS,
                                    DB_WARMUP, chains)
        out[f"drugbank_{chains}"] = row
        print(json.dumps(dict(phase="nuts_base_drugbank", **row)), flush=True)
        check(row["finite"], f"drugbank base chain not finite: {row}")

    stamp("18")
    # ---- 18. base chain at the MovieLens shape
    _, _, ml_prob = nuts_problem(device, N, M, f32, seed=0, rank=D,
                                 mask=0.05 * 100000 / (N * M))
    row = base_chain(device, ml_prob, ML_D, ML_SAMPS, ML_WARMUP, 1)[0]
    out["movielens_1"] = row
    print(json.dumps(dict(phase="nuts_base_movielens", **row)), flush=True)
    check(row["finite"], f"movielens base chain not finite: {row}")
    del ml_prob

    stamp("19")
    # ---- 19. lookahead tiles at the DrugBank shape: exp-variance (32
    # candidates x 5 values) and exp-entropy-est (8 candidates), from the
    # one-chain base run of phase 17 (its mode and statistics)
    cfg = bpmf_hmc.HMCConfig(latent_d=DB_D)
    base = sample_stats.prediction_stats(
        samps["U"], samps["V"], st.mean_rating, True,
        value_bounds=tuple(types.rating_bounds(vals)))
    cand = torch.nonzero(db_prob.queryable.flatten())[:, 0]
    tiles = {}
    for stat, n_cand in (("total-variance", LA_CAND),
                         ("entropy-est", LA_ENT_CAND)):
        draws, warmup = LA_BUDGET[stat]
        c = cand[:n_cand]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        nuts.Counters.reset()
        t0 = time.perf_counter()
        scores = bpmf_hmc.lookahead_scores(
            11, st, db_prob, cfg, base, vals, stat=stat, num_samps=draws,
            warmup=warmup, cand=c, n_base_samples=DB_SAMPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k = nuts.Counters.read()
        lanes = n_cand * len(vals)
        row = tiles[stat] = dict(
            candidates=n_cand, lanes=lanes, draws=draws, warmup=warmup,
            s=wall,
            candidates_per_s=n_cand / wall,
            lockstep_leapfrogs_per_transition=(
                k["lockstep_leapfrogs"] / k["transitions"]),
            lane_mean_leapfrogs_per_transition=(
                k["lane_leaves"] / k["lane_transitions"]),
            syncs_per_transition=k["syncs"] / k["transitions"],
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            finite=int(torch.isfinite(scores).sum()),
            scores_min=scores.min().item(), scores_max=scores.max().item())
        print(json.dumps(dict(phase="nuts_lookahead_tile", stat=stat, **row)),
              flush=True)
        check(row["finite"] == n_cand,
              f"nuts lookahead {stat} scores not all finite: {row}")

    # the profiler's split of one lockstep transition of the exp-variance
    # tile's lanes,
    # from the base mode
    n, m = db_prob.shape
    shapes = bpmf_hmc.ParamShapes(n, m, DB_D)
    c = cand[:LA_CAND]
    cells = LaneCells(i=torch.repeat_interleave(c // m, len(vals)),
                      j=torch.repeat_interleave(c % m, len(vals)),
                      v=torch.tensor(vals, device=device, dtype=f32).repeat(
                          LA_CAND))
    L = len(cells)
    mr = cells.mean_rating(db_prob)
    pot = nuts.potential(lambda q: bpmf_hmc.log_posterior(
        q, db_prob, mr, cfg, shapes, cells=cells))
    noise = nuts.GeneratorNoise(lane_generators(13, c.tolist(), len(vals),
                                                device), shapes.dim,
                                cfg.max_depth, f32, device, window=1)
    q0 = st.mode_q.expand(L, shapes.dim)
    inv_mass = torch.ones_like(q0)
    eps = nuts.find_reasonable_step_size(noise.search(None), q0, pot,
                                         inv_mass, 1.0)

    def one_transition(t=[0]):
        nuts.Counters.reset()
        nuts.nuts_kernel(q0, pot, eps, inv_mass, noise.step(t[0]),
                         nuts.NUTSConfig(max_depth=cfg.max_depth))
        t[0] += 1

    one_transition()  # warm
    split = transition_split(one_transition)
    split.update(nuts.Counters.read())
    # the potential (forward and backward) eager and replayed from its CUDA
    # graph, the tile's lanes and 1; the graph's outputs equal the eager ones
    for lanes, lp in ((L, lambda q: bpmf_hmc.log_posterior(
            q, db_prob, mr, cfg, shapes, cells=cells)),
            (1, lambda q: bpmf_hmc.log_posterior(
                q, db_prob, st.mean_rating, cfg, shapes))):
        qx = q0[:lanes] * 1.01
        eager_pot, graph_pot = (nuts.potential(lp, graph=False),
                                nuts.potential(lp))
        got, want = graph_pot(qx), eager_pot(qx)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"graphed potential differs from eager at {lanes} lanes")
        split[f"potential_ms_{lanes}_lanes"] = dict(
            eager=cuda_ms(lambda: eager_pot(qx), 20),
            graph=cuda_ms(lambda: graph_pot(qx), 20))
    tiles[f"transition_split_{L}_lanes"] = split
    print(json.dumps(dict(phase="nuts_transition_split", **split)),
          flush=True)
    out["lookahead"] = tiles
    del db_prob, base, samps

    stamp("20")
    # ---- 20. float64 card against CPU: one transition and a short chain
    cfg64 = NUTS_F64
    real, known, prob_cpu = nuts_problem("cpu", cfg64["n"], cfg64["m"],
                                         torch.float64, seed=5, rank=3,
                                         mask=0.3)
    prob_gpu = prob_cpu.to(device=device)
    hcfg = bpmf_hmc.HMCConfig(latent_d=cfg64["d"])
    shapes = bpmf_hmc.ParamShapes(cfg64["n"], cfg64["m"], cfg64["d"])
    Lf = cfg64["lanes"]
    q0 = torch.randn((Lf, shapes.dim), generator=generator(3, "cpu"),
                     dtype=torch.float64) * 0.3
    eps0 = torch.linspace(0.02, 0.3, Lf, dtype=torch.float64)
    gens = [generator(40 + i, "cpu") for i in range(Lf)]
    rec = RecordedNoise(nuts.GeneratorNoise(gens, shapes.dim, hcfg.max_depth,
                                            torch.float64, "cpu"))

    def logp_on(prob):
        return lambda q: bpmf_hmc.log_posterior(q, prob, prob.mean_rating(),
                                                hcfg, shapes)

    def transition(prob, noise, dev):
        return nuts.nuts_kernel(
            q0.to(dev), nuts.potential(logp_on(prob)), eps0.to(dev),
            torch.ones_like(q0, device=dev), noise.step(0),
            nuts.NUTSConfig(max_depth=hcfg.max_depth))

    q_cpu, info_cpu = transition(prob_cpu, rec, "cpu")
    q_gpu, info_gpu = transition(prob_gpu, rec.to(device), device)

    def scaled(a, b):
        a, b = a.cpu(), b.cpu()
        return ((a - b).abs() / (1 + b.abs())).max().item()

    chain_rec = RecordedNoise(nuts.GeneratorNoise(
        [generator(60 + i, "cpu") for i in range(Lf)], shapes.dim,
        hcfg.max_depth, torch.float64, "cpu"))
    args = (cfg64["draws"], cfg64["warmup"],
            nuts.NUTSConfig(max_depth=hcfg.max_depth))
    s_cpu, i_cpu, a_cpu = nuts.run_nuts(chain_rec, q0, logp_on(prob_cpu),
                                        *args, return_adaptation=True)
    s_gpu, i_gpu, a_gpu = nuts.run_nuts(chain_rec.to(device), q0.to(device),
                                        logp_on(prob_gpu), *args,
                                        return_adaptation=True)
    # each draw of the card's chain against the CPU's transition from the
    # card's draw before it, with that step's noise and step size
    pot_cpu = nuts.potential(logp_on(prob_cpu))
    anchor, inv_mass = a_gpu["eps"].cpu(), a_gpu["inv_mass"].cpu()
    s_gpu_c = s_gpu.cpu()
    step_q, step_lp = [], []
    for k in range(1, cfg64["draws"]):
        sn = chain_rec.step(cfg64["warmup"] + k)
        eps = anchor * torch.clamp(sn.u_jitter * (1.3 - 0.7) + 0.7, min=0.7)
        qk, ik = nuts.nuts_kernel(s_gpu_c[:, k - 1], pot_cpu, eps, inv_mass,
                                  sn, nuts.NUTSConfig(max_depth=hcfg.max_depth))
        step_q.append(scaled(s_gpu_c[:, k], qk))
        step_lp.append(scaled(i_gpu.logprob[:, k], ik.logprob))
    # the CPU chain against itself from a start moved by 1e-15 relative
    s_moved = nuts.run_nuts(chain_rec, q0 * (1 + 1e-15), logp_on(prob_cpu),
                            *args)[0]
    f64 = dict(
        transition_q=scaled(q_gpu, q_cpu),
        transition_logprob=scaled(info_gpu.logprob, info_cpu.logprob),
        transition_leaves_equal=bool(torch.equal(info_gpu.num_leaves.cpu(),
                                                 info_cpu.num_leaves)),
        transition_leaves=info_cpu.num_leaves.tolist(),
        chain_step_draws=max(step_q), chain_step_logprob=max(step_lp),
        chain_eps=scaled(a_gpu["eps"], a_cpu["eps"]),
        chain_inv_mass=scaled(a_gpu["inv_mass"], a_cpu["inv_mass"]),
        chain_leaves_equal=bool(torch.equal(i_gpu.num_leaves.cpu(),
                                            i_cpu.num_leaves)),
        tol=NUTS_F64_TOL,
        figure_free_chain_draws=scaled(s_gpu, s_cpu),
        figure_free_chain_logprob=scaled(i_gpu.logprob, i_cpu.logprob),
        figure_cpu_chain_moved_start_1e15=scaled(s_moved, s_cpu))
    out["card_vs_cpu_f64"] = f64
    print(json.dumps(dict(phase="nuts_card_vs_cpu_f64", **f64)), flush=True)
    check(all(v <= NUTS_F64_TOL for k, v in f64.items()
              if isinstance(v, float) and not k.startswith(("tol", "figure")))
          and f64["transition_leaves_equal"] and f64["chain_leaves_equal"],
          f"nuts f64 card against CPU: {f64}")

    stamp("21")
    # ---- 21. the stan loop with a checkpoint and a resume, and the CLI
    real, known, sprob = nuts_problem(device, STAN_N, STAN_M, f32, seed=9,
                                      mask=0.3)
    pool = sprob.queryable.cpu().numpy().copy()
    pool.ravel()[np.nonzero(pool.ravel())[0][STAN_POOL:]] = False
    sprob = dataclasses.replace(sprob, queryable=torch.as_tensor(
        pool, device=device))
    keys = ["random", "pred-variance", "exp-variance"]
    loop_kw = dict(latent_d=STAN_D, rating_values=vals, num_samps=10,
                   warmup=6, lookahead_samps=6, lookahead_warmup=4,
                   lookahead_tile=STAN_POOL, seed=0, dtype=f32, device=device)
    work = ROOT / "build" / "chip_smoke_stan"
    work.mkdir(parents=True, exist_ok=True)
    ck = work / "stan_ck.pkl"
    ck.unlink(missing_ok=True)
    t0 = time.perf_counter()
    full = run_active_stan(sprob, real, keys, steps=3, verbose=True,
                           **loop_kw)
    loop_s = time.perf_counter() - t0
    run_active_stan(sprob, real, keys, steps=2, checkpoint_path=str(ck),
                    **loop_kw)
    resumed = run_active_stan(sprob, real, keys, steps=3,
                              checkpoint_path=str(ck), verbose=True,
                              **loop_kw)
    loop = dict(s=loop_s, keys=keys)
    for k in keys:
        a, b = full[k], resumed[k]
        loop[k] = dict(picks=[r[2] for r in a[1:]],
                       resumed_picks=[r[2] for r in b[1:]],
                       errs=[r[1] for r in a], resumed_errs=[r[1] for r in b])
        # the replayed records are the interrupted run's own; the step after
        # the resume draws the uninterrupted run's seeds, so a pick that
        # follows from the seeds alone (random) is the same
        check(len(b) == 3 and [r[0] for r in b] == [r[0] for r in a]
              and [r[2] for r in b[:2]] == [r[2] for r in a[:2]]
              and all(math.isclose(x[1], y[1], rel_tol=1e-6)
                      for x, y in zip(a[:2], b[:2]))
              and all(math.isfinite(r[1]) for r in a + b)
              and all(pool[r[2]] for r in b[1:]),
              f"stan loop resume {k}: {loop[k]}")
    check([r[2] for r in resumed["random"]] == [r[2] for r in full["random"]],
          f"stan loop resume: random picks {loop['random']}")
    out["stan_loop"] = loop
    print(json.dumps(dict(phase="stan_loop_resume", **loop)), flush=True)

    creal, cknown, _ = nuts_problem("cpu", 12, 10, torch.float64, seed=4,
                                    mask=0.3)
    data = work / "stan_cli.npz"
    save_npz_schema(str(data), {"_real": creal, "_known": cknown,
                                "_rating_vals": np.asarray(vals)})
    cli_ck = work / "stan_cli_ck.pkl"
    cli_ck.unlink(missing_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "amf_tpu_torch.run.bpmf", "--load-data",
         str(data), "-D", "3", "-s", "2", "-S", "10", "--lookahead-samps",
         "6", "--lookahead-warmup", "4", "--float32", "--checkpoint",
         str(cli_ck), "--save-results", str(work / "stan_cli.pkl"),
         "pred-variance", "exp-variance"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=600)
    cli = dict(s=time.perf_counter() - t0, rc=proc.returncode,
               checkpoint=cli_ck.is_file(),
               tail=proc.stdout.strip().splitlines()[-3:])
    print(json.dumps(dict(phase="bpmf_cli", **cli)), flush=True)
    check(proc.returncode == 0 and cli_ck.is_file(),
          f"bpmf CLI: {cli} {proc.stderr[-2000:]}")
    out["cli"] = cli
    return out


def rc_phases(device, real, known):
    """Phases 22-24: RatingConcentration (ops/lbfgsb, models/ratingconc,
    active/rc_loop, run/active_rc), which runs no hand-written kernel: its
    dual and closed-form gradient are PyTorch's dense masked softmax."""
    import numpy as np
    import torch
    from amf_tpu_torch import types
    from amf_tpu_torch.active.rc_loop import run_active_rc
    from amf_tpu_torch.data.loaders import load_npz_schema
    from amf_tpu_torch.models import ratingconc as rc
    from amf_tpu_torch.ops import lbfgsb

    out = {}
    f64 = torch.float64
    cfg = rc.RCConfig()

    def pg_norm(x, data):
        _, g = rc.dual_value_and_grad(x, data)
        return float(torch.amax(torch.abs(
            torch.clamp(x - g, 0.0, cfg.upper) - x)))

    stamp("22")
    # ---- 22. the maxent fit at the MovieLens shape, f64
    prob = types.problem_from_dense(real, known, dtype=f64, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lbfgsb.Counters.reset()
    t0 = time.perf_counter()
    x, data, iters = rc.fit(prob, cfg)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit = dict(n=N, m=M, features=int(data.F.shape[1]), dim=int(x.shape[0]),
               iters=int(iters), pg_norm=pg_norm(x, data), s=fit_s,
               dual=float(rc.dual_objective(x, data)),
               dual_at_zero=float(rc.dual_objective(torch.zeros_like(x), data)),
               **lbfgsb.Counters.read(),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print(json.dumps(dict(phase="rc_fit", **fit)), flush=True)
    check(math.isfinite(fit["dual"]) and fit["dual"] <= fit["dual_at_zero"]
          and bool(torch.isfinite(x).all()), f"rc fit: {fit}")
    out["fit"] = fit

    stamp("23")
    # ---- 23. a lookahead tile at the MovieLens shape: 8 candidates x 5
    # values of 60 warm-started iterations, f64
    cand = torch.nonzero(prob.queryable.flatten())[:RC_LA_CAND, 0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lbfgsb.Counters.reset()
    t0 = time.perf_counter()
    scores = rc.entropy_lookahead_scores(
        x, data, prob, cfg, lookahead_iters=RC_LA_ITERS, cand=cand,
        candidate_tile=RC_LA_CAND)
    torch.cuda.synchronize()
    c = lbfgsb.Counters.read()
    tile = dict(candidates=RC_LA_CAND, lanes=RC_LA_CAND * len(VALS),
                iters=RC_LA_ITERS, s=time.perf_counter() - t0,
                lockstep_iterations=c["iterations"],
                lane_mean_iterations=c["lane_iterations"]
                / (RC_LA_CAND * len(VALS)),
                trials=c["trials"], syncs=c["syncs"],
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                finite=bool(torch.isfinite(scores).all()),
                score_range=[float(scores.min()), float(scores.max())])
    print(json.dumps(dict(phase="rc_lookahead_tile", **tile)), flush=True)
    check(tile["finite"], f"rc lookahead tile: {tile}")
    out["tile"] = tile

    # the card against the CPU in f64 on the reference experiment's 10 x 10
    # data, every candidate, from the same multipliers
    small = load_npz_schema(str(RC_SMALL))
    sreal = small["_real"]
    sknown = np.zeros(sreal.shape, dtype=bool)
    sknown[small["_ratings"][:, 0].astype(int),
           small["_ratings"][:, 1].astype(int)] = True
    sprob_cpu = types.problem_from_dense(sreal, sknown, dtype=f64,
                                         device="cpu")
    sprob = sprob_cpu.to(device=device)
    xs_cpu, ds_cpu, _ = rc.fit(sprob_cpu, cfg)
    xs, ds, _ = rc.fit(sprob, cfg)
    t0 = time.perf_counter()
    want = rc.entropy_lookahead_scores(xs_cpu, ds_cpu, sprob_cpu, cfg,
                                       lookahead_iters=RC_SHORT_LA_ITERS)
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = rc.entropy_lookahead_scores(xs_cpu.to(device), ds, sprob, cfg,
                                      lookahead_iters=RC_SHORT_LA_ITERS)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    got = got.cpu()
    fin = torch.isfinite(want)
    err = float(((got - want).abs() / (1 + want.abs()))[fin].max())
    f64row = dict(n=10, m=10, candidates=int(fin.sum()),
                  max_rel_err=err, cpu_s=cpu_s, card_s=card_s,
                  fit_max_abs_diff=float((xs.cpu() - xs_cpu).abs().max()),
                  nan_same=bool(torch.equal(torch.isnan(got),
                                            torch.isnan(want))))
    print(json.dumps(dict(phase="rc_f64_card_vs_cpu", **f64row)), flush=True)
    check(f64row["nan_same"] and err <= RC_F64_TOL,
          f"rc f64 card vs cpu: {f64row}")
    out["f64"] = f64row

    stamp("24")
    # ---- 24. run_active_rc on the 10 x 10 data: all four keys, 3 records,
    # then stopped at 2 with a checkpoint and resumed; then the CLI
    keys = sorted(rc.RC_KEYS)
    work = ROOT / "build" / "chip_smoke_rc"
    work.mkdir(parents=True, exist_ok=True)
    ck = work / "rc_ck.pkl"
    ck.unlink(missing_ok=True)
    loop_kw = dict(rating_values=small["_rating_vals"], seed=0, dtype=f64,
                   device=device, lookahead_iters=RC_SHORT_LA_ITERS,
                   max_iters=RC_LOOP_ITERS)
    t0 = time.perf_counter()
    full = run_active_rc(sprob, sreal, keys, steps=3, verbose=True, **loop_kw)
    loop_s = time.perf_counter() - t0
    run_active_rc(sprob, sreal, keys, steps=2, checkpoint_path=str(ck),
                  **loop_kw)
    resumed = run_active_rc(sprob, sreal, keys, steps=3,
                            checkpoint_path=str(ck), verbose=True, **loop_kw)
    pool = sprob_cpu.queryable.numpy()
    loop = dict(s=loop_s, keys=keys)
    for k in keys:
        a, b = full[k], resumed[k]
        loop[k] = dict(picks=[r[2] for r in a[1:]],
                       resumed_picks=[r[2] for r in b[1:]],
                       errs=[r[1] for r in a], resumed_errs=[r[1] for r in b])
        # the replayed records are the interrupted run's own; the refit
        # after the resume starts from the first fit's multipliers, not
        # the interrupted run's last, so only a pick that follows from the
        # seeds alone (random) must be the uninterrupted run's
        check(len(b) == 3 and [r[0] for r in b] == [r[0] for r in a]
              and [r[2] for r in b[:2]] == [r[2] for r in a[:2]]
              and all(math.isclose(p[1], q[1], rel_tol=1e-9)
                      for p, q in zip(a[:2], b[:2]))
              and all(math.isfinite(r[1]) for r in a + b)
              and all(pool[r[2]] for r in b[1:]),
              f"rc loop resume {k}: {loop[k]}")
    check([r[2] for r in resumed["random"]] == [r[2] for r in full["random"]],
          f"rc loop resume: random picks {loop['random']}")
    print(json.dumps(dict(phase="rc_loop_resume", **loop)), flush=True)
    out["loop"] = loop

    cli_ck = work / "rc_cli_ck.pkl"
    cli_ck.unlink(missing_ok=True)
    runs = []
    for steps in (2, 3):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "amf_tpu_torch.run.active_rc",
             "--load-data", str(RC_SMALL), "-s", str(steps), "--max-iters",
             str(RC_LOOP_ITERS), "--lookahead-iters", str(RC_SHORT_LA_ITERS),
             "--checkpoint",
             str(cli_ck), "--save-results", str(work / "rc_cli.pkl"),
             "entropy", "random"],
            cwd=str(ROOT), capture_output=True, text=True, timeout=600)
        runs.append(dict(steps=steps, s=time.perf_counter() - t0,
                         rc=proc.returncode,
                         tail=proc.stdout.strip().splitlines()[-3:]))
        check(proc.returncode == 0 and cli_ck.is_file(),
              f"active_rc CLI: {runs[-1]} {proc.stderr[-2000:]}")
    with open(work / "rc_cli.pkl", "rb") as f:
        res = pickle.load(f)
    cli = dict(runs=runs, records={k: len(res[f"rc_{k}"])
                                   for k in ("entropy", "random")})
    print(json.dumps(dict(phase="active_rc_cli", **cli)), flush=True)
    check(cli["records"] == {"entropy": 3, "random": 3},
          f"active_rc CLI resume: {cli}")
    out["cli"] = cli
    return out


def cold_start_phases(device, real, known):
    """Phases 25-26: cold-start BPMF (models/newitems, run/bpmf_newitems)
    on the NUTS sampler, which runs no hand-written kernel: its density
    and gradient are PyTorch's (autograd), one CUDA graph a potential."""
    import numpy as np
    import torch
    from amf_tpu_torch import types
    from amf_tpu_torch.data import splits
    from amf_tpu_torch.data.loaders import save_npz_schema
    from amf_tpu_torch.mcmc import nuts
    from amf_tpu_torch.models import bpmf_hmc, newitems, sample_stats

    out = {}
    f32 = torch.float32
    is_new = np.zeros(M, dtype=bool)
    is_new[M - CS_NEW:] = True
    # the new columns' known cells: a row and column cover of the new
    # submatrix (the reference's --pick-no-extras, splits.pick_ratings)
    cs_known = known.copy()
    cs_known[:, is_new] = splits.pick_ratings(
        np.ones((N, CS_NEW), dtype=bool), None, np.random.default_rng(5))
    prob = types.problem_from_dense(real, cs_known, dtype=f32, device=device)
    cfg = bpmf_hmc.HMCConfig(latent_d=CS_D)

    def chain_row(wall, samps, counters):
        return dict(s=wall, draws=int(samps["lp__"].shape[0]),
                    lockstep_leapfrogs=counters["lockstep_leapfrogs"],
                    **tree_stats(samps["num_leaves"]),
                    divergences=int(samps["diverging"].sum()),
                    accept_mean=samps["accept_prob"].mean().item(),
                    peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                    finite=bool(torch.isfinite(samps["V"]).all()
                                and torch.isfinite(samps["lp__"]).all()))

    stamp("25")
    # ---- 25. phase 1 (the old columns' full chain), the phase-2 chain and
    # an exp-variance lookahead tile
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nuts.Counters.reset()
    t0 = time.perf_counter()
    U_mean, V_fixed, mr = newitems.initial_full_fit(
        11, prob, is_new, cfg, num_samps=CS_FIT, dtype=f32)
    torch.cuda.synchronize()
    c = nuts.Counters.read()
    phase1 = dict(n=N, m_old=M - CS_NEW, d=CS_D, draws=CS_FIT,
                  warmup=CS_FIT // 2,
                  dim=bpmf_hmc.ParamShapes(N, M - CS_NEW, CS_D).dim,
                  s=time.perf_counter() - t0,
                  leapfrogs_per_transition=c["lockstep_leapfrogs"]
                  / max(c["transitions"], 1),
                  peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                  finite=bool(torch.isfinite(U_mean).all()
                              and torch.isfinite(V_fixed).all()))
    print(json.dumps(dict(phase="cold_start_phase1", **phase1)), flush=True)
    check(phase1["finite"], f"cold start phase 1: {phase1}")

    prob_new = newitems.new_item_problem(prob, is_new)
    st = newitems.init_state(prob_new, U_mean, V_fixed, cfg, mr, dtype=f32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nuts.Counters.reset()
    t0 = time.perf_counter()
    st, samps = newitems.samples(12, st, prob_new, cfg, CS_SAMPS)
    torch.cuda.synchronize()
    chain = dict(n=N, m_new=CS_NEW, d=CS_D, warmup=CS_SAMPS // 2,
                 dim=newitems.NewItemsShapes(N, CS_NEW, CS_D).dim,
                 **chain_row(time.perf_counter() - t0, samps,
                             nuts.Counters.read()))
    print(json.dumps(dict(phase="cold_start_chain", **chain)), flush=True)
    check(chain["finite"], f"cold start chain: {chain}")
    bounds = tuple(types.rating_bounds(VALS))
    stats = sample_stats.prediction_stats(samps["U"], samps["V"], mr, True,
                                          value_bounds=bounds)
    cand = torch.nonzero(prob_new.queryable.flatten())[:CS_LA_CAND, 0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nuts.Counters.reset()
    t0 = time.perf_counter()
    scores = newitems.lookahead_scores(
        13, st, prob_new, cfg, stats, VALS, num_samps=CS_SAMPS,
        warmup=CS_SAMPS // 2, cand=cand, n_base_samples=CS_SAMPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = nuts.Counters.read()
    tile = dict(candidates=CS_LA_CAND, lanes=CS_LA_CAND * len(VALS),
                draws=CS_SAMPS, warmup=CS_SAMPS // 2, s=wall,
                candidates_per_s=CS_LA_CAND / wall,
                lockstep_leapfrogs=c["lockstep_leapfrogs"],
                lane_mean_leapfrogs_per_transition=c["lane_leaves"]
                / max(c["lane_transitions"], 1),
                lockstep_leapfrogs_per_transition=c["lockstep_leapfrogs"]
                / max(c["transitions"], 1),
                syncs_per_transition=c["syncs"] / max(c["transitions"], 1),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                finite=bool(torch.isfinite(scores).all()))
    print(json.dumps(dict(phase="cold_start_lookahead_tile", **tile)),
          flush=True)
    check(tile["finite"], f"cold start lookahead tile: {tile}")
    out.update(phase1=phase1, chain=chain, tile=tile)

    stamp("26")
    # ---- 26. the bpmf_newitems CLI with --initial-fit-file and
    # --checkpoint on a small problem, stopped at 2 records and resumed
    rng = np.random.default_rng(6)
    sreal, _, _ = nuts_problem("cpu", 12, 10, torch.float64, seed=6)
    split = splits.make_new_items_split(sreal, 3, know_all_old=True, rng=rng)
    work = ROOT / "build" / "chip_smoke_newitems"
    work.mkdir(parents=True, exist_ok=True)
    data = work / "newitems.npz"
    save_npz_schema(str(data), dict(split, _rating_vals=np.asarray(VALS)))
    fit_file, cli_ck = work / "fit.npz", work / "ck.pkl"
    fit_file.unlink(missing_ok=True)
    cli_ck.unlink(missing_ok=True)
    runs = []
    for steps in (2, 3):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "amf_tpu_torch.run.bpmf_newitems",
             "--load-data", str(data), "-D", "3", "-s", str(steps), "-S",
             "20", "--initial-fit-samps", "20", "--lookahead-samps", "10",
             "--lookahead-warmup", "5", "--float32", "--initial-fit-file",
             str(fit_file), "--checkpoint", str(cli_ck), "--save-results",
             str(work / "newitems.pkl"), "exp-variance", "random"],
            cwd=str(ROOT), capture_output=True, text=True, timeout=600)
        said = proc.stdout
        runs.append(dict(steps=steps, s=time.perf_counter() - t0,
                         rc=proc.returncode,
                         loaded_fit="loaded initial fit" in said,
                         resumed="resumed at step 1" in said))
        check(proc.returncode == 0 and fit_file.is_file()
              and cli_ck.is_file(),
              f"bpmf_newitems CLI: {runs[-1]} {proc.stderr[-2000:]}")
    with open(work / "newitems.pkl", "rb") as f:
        res = pickle.load(f)
    new_cols = set(np.nonzero(split["_is_new_item"])[0].tolist())
    cli = dict(runs=runs, records={k: len(res[k])
                                   for k in ("exp-variance", "random")},
               picks_in_new_columns=all(
                   r[2][1] in new_cols for k in ("exp-variance", "random")
                   for r in res[k][1:]))
    print(json.dumps(dict(phase="bpmf_newitems_cli", **cli)), flush=True)
    check(runs[1]["loaded_fit"] and runs[1]["resumed"]
          and cli["records"] == {"exp-variance": 3, "random": 3}
          and cli["picks_in_new_columns"], f"bpmf_newitems CLI: {cli}")
    out["cli"] = cli
    return out


@contextlib.contextmanager
def host_reads():
    """Counts the host reads (the CUDA calls that wait for the device) in
    the block, by PyTorch's sync debug mode; yields a one-item list that
    holds the count after the block."""
    import torch

    box = [0]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield box
        finally:
            torch.cuda.set_sync_debug_mode("default")
            box[0] = sum("synchroniz" in str(w.message).lower()
                         for w in caught)


def mmmf_labels(n, m, known, test, seed, neg_per_pos=MM_NEG_PER_POS):
    """Synthetic +-1 labels of rank 5 at n x m, ``neg_per_pos`` negatives
    to a positive; ``known`` labels known and ``test`` held out (counts,
    or a fraction known and the rest held out)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    score = rng.normal(size=(n, 5)) @ rng.normal(size=(m, 5)).T
    y = np.where(score > np.quantile(score, neg_per_pos / (neg_per_pos + 1)),
                 1.0, -1.0)
    cells = rng.permutation(n * m)
    if isinstance(known, float):
        known = int(known * n * m)
        test = n * m - known
    kn = np.zeros(n * m, bool)
    kn[cells[:known]] = True
    te = np.zeros(n * m, bool)
    te[cells[known:known + test]] = True
    return y, kn.reshape(n, m), te.reshape(n, m)


def mmmf_phases(device, real, known):
    """Phases 28-29: MMMF (models/mmmf, active/mmmf_loop, run/active_mmmf),
    which runs no hand-written kernel: its ADMM is cuSOLVER's eigh,
    cuBLAS GEMMs and elementwise work, as the JAX package's is XLA's."""
    import numpy as np
    import torch
    from amf_tpu_torch import types
    from amf_tpu_torch.active.mmmf_loop import binarize, run_active_mmmf
    from amf_tpu_torch.data.loaders import save_npz_schema
    from amf_tpu_torch.models import mmmf
    from amf_tpu_torch.run import active_mmmf

    out = {}
    f32, f64 = torch.float32, torch.float64

    def solve_row(y_obs, cfg, cpu_too=True):
        """A solve on the card, its iterations, ms an iteration and eigh's
        share of it; the same solve on the CPU, and the objectives."""
        Y = torch.as_tensor(y_obs, device=device)
        mmmf.solve(Y, cfg._replace(max_iters=2))  # warm the libraries
        with host_reads() as reads:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, iters = mmmf.solve(Y, cfg)
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
        n, m = Y.shape
        gram = (st.X.mT @ st.X) if m <= n else (st.X @ st.X.mT)
        torch.linalg.eigh(gram)
        t_eigh = min(timed_ms(lambda: torch.linalg.eigh(gram))[1]
                     for _ in range(5))
        row = dict(n=n, m=m, dtype=str(Y.dtype).split(".")[1],
                   known=int((Y != 0).sum()), tol=cfg.tol,
                   max_iters=cfg.max_iters, iters=iters, s=s,
                   ms_per_iter=1e3 * s / max(iters, 1), eigh_ms=t_eigh,
                   eigh_share=t_eigh / (1e3 * s / max(iters, 1)),
                   host_reads_per_iter=reads[0] / max(iters, 1),
                   objective=float(mmmf.objective(st.X, Y, cfg.C)),
                   finite=bool(torch.isfinite(st.X).all()))
        if cpu_too:
            Yc = Y.cpu()
            t0 = time.perf_counter()
            cst, citers = mmmf.solve(Yc, cfg)
            row.update(cpu_s=time.perf_counter() - t0, cpu_iters=citers,
                       cpu_objective=float(mmmf.objective(cst.X, Yc, cfg.C)))
            row["objective_rel_diff"] = (abs(row["objective"]
                                             - row["cpu_objective"])
                                         / abs(row["cpu_objective"]))
            row["x_max_diff_scaled"] = float(
                (st.X.cpu() - cst.X).abs().max() / cst.X.abs().max())
        return st, row

    stamp("28")
    # ---- 28. ADMM solves: the DrugBank shape in f64, the newmovies-20d
    # shape in f32 (each against the CPU), the MovieLens shape capped
    y, kn, te = mmmf_labels(MM_N, MM_M, MM_KNOWN, MM_TEST, seed=31)
    solves = {}
    st_db, solves["drugbank_f64"] = solve_row(
        np.where(kn, y, 0.0), mmmf.MMMFConfig(C=1.0, tol=1e-6))
    y32, kn32, _ = mmmf_labels(MM_F32_N, MM_F32_M, MM_F32_KNOWN, 0, seed=32)
    _, solves["newmovies_f32"] = solve_row(
        np.where(kn32, y32, 0.0).astype(np.float32),
        mmmf.MMMFConfig(C=1.0, tol=1e-5))
    y_ml = np.where(known, binarize(real, 4.0), 0.0).astype(np.float32)
    _, solves["movielens_f32_capped"] = solve_row(
        y_ml, mmmf.MMMFConfig(C=1.0, tol=1e-5, max_iters=MM_WIDE_ITERS),
        cpu_too=False)
    for name, row in solves.items():
        print(json.dumps(dict(phase="mmmf_solve", case=name, **row)),
              flush=True)
        check(row["finite"] and 0 < row["iters"] <= row["max_iters"]
              and math.isfinite(row["objective"]), f"mmmf solve {name}: {row}")
        if "cpu_objective" in row:
            check(row["objective_rel_diff"] <= MM_OBJ_RTOL[row["dtype"]],
                  f"mmmf {name} card vs CPU: {row}")
    Ydb = torch.as_tensor(np.where(kn, y, 0.0), device=device)
    t0 = time.perf_counter()
    mst, mobj = mmmf.solve_maxnorm(Ydb, mmmf.MaxNormConfig(C=1.0),
                                   generator=torch.Generator(
                                       device=device).manual_seed(7))
    torch.cuda.synchronize()
    maxnorm = dict(s=time.perf_counter() - t0, iters=4000,
                   objective=float(mobj),
                   finite=bool(torch.isfinite(mst.X).all()))
    # ordinal labels 1..5: quintiles of a rank-5 score
    rng = np.random.default_rng(33)
    score = rng.normal(size=(MM_N, 5)) @ rng.normal(size=(MM_M, 5)).T
    y_ord = np.where(kn, 1 + np.searchsorted(
        np.quantile(score, [0.2, 0.4, 0.6, 0.8]), score), 0)
    t0 = time.perf_counter()
    xy, oX, th = mmmf.solve_ordinal(
        torch.as_tensor(y_ord, dtype=f64, device=device), R=5,
        cfg=mmmf.OrdinalConfig(max_iters=MM_ORD_ITERS))
    torch.cuda.synchronize()
    ordinal = dict(s=time.perf_counter() - t0, iters=MM_ORD_ITERS,
                   theta=th.tolist(), finite=bool(torch.isfinite(oX).all()),
                   labels=sorted(set(xy.unique().tolist())))
    print(json.dumps(dict(phase="mmmf_maxnorm_ordinal", maxnorm=maxnorm,
                          ordinal=ordinal)), flush=True)
    check(maxnorm["finite"] and math.isfinite(maxnorm["objective"])
          and ordinal["finite"] and all(math.isfinite(t)
                                        for t in ordinal["theta"]),
          f"max-norm / ordinal: {maxnorm} {ordinal}")
    out["solves"] = dict(solves, maxnorm=maxnorm, ordinal=ordinal)

    stamp("29")
    # ---- 29. the active loop at the DrugBank shape: 5 selectors x 3
    # records, f64; a run stopped at 2 records with a checkpoint and
    # resumed to 3; the CLI
    prob = types.problem_from_dense(y, kn, test=te, dtype=f64, device=device)
    work = ROOT / "build" / "chip_smoke_mmmf"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    loop_cfg = mmmf.MMMFConfig(C=1.0, max_iters=MM_LOOP_ADMM_ITERS)
    full = run_active_mmmf(prob, y, MM_LOOP_KEYS, steps=3, cfg=loop_cfg,
                           device=device, verbose=True)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    pool = prob.queryable.cpu().numpy()
    loop = dict(s=loop_s, s_per_step_upper=loop_s / (2 * len(MM_LOOP_KEYS)))
    for k in MM_LOOP_KEYS:
        recs = full[k]
        picks = [r[2] for r in recs[1:]]
        loop[k] = dict(picks=picks, misclass=[r[1] for r in recs])
        check(len(recs) == 3 and len(set(picks)) == 2
              and all(pool[p] for p in picks)
              and all(0.0 <= r[1] <= 1.0 for r in recs),
              f"mmmf loop {k}: {loop[k]}")
    ck = work / "mmmf_ck.pkl"
    ck.unlink(missing_ok=True)
    run_active_mmmf(prob, y, MM_RESUME_KEYS, steps=2, cfg=loop_cfg,
                    device=device, checkpoint_path=str(ck))
    t0 = time.perf_counter()
    resumed = run_active_mmmf(prob, y, MM_RESUME_KEYS, steps=3, cfg=loop_cfg,
                              device=device, checkpoint_path=str(ck),
                              verbose=True)
    loop["resume_s"] = time.perf_counter() - t0
    for k in MM_RESUME_KEYS:
        a, b = full[k], resumed[k]
        loop[k].update(resumed_picks=[r[2] for r in b[1:]],
                       resumed_misclass=[r[1] for r in b])
        # the replayed records are the stopped run's, which drew the
        # uninterrupted run's seeds from the same state
        check(len(b) == 3 and [r[0] for r in b] == [r[0] for r in a]
              and [r[2] for r in b[:2]] == [r[2] for r in a[:2]]
              and all(math.isclose(x[1], z[1], rel_tol=1e-9)
                      for x, z in zip(a[:2], b[:2]))
              and pool[b[2][2]], f"mmmf loop resume {k}: {loop[k]}")
    check(resumed["random"][2][2] == full["random"][2][2],
          f"mmmf resume: random picks {loop['random']}")
    print(json.dumps(dict(phase="mmmf_loop", **loop)), flush=True)
    out["loop"] = loop

    data = work / "mmmf_cli.npz"
    save_npz_schema(str(data), {"_real": y, "_known": kn, "_test_on": te})
    res_path = work / "mmmf_cli.pkl"
    t0 = time.perf_counter()
    active_mmmf.main(["--load-data", str(data), "-s", "2", "--admm-iters",
                      str(MM_LOOP_ADMM_ITERS), "--save-results",
                      str(res_path), "random"])
    cli_s = time.perf_counter() - t0
    with open(res_path, "rb") as f:
        res = pickle.load(f)
    cli = dict(s=cli_s, keys=sorted(res), kind=res["_kind"],
               era=res["_solver_era"])
    print(json.dumps(dict(phase="active_mmmf_cli", **cli)), flush=True)
    check(set(res) == {"_real", "_rating_vals", "_kind", "_args",
                       "_solver_era", "mmmf_random"}
          and res["_args"]["device"] == "cuda"
          and len(res["mmmf_random"]) == 2,
          f"active_mmmf CLI: {cli}")
    out["cli"] = cli
    return out


def scan_phases(device, prob, real, known, vn_loop):
    """Phase 30: the scan sweeps (active/scan_loop) beside the host loops
    they share their families with: the sweep's own step reads nothing
    (a device-only stub family under sync debug mode "error"); each
    family's sweep and host loop from the same state and seeds give the
    same records, with their seconds and host reads a step; the Gibbs
    exp-variance sweep launches the Cholesky kernel and never its plain
    version."""
    import numpy as np
    import torch
    from amf_tpu_torch import bench, types
    from amf_tpu_torch.active import scan_loop
    from amf_tpu_torch.active.gibbs_loop import run_active_gibbs
    from amf_tpu_torch.active.loop import run_active_pmf
    from amf_tpu_torch.active.stan_loop import run_active_stan
    from amf_tpu_torch.ops import chol_kernel as ck

    stamp("30")
    out = {}
    f32 = torch.float32

    # the sweep's own step: a stub family that never leaves the device
    sm = torch.linspace(0.0, 1.0, N * M, device=device).view(N, M)
    real_t = torch.as_tensor(real, dtype=f32, device=device)
    state0 = torch.zeros((), dtype=f32, device=device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trace, st = scan_loop.sweep_steps(
            prob, real_t, state0,
            score=lambda st, p, k: sm + st,
            refit=lambda st, p, k: st + 1.0,
            err=lambda st, p: torch.where(p.rated, p.R_obs, 0.0).sum() + st,
            steps=5, seed=0, maximize=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    picks = trace[:20].view(5, 4)[:, 2].long().tolist()
    check(float(st) == 5.0 and picks == sorted(picks, reverse=True)
          and len(set(picks)) == 5, f"stub sweep: picks {picks}")
    out["stub_sweep"] = dict(steps=5, host_reads_in_steps=0, picks=picks)

    def side_by_side(name, host_fn, scan_fn, queries, rtol):
        """The host loop's and the sweep's records, seconds a step and host
        reads a step, from the same state and seeds."""
        rows = {}
        for path, fn in (("host", host_fn), ("scan", scan_fn)):
            with host_reads() as reads:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                recs = fn()
                torch.cuda.synchronize()
                s = time.perf_counter() - t0
            rows[path] = dict(records=recs, s=s, reads=reads[0])
        h, c = rows["host"]["records"], rows["scan"]["records"]
        row = dict(queries=queries,
                   picks=[r[2] for r in c[1:]],
                   errs=[r[1] for r in c],
                   err_max_rel_diff=max(abs(a[1] - b[1]) / abs(a[1])
                                        for a, b in zip(h, c)),
                   **{f"{p}_s": rows[p]["s"] for p in rows},
                   **{f"{p}_s_per_step": rows[p]["s"] / queries
                      for p in rows},
                   **{f"{p}_host_reads_per_step": rows[p]["reads"] / queries
                      for p in rows})
        check(len(h) == len(c) == queries + 1
              and [r[2] for r in h] == [r[2] for r in c]
              and [r[0] for r in h] == [r[0] for r in c]
              and row["err_max_rel_diff"] <= rtol
              and all(math.isfinite(r[1]) for r in c),
              f"{name}: host {[r[:3] for r in h]} scan {[r[:3] for r in c]}")
        print(json.dumps(dict(phase="scan_sweep", case=name, **row)),
              flush=True)
        return row

    # vn: phase 15's loop, pred-variance, from the same state and seeds
    lreal, lprob, _, _ = bench.vn_problem(bench.CARD, device, f32)
    vn_kw = dict(latent_d=VN_D, refit_lookahead=True, seed=0, model="vn",
                 lookahead_budget=VN_REFIT_STEPS, lookahead_tile=VN_TILE,
                 cov_param="chol", dtype=f32, device=device)
    out["vn"] = side_by_side(
        "vn pred-variance",
        lambda: run_active_pmf(lprob, lreal, ["pred-variance"], steps=2,
                               **vn_kw)["pred-variance"],
        lambda: scan_loop.result_to_records(lprob, scan_loop.run_active_scan(
            lprob, lreal, "pred-variance", 1, **vn_kw)[0]),
        1, SCAN_ERR_RTOL)
    check(out["vn"]["picks"] == vn_loop["picks"]
          and all(math.isclose(a, b, rel_tol=SCAN_ERR_RTOL)
                  for a, b in zip(out["vn"]["errs"], vn_loop["rmse"])),
          f"vn sweep against phase 15: {out['vn']} {vn_loop}")

    # Gibbs at the MovieLens shape: pred-variance over the whole pool, and
    # exp-variance over a 64-cell pool through the Cholesky kernel
    g_kw = dict(latent_d=D, rating_values=VALS, num_samps=BASE_SAMPS,
                lookahead_samps=LA_SAMPS, lookahead_tile=TILE, seed=0,
                dtype=f32, device=device)
    out["gibbs_pred_variance"] = side_by_side(
        "gibbs pred-variance",
        lambda: run_active_gibbs(prob, real, ["pred-variance"],
                                 steps=SCAN_GIBBS_STEPS + 1,
                                 **g_kw)["pred-variance"],
        lambda: scan_loop.result_to_records(prob, scan_loop.run_gibbs_scan(
            prob, real, "pred-variance", SCAN_GIBBS_STEPS, **g_kw)[0]),
        SCAN_GIBBS_STEPS, SCAN_ERR_RTOL)
    q = np.flatnonzero(prob.queryable.cpu().numpy().ravel())
    pool = np.zeros(N * M, bool)
    pool[np.random.default_rng(30).choice(q, size=POOL, replace=False)] = True
    prob_pool = types.problem_from_dense(real, known,
                                         queryable=pool.reshape(N, M),
                                         dtype=f32, device=device)
    launches = {}

    def counted(fn, path):
        def run():
            ck.chol_gram_solve_sample_cuda.launches = 0
            ck.chol_solve_sample_batch_minor.launches = 0
            ck.chol_solve_sample_reference.calls = 0
            res = fn()
            launches[path] = dict(
                gram_fed=ck.chol_gram_solve_sample_cuda.launches,
                s_given=ck.chol_solve_sample_batch_minor.launches,
                plain=ck.chol_solve_sample_reference.calls)
            return res
        return run

    out["gibbs_exp_variance"] = side_by_side(
        "gibbs exp-variance",
        counted(lambda: run_active_gibbs(prob_pool, real, ["exp-variance"],
                                         steps=SCAN_EV_STEPS + 1,
                                         **g_kw)["exp-variance"], "host"),
        counted(lambda: scan_loop.result_to_records(
            prob_pool, scan_loop.run_gibbs_scan(
                prob_pool, real, "exp-variance", SCAN_EV_STEPS,
                **g_kw)[0]), "scan"),
        SCAN_EV_STEPS, SCAN_ERR_RTOL)
    out["gibbs_exp_variance"]["chol_kernel"] = launches
    check(launches["scan"]["gram_fed"] > 0
          and launches["scan"]["plain"] == launches["scan"]["s_given"] == 0,
          f"the exp-variance sweep's Cholesky launches: {launches}")

    # the stan sweep on 12 x 10
    sreal, _, sprob = nuts_problem(device, 12, 10, f32, seed=4, mask=0.3)
    s_kw = dict(latent_d=STAN_D, rating_values=VALS, num_samps=10, warmup=6,
                seed=0, dtype=f32, device=device)
    out["stan_pred_variance"] = side_by_side(
        "stan pred-variance",
        lambda: run_active_stan(sprob, sreal, ["pred-variance"],
                                steps=SCAN_STAN_STEPS + 1,
                                **s_kw)["pred-variance"],
        lambda: scan_loop.result_to_records(sprob, scan_loop.run_stan_scan(
            sprob, sreal, "pred-variance", SCAN_STAN_STEPS, **s_kw)[0]),
        SCAN_STAN_STEPS, SCAN_ERR_RTOL)
    return out


def fit_type_phases(device, real, known):
    """Phase 27: the PMF fit types at the MovieLens shape, d = 10, f32:
    'batch', 'lbfgs' (ops/lbfgsb on the closed-form gradient) and
    'mini-valid' (one CUDA graph an epoch), with one mini-valid epoch
    timed graphed and eager."""
    import torch
    from amf_tpu_torch import types
    from amf_tpu_torch.models import pmf
    from amf_tpu_torch.ops import lbfgsb
    from amf_tpu_torch.utils import profiling
    from amf_tpu_torch.utils.rng import generator

    stamp("27")
    prob = types.problem_from_dense(real, known, dtype=torch.float32,
                                    device=device)
    cfg = pmf.PMFConfig(latent_d=FT_D, subtract_mean=True)
    st0 = pmf.init_state(generator(21, device), N, M, cfg, prob,
                         dtype=torch.float32, device=device)
    mini = ("mini-valid", FT_BATCH, FT_VALID, FT_LR, 0.8, 1e-3,
            FT_MAX_EPOCHS)

    def epoch_times(fit):
        """``fit()`` under ``profiling.tracing()``: (its result, the host
        seconds of each 'mini-valid' epoch it ran)."""
        with profiling.tracing():
            profiling.spans(reset=True)
            out = fit()
        return out, [sp.host_s for sp in profiling.spans(reset=True)
                     if sp.name == "pmf.minibatch_epoch"]

    rows = {}
    for name, fit_type in (("batch", ("batch",)), ("lbfgs", ("lbfgs",)),
                           ("mini-valid", mini)):
        torch.cuda.synchronize()
        lbfgsb.Counters.reset()
        t0 = time.perf_counter()
        st, times = epoch_times(lambda: pmf.do_fit(
            st0, prob, cfg, fit_type=fit_type,
            generator=generator(22, device)))
        torch.cuda.synchronize()
        rows[name] = dict(s=time.perf_counter() - t0, epochs=len(times),
                          ll=float(pmf.log_likelihood(st, prob, cfg)),
                          rmse_rated=float(pmf.rmse(st, prob, cfg,
                                                    prob.R_obs,
                                                    on=prob.rated)))
        if name == "lbfgs":
            rows[name].update(lbfgsb.Counters.read())
    rows["init_ll"] = float(pmf.log_likelihood(st0, prob, cfg))

    # one mini-valid epoch eager and as one CUDA graph, in turns: three
    # epochs a fit (no early stop), the first of a graphed fit with its
    # capture
    for graph in (False, True, True, False):
        _, times = epoch_times(lambda: pmf.fit_minibatches_until_validation(
            st0, prob, cfg, generator(23, device), FT_BATCH, FT_VALID,
            lr=FT_LR, stop_thresh=-math.inf, max_epochs=3, graph=graph))
        key = "graphed" if graph else "eager"
        rows.setdefault(f"epoch_{key}_s", []).extend(times[1:])
        rows.setdefault(f"first_epoch_{key}_s", []).append(times[0])
    # the graphed epochs against the eager ones in float64, three epochs
    # from the same draws: the same operations, the scatter-adds' atomics
    # in either order
    prob64 = prob.to(dtype=torch.float64)
    st64 = dataclasses.replace(st0, **{
        f.name: getattr(st0, f.name).double()
        for f in dataclasses.fields(st0)})
    fits = [pmf.fit_minibatches_until_validation(
        st64, prob64, cfg, generator(24, device), FT_BATCH, FT_VALID,
        lr=FT_LR, stop_thresh=-math.inf, max_epochs=3, graph=graph)
        for graph in (True, False)]
    rows["graphed_vs_eager_f64"] = max(
        float(((a - b).abs() / (1 + b.abs())).max())
        for a, b in ((fits[0].U, fits[1].U), (fits[0].V, fits[1].V)))
    n_batches = -(-N * M // FT_BATCH)
    rows.update(n=N, m=M, d=FT_D, batch_size=FT_BATCH,
                steps_per_epoch=n_batches)
    print(json.dumps(dict(phase="fit_types", **rows)), flush=True)
    check(all(math.isfinite(rows[k]["ll"]) for k in ("batch", "lbfgs",
                                                       "mini-valid"))
          and rows["lbfgs"]["ll"] > rows["init_ll"]
          and rows["mini-valid"]["ll"] > rows["init_ll"]
          and rows["graphed_vs_eager_f64"] <= FT_GRAPH_TOL,
          f"fit types: {rows}")
    return rows


def traced_phase(work, name, fn, trace=True):
    """``fn()`` inside the port's ``device_trace`` (a Chrome trace of the
    card under ``work``; with ``trace=False`` outside it), with the
    Cholesky counts set to 0 just before and read just after: (its result,
    wall s including the profiler's own cost, the counts, the trace's MB
    and the seconds it took to write). The trace is not parsed here: a
    phase's hundreds of thousands of launches take the profiler minutes to
    sort."""
    import torch

    from amf_tpu_torch.ops import chol_kernel as ck
    from amf_tpu_torch.utils.profiling import device_trace

    ck.chol_gram_solve_sample_cuda.launches = 0
    ck.chol_solve_sample_batch_minor.launches = 0
    ck.chol_solve_sample_reference.calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = work / f"trace_{name}"
    with device_trace(str(path)) if trace else contextlib.nullcontext():
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if not trace:
        return res, wall, ck.launch_counts(), dict(traced=False)
    return res, wall, ck.launch_counts(), dict(
        traced=True, trace_mb=(path / "trace.json").stat().st_size / 1e6,
        trace_write_s=time.perf_counter() - t0 - wall)


def results_phases(real, known):
    """Phases 31-34: the result tools, the experiment runner and the parity
    checks, on phase 3's ratings; every CLI on its default device, the
    card. Nothing here imports matplotlib: the card host has none, and the
    text paths need none."""
    import io
    import os
    import shutil
    import signal
    import threading
    from collections import Counter

    import numpy as np

    from amf_tpu_torch.analysis import parity
    from amf_tpu_torch.analysis import results as R
    from amf_tpu_torch.data.loaders import save_npz_schema
    from amf_tpu_torch.models import bpmf_gibbs
    from amf_tpu_torch.ops import chol_kernel as ck
    from amf_tpu_torch.run import (compare_firsts, get_criteria, get_samples,
                                   plot_aucs, plot_results)

    work = ROOT / "build" / "chip_smoke_results"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out = {}

    def printed(fn, lines=None):
        """fn()'s standard output, echoed (its first ``lines`` lines)."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn()
        text = buf.getvalue()
        print("\n".join(text.splitlines()[:lines]), flush=True)
        return text

    def no_plain(counts, what):
        check(counts["s_given"] == 0 and counts["plain"] == 0,
              f"{what}: the S-given entry or the plain Cholesky ran on the "
              f"card: {counts}")

    stamp("31")
    # ---- 31. get_samples at the MovieLens shape: phase 3's ratings
    data = work / "movielens_shape.npz"
    save_npz_schema(str(data), {"_real": real, "_known": known,
                                "_rating_vals": np.asarray(VALS)})
    samples = work / "samples.npz"
    _, wall, counts, split = traced_phase(work, "get_samples", lambda: (
        get_samples.main(["--load-data", str(data), "-D", str(D), "-S",
                          str(BASE_SAMPS), "--float32", "--out",
                          str(samples)])))
    f = np.load(samples)
    draws = BASE_SAMPS * bpmf_gibbs.GibbsConfig().num_gibbs * 2
    gs = dict(s=wall, s_per_draw=wall / BASE_SAMPS, draws=BASE_SAMPS,
              U=list(f["U"].shape), V=list(f["V"].shape), **counts, **split)
    print(json.dumps(dict(phase="get_samples", **gs)), flush=True)
    check(f["U"].shape == (BASE_SAMPS, N, D) and f["V"].shape
          == (BASE_SAMPS, M, D), f"get_samples shapes {gs}")
    check(bool(np.isfinite(f["U"]).all() and np.isfinite(f["V"]).all()
               and np.isfinite(f["mean_rating"])),
          "get_samples wrote non-finite draws")
    # a draw: num_gibbs sweeps, a U and a V row draw each, one launch a draw
    check(counts["gram_fed"] == draws,
          f"get_samples launched the Gram-fed kernel {counts['gram_fed']} "
          f"times: want {draws}")
    no_plain(counts, "get_samples")
    out["get_samples"] = gs

    stamp("32")
    # ---- 32. get_criteria at its defaults (10 x 10, d = 2, 2 steps),
    # outside the trace: its vn lookahead (psd-project on 40 x 40
    # covariances, above the size PyTorch's batched eigh takes in one
    # call) launches so many kernels that the profiler took minutes to
    # write their trace
    crit = work / "criteria"
    text, wall, counts, split = traced_phase(work, "get_criteria", lambda: (
        printed(lambda: get_criteria.main(["--outdir", str(crit)]))),
        trace=False)
    taus = [ln for ln in text.splitlines() if ln.startswith("kendall-tau")]
    maps = {}
    for name in ("apmf", "bayes"):
        res = R.load_results(str(crit / f"results_{name}.pkl"))
        real_c, rated = res["_real"], np.zeros(res["_real"].shape, bool)
        rated[tuple(res["_ratings"][:, :2].astype(int).T)] = True
        pool = int((np.isfinite(real_c) & (real_c != 0) & ~rated).sum())
        for key, recs in res.items():
            if key.startswith("_"):
                continue
            # 2 steps: the initial record and one query, whose map is
            # finite on exactly the queryable cells, NaN elsewhere
            ev = recs[1][3]
            maps[key] = dict(finite=int(np.isfinite(ev).sum()), pool=pool)
            check(len(recs) == 2 and all(np.isfinite(r[1]) for r in recs)
                  and int(np.isfinite(ev).sum()) == pool
                  and not np.isinf(ev).any(),
                  f"get_criteria {key}: {maps[key]}")
    gc = dict(s=wall, taus=taus, finite_cells=maps, **counts, **split)
    print(json.dumps(dict(phase="get_criteria", **gc)), flush=True)
    check(len(taus) == 6, f"get_criteria printed {taus}")
    check(counts["gram_fed"] > 0, f"get_criteria: B1 not launched {counts}")
    no_plain(counts, "get_criteria")
    out["get_criteria"] = gc

    stamp("33")
    # ---- 33. the experiment runner, all five arms, then parity and the
    # text CLIs on what it wrote; the arms run as processes of their own,
    # each appending its Cholesky counts to a file at its exit
    exp_dir = work / "experiments" / EXP_NAME
    counts_file = work / "arm_counts.jsonl"

    def run_experiment():
        env = dict(os.environ, **{ck.COUNTS_FILE_ENV: str(counts_file)})
        # the runner and its arms in a process group of their own, killed
        # whole at the time limit; each arm's seconds from the runner's
        # "[arm] running:" lines
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "amf_tpu_torch.run.experiment", EXP_NAME,
             "--outdir", str(work / "experiments"), "--steps",
             str(EXP_STEPS), "--device", "cuda", "--only", *EXP_ARMS,
             *(a for kv in EXP_SET for a in ("--set", kv))],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True)
        timer = threading.Timer(EXP_TIMEOUT_S, os.killpg,
                                (proc.pid, signal.SIGKILL))
        timer.start()
        marks = [("data", t0)]
        try:
            for line in proc.stdout:
                if line.startswith("[") and "] running:" in line:
                    marks.append((line[1:line.index("]")],
                                  time.perf_counter()))
                print(line, end="", flush=True)
            returncode = proc.wait()
        finally:
            timer.cancel()
        runner_s = time.perf_counter() - t0
        marks.append(("end", t0 + runner_s))
        arm_s = {a: t1 - ta for (a, ta), (_, t1) in zip(marks, marks[1:])}
        print(json.dumps(dict(phase="experiment_arms", s=arm_s)), flush=True)
        check(returncode == 0, f"experiment runner exited {returncode}")
        t0 = time.perf_counter()
        rows, hard_ok = parity.check_experiment_dir(str(exp_dir))
        pkls = sorted(str(p) for p in exp_dir.glob("results_*.pkl"))
        text = printed(lambda: (
            plot_results.main(pkls + ["--aucs"]), plot_aucs.main(pkls)))
        text += printed(lambda: compare_firsts.main(pkls), lines=12)
        return (runner_s, arm_s, rows, hard_ok, pkls, text,
                time.perf_counter() - t0)

    (runner_s, arm_s, rows, hard_ok, pkls, text, host_s), wall, _, split = (
        traced_phase(work, "experiment", run_experiment))
    arms = {}
    for line in counts_file.read_text().splitlines():
        rec = json.loads(line)
        arm = Path(rec["argv"][0]).stem
        arms[arm] = {k: arms.get(arm, {}).get(k, 0) + rec[k]
                     for k in ("gram_fed", "s_given", "plain")}
    for row in rows:
        print(f"[{row['status']:<4}] {row['check']:<20} "
              f"{row.get('run', '-'):<6} "
              f"{row['key']}  {row['detail']}", flush=True)
    hard = [r for r in rows
            if r["check"] in ("structural", "initial_consistency")]
    exp = dict(s=wall, runner_s=runner_s, arm_s=arm_s,
               parity_and_text_s=host_s,
               results=[Path(p).name for p in pkls], rows=len(rows),
               hard_ok=hard_ok,
               statuses=dict(Counter(r["status"] for r in rows)),
               arm_counts=arms, **split)
    print(json.dumps(dict(phase="experiment", **exp)), flush=True)
    check(len(pkls) == len(EXP_ARMS), f"experiment wrote {pkls}")
    check(len(hard) >= len(EXP_ARMS)
          and all(r["status"] == "pass" for r in hard),
          f"experiment: a structural row failed: {hard}")
    check(arms.get("bayes_pmf", {}).get("gram_fed", 0) > 0,
          f"the bayes arm launched no B1: {arms}")
    check(all(c["s_given"] == 0 and c["plain"] == 0 for c in arms.values()),
          f"an arm ran the S-given entry or the plain Cholesky: {arms}")
    check(all(h in text for h in ("area under RMSE curve", "auc mean",
                                  "kendall_tau")),
          "the text CLIs printed no table")
    out["experiment"] = exp

    stamp("34")
    # ---- 34. parity on copies of committed experiment directories
    def committed():
        got = {}
        for name, (n_rows, ok) in COMMITTED_PARITY.items():
            dst = work / "committed" / name
            shutil.copytree(ROOT / "experiments" / name, dst)
            rows, hard_ok = parity.check_experiment_dir(str(dst))
            got[name] = dict(rows=len(rows), hard_ok=hard_ok, statuses=dict(
                Counter(r["status"] for r in rows)))
            check(len(rows) == n_rows and hard_ok is ok,
                  f"parity on {name}: {got[name]}, want {n_rows} rows and "
                  f"hard_ok {ok}")
        return got

    got, wall, _, _ = traced_phase(work, "parity", committed)
    print(json.dumps(dict(phase="parity_committed", s=wall, **got)),
          flush=True)
    check("matplotlib" not in sys.modules, "a phase imported matplotlib")
    check(not any(m == "jax" or m.startswith(("jax.", "amf_tpu."))
                  for m in sys.modules), "a phase imported JAX")
    out["parity_committed"] = got
    return out


def sharding_phases(device, prob, pst, stats, pcfg, gcfg, cand,
                    unsharded):
    """Phases 35-36: candidate and chain sharding (``parallel/``) on the
    card. ``unsharded`` is phase 3's tile of ``cand`` under seed 3."""
    import numpy as np
    import torch

    from amf_tpu_torch import entry, types
    from amf_tpu_torch.data.loaders import save_npz_schema
    from amf_tpu_torch.data.synthetic import make_fake_data
    from amf_tpu_torch.models import bpmf_gibbs
    from amf_tpu_torch.ops import chol_kernel as ck
    from amf_tpu_torch.parallel import dryrun, mesh, sharding
    from amf_tpu_torch.run import bayes_pmf

    out = {}
    kw = dict(num_samps=LA_SAMPS, fit_budget=FIT_BUDGET,
              n_base_samples=BASE_SAMPS, poly_ls=True)
    draws = LA_SAMPS * gcfg.num_gibbs * 2  # B1 launches a tile

    stamp("35")
    # (a) a world of one over NCCL in this process against the unsharded
    # tile: the same operations on the same inputs
    again = bpmf_gibbs.exp_variance_scores(3, pst, prob, pcfg, gcfg, stats,
                                           VALS, cand=cand, **kw)
    deterministic = bool(torch.equal(again, unsharded))
    m1 = mesh.make_mesh(1, device=device)
    try:
        check(m1.backend == mesh._backend_for(device, None),
              f"a world of one on {m1.backend}")
        ck.chol_gram_solve_sample_cuda.launches = 0
        ck.chol_solve_sample_batch_minor.launches = 0
        ck.chol_solve_sample_reference.calls = 0
        t0 = time.perf_counter()
        one = sharding.sharded_candidate_scores(
            lambda c, s: bpmf_gibbs.exp_variance_scores(
                s, pst, prob, pcfg, gcfg, stats, VALS, cand=c, **kw),
            N * M, m1, cand)(3)[cand]
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ck.launch_counts()
    finally:
        m1.close()
    diff = (one - unsharded).abs().max().item()
    out["world_of_one"] = dict(
        bitwise=bool(torch.equal(one, unsharded)), max_abs_diff=diff,
        unsharded_deterministic=deterministic, tile_s=wall, **counts)
    print(json.dumps(dict(phase="shard_world_of_one", **out["world_of_one"])),
          flush=True)
    check(counts["gram_fed"] == draws and counts["plain"] == 0
          and counts["s_given"] == 0,
          f"the world of one's tile: {counts}, want {draws} Gram-fed "
          "launches and no plain call")
    # bit for bit where the unsharded tile is itself bitwise repeatable
    check(torch.equal(one, unsharded) if deterministic
          else diff <= 1e-6 * unsharded.abs().max().item(),
          f"a world of one scores {diff} off the unsharded tile")

    # (b) two ranks sharing the card over gloo, named explicitly: 64
    # candidates in tiles of 32, so that each rank scores one of the
    # unsharded run's tiles
    cand64 = torch.nonzero(prob.queryable.flatten())[:2 * TILE, 0]
    kw64 = dict(kw, candidate_tile=TILE)
    plain64 = bpmf_gibbs.exp_variance_scores(3, pst, prob, pcfg, gcfg, stats,
                                             VALS, cand=cand64, **kw64)

    def host(x):
        return dataclasses.replace(x, **{
            f.name: getattr(x, f.name).cpu()
            for f in dataclasses.fields(x)})

    inputs = (3, host(pst), prob.to(device="cpu"), pcfg, gcfg,
              type(stats)(*(None if x is None else x.cpu() for x in stats)),
              VALS, cand64.cpu(), kw64)

    def on_ranks(n, backend, name):
        t0 = time.perf_counter()
        got = mesh.launch(dryrun.gibbs_tile_on_ranks, n, device.type, backend,
                          *inputs)
        wall = time.perf_counter() - t0
        scores = torch.as_tensor(got["scores"], device=device)
        rel = ((scores - plain64).abs() / plain64.abs()).max().item()
        row = dict(ranks=n, backend=backend, launch_s=wall,
                   max_rel_diff=rel, max_abs_diff=(
                       scores - plain64).abs().max().item(),
                   same_pick=int(scores.argmin()) == int(plain64.argmin()),
                   per_rank=got["ranks"])
        print(json.dumps(dict(phase=name, **row)), flush=True)
        check(rel <= 1e-6 and row["same_pick"],
              f"{name}: sharded scores {rel} off the unsharded ones")
        check(all(r["gram_fed"] == draws and r["plain"] == 0
                  and r["s_given"] == 0 for r in got["ranks"]),
              f"{name}: a rank's tile did not go through the Gram-fed "
              f"kernel alone: {got['ranks']}")
        return row

    out["gloo_shared_card"] = on_ranks(2, "gloo", "shard_gloo_two_ranks")
    # (c) NCCL across two cards, where there are two
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        out["nccl_two_cards"] = on_ranks(2, "nccl", "shard_nccl_two_cards")
    else:
        print(json.dumps(dict(phase="shard_nccl_two_cards", skipped=True,
                              device_count=n_cards)), flush=True)

    # (d) the bayes_pmf CLI with --shard-candidates 1 against it without
    work = ROOT / "build" / "chip_smoke_shard"
    work.mkdir(parents=True, exist_ok=True)
    real, known, _ = make_fake_data(num_users=24, num_items=30, rank=3,
                                    mask_type=0.3,
                                    rng=np.random.default_rng(5))
    real = np.clip(np.round(real - real.mean() + 3.0), 1.0, 5.0)
    data = work / "small.npz"
    save_npz_schema(str(data), {"_real": real, "_known": known,
                                "_rating_vals": np.asarray(VALS)})
    argv = ["--load-data", str(data), "-D", "3", "-s", "3", "-S", "16",
            "--lookahead-samps", "4", "--test-set", "0.95", "--float32",
            "--no-verbose", "--device", device.type]
    recs = {}
    for flag in ([], ["--shard-candidates", "1"]):
        path = work / f"cli{len(flag)}.pkl"
        t0 = time.perf_counter()
        bayes_pmf.main(argv + flag + ["--save-results", str(path),
                                      "exp-variance"])
        with open(path, "rb") as f:
            recs[len(flag)] = ([r[:3] for r in pickle.load(f)["exp-variance"]],
                               time.perf_counter() - t0)
    (plain_recs, plain_s), (shard_recs, shard_s) = recs[0], recs[2]
    out["cli"] = dict(records=len(plain_recs), plain_s=plain_s,
                      sharded_s=shard_s,
                      same_picks=[r[2] for r in plain_recs]
                      == [r[2] for r in shard_recs],
                      max_err_diff=max(abs(a[1] - b[1]) for a, b in
                                       zip(plain_recs, shard_recs)))
    print(json.dumps(dict(phase="shard_bayes_pmf_cli", **out["cli"])),
          flush=True)
    check(len(plain_recs) == 3 and out["cli"]["same_picks"]
          and out["cli"]["max_err_diff"] <= 1e-5,
          f"bayes_pmf --shard-candidates 1: {plain_recs} against "
          f"{shard_recs}")

    stamp("36")
    # the dry run on two ranks sharing the card (gloo) against the same
    # paths unsharded in this process, float64
    t0 = time.perf_counter()
    got = entry.dryrun_multichip(2, device=device.type, backend="gloo")
    dry_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = dryrun.dryrun_step(None, chains=4, device=device)
    plain_s = time.perf_counter() - t0

    def rel(a, b):
        a, b = np.asarray(a, float), np.asarray(b, float)
        fin = np.isfinite(b)
        return float(np.max(np.abs(a[fin] - b[fin])
                            / np.maximum(np.abs(b[fin]), 1e-30)))

    fams = {k: rel(got[k]["scores"], want[k]["scores"])
            for k in ("vn", "gibbs", "nuts", "newitems", "rc")}
    chains = {k: rel(got["chains"][k], want["chains"][k])
              for k in ("U", "lp__", "mode_q", "adapt_inv_mass")}
    out["dryrun"] = dict(
        launch_s=dry_s, unsharded_s=plain_s, setup_s=got["setup_s"],
        scores_max_rel_diff=fams, chains_max_rel_diff=chains,
        same_pick=got["vn"]["pick"] == want["vn"]["pick"],
        same_loop_picks=[r[2] for r in got["loop"]]
        == [r[2] for r in want["loop"]])
    print(json.dumps(dict(phase="dryrun_multichip_2", **out["dryrun"])),
          flush=True)
    check(out["dryrun"]["same_pick"] and out["dryrun"]["same_loop_picks"]
          and max(fams.values()) <= 1e-6 and max(chains.values()) <= 1e-5,
          f"the sharded dry run parts from the unsharded one: {out['dryrun']}")
    return out


def bench_phase(device, card):
    """Phase 37: the port's bench (``amf_tpu_torch/bench.py``) in this
    process, through ``bench.run`` at its card workload with the
    psd-project row cut to one tile of VN_PSD_CAND candidates: its line
    parsed and checked, the launches of its rows counted from 0. Returns
    (the line, the rows, the counts)."""
    from amf_tpu_torch import bench
    from amf_tpu_torch.ops import chol_kernel as ck
    from amf_tpu_torch.ops import pmf_kernels as pk

    ck.chol_gram_solve_sample_cuda.launches = 0
    ck.chol_solve_sample_batch_minor.launches = 0
    ck.chol_solve_sample_reference.calls = 0
    pk.pmf_value_grad_cuda.launches.clear()
    pk.pmf_value_grad_cuda.variants.clear()
    pk.pmf_value_grad_plain.calls = 0
    index_before = pk.rated_index.calls
    t0 = time.perf_counter()
    line, rows = bench.run(bench.CARD, device, psd_cap=VN_PSD_CAND)
    wall = time.perf_counter() - t0
    counts = dict(b1=ck.launch_counts(),
                  b2={"/".join(k): v
                      for k, v in pk.pmf_value_grad_cuda.launches.items()},
                  b2_global=pk.pmf_value_grad_cuda.variants["global"],
                  b2_plain=pk.pmf_value_grad_plain.calls,
                  index_builds=pk.rated_index.calls - index_before)
    text = json.dumps(line)
    print("bench-line " + text, flush=True)
    parsed = json.loads(text)
    head, refit = rows["gibbs"], rows.get("refit")
    print(json.dumps(dict(
        phase="bench", wall_s=wall, **counts,
        rows={k: {f: v for f, v in r.items()
                  if isinstance(v, (int, float)) or v is None}
              for k, r in rows.items() if isinstance(r, dict)})),
        flush=True)
    check(parsed == line and parsed["platform"] == "cuda"
          and parsed["device"] == card, f"the bench's line: {text}")
    check("secondary_bench_faults" not in parsed,
          f"a bench row faulted: {parsed.get('secondary_bench_faults')}")
    rates = ("value", "pool_scores_per_sec", "device_only_scores_per_sec",
             "vn_total_variance_scores_per_sec",
             "vn_total_variance_chol_scores_per_sec",
             "pmf_refit_kernel_scores_per_sec", "vs_baseline")
    check(all(parsed[k] is not None and parsed[k] > 0 for k in rates),
          f"a bench rate null or not positive: {text}")
    value, pool = parsed["value"], parsed["pool_scores_per_sec"]
    # vs_baseline is round(value / pool, 1) before value and pool were
    # rounded (to 2 and 4 places)
    slack = 0.05 + value / pool * (0.005 / value + 0.00005 / pool) + 1e-9
    check(abs(parsed["vs_baseline"] - value / pool) <= slack,
          f"vs_baseline {parsed['vs_baseline']} against {value} / {pool}")
    # the headline: one launch of the Gram-fed kernel a row draw (a U and a
    # V draw a sweep, 2 sweeps a round): 512 in the 128-round base chain,
    # 120 a tile (30 rounds), never the plain version; the refit row: the
    # lane-blocked bf16 value+gradient kernel alone, one index build a
    # refit tile
    num_gibbs = head["state"][3].num_gibbs
    draws, base_draws = (2 * num_gibbs * LA_SAMPS,
                         2 * num_gibbs * BASE_SAMPS)
    check(counts["b1"]["gram_fed"] == base_draws + draws * head["tiles_run"]
          and counts["b1"]["s_given"] == 0 and counts["b1"]["plain"] == 0,
          f"the headline's base chain and {head['tiles_run']} tiles "
          f"launched {counts['b1']}: want {base_draws} + {draws} a tile "
          "Gram-fed launches and no plain call")
    check(set(counts["b2"]) == {"L,d,rows/torch.bfloat16"}
          and counts["b2_plain"] == 0 and counts["b2_global"] == 0,
          f"the refit row's value+gradient launches: {counts}")
    # one index build a refit tile of each sweep, and one a Gibbs chain (the
    # headline's base chain and each tile's lane chain sum their masked Gram
    # over it)
    chains = 1 + head["tiles_run"]
    check(counts["index_builds"] == 2 * refit["tiles"] + chains,
          f"{counts['index_builds']} index builds for two sweeps of "
          f"{refit['tiles']} refit tiles and {chains} Gibbs chains")
    return line, rows, counts


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
    from amf_tpu_torch.ops import gram_kernel as gk
    from amf_tpu_torch.ops import lane_noise as ln
    from amf_tpu_torch.ops import pmf_kernels as pk
    from amf_tpu_torch.ops import probe_kernels
    from amf_tpu_torch.run import add_rmse_boosts
    from amf_tpu_torch.utils.platform import resolve_device

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
    # (source, width): every source at the main paths' d = 10 and at
    # d = 48, which is a library of its own; the fused line search also at
    # d = 32 (phase 11), the Cholesky kernel (one library a width) at the
    # widths phase 2 holds to its plain version; the lane noise has no
    # width (d None), one library
    widths = [(src, d) for src in ("chol_solve_sample", "masked_gram",
                                   "pmf_value_grad", "pmf_line_coeffs",
                                   "pmf_lookahead_fused")
              for d in (D, WIDE_D)] + [("pmf_lookahead_fused", 32)] + [
                  ("chol_solve_sample", d) for d in (1, 5, 20, 32)] + [
                  ("lane_noise", None)]
    libraries = [(src, () if d is None else cuda_build.width_defines(src, d))
                 for src, d in widths]

    def build_s(lib):
        start = time.perf_counter()
        cuda_build.build(*lib)
        return round(time.perf_counter() - start, 1)

    with ThreadPoolExecutor(len(libraries)) as pool:
        each = list(pool.map(build_s, libraries))
    for (src, d), lib in zip(widths, libraries):
        if src == "chol_solve_sample":
            ck._entry_points(d)
        elif src == "masked_gram":
            gk._entry_points(d)
        elif src == "lane_noise":
            ln._entry_points()
        else:
            pk._entry_point(*lib)
    # a CLI run pays a library's seconds at its first use of a source, and
    # of a new -D where that is a library of its own
    build_s_by_lib = {(src if d is None else f"{src} d={d}")
                      + (f" {' '.join(lib[1])}" if lib[1] else ""): t
                      for (src, d), lib, t in zip(widths, libraries, each)}
    print(f"kernel build+load s {time.perf_counter() - t0:.1f} (each nvcc, "
          f"side by side: {json.dumps(build_s_by_lib)})", flush=True)

    stamp("37")
    # ---- 37. the port's bench in this process: its rows (the headline with
    # the pool, the refit row, the vn rows) and its line; phases 3, 7 and 13
    # read their rates from these rows. It runs before any phase has used
    # the profiler
    _, bench_rows, bench_counts = bench_phase(device, card)

    stamp("2")
    # ---- 2. kernel vs plain version on the card
    kern = kernel_rows(device)
    main_row = next(r for r in kern if r["dtype"] == "float32"
                    and r["B"] == 269120)
    gram = gram_rows(device)
    gram_row = next(r for r in gram if r["dtype"] == "float32"
                    and r["r"] == M and r["L"] == TILE * len(VALS))
    # the masked Gram from the rated-cell index, kernel against its plain
    # version and the dense product it replaces: at the main paths' d = 10
    # on the bench's own mask and tile (its own library), and at the
    # benchmark cells' shapes (d = 20)
    bench_prob = bench_rows["problem"][2]
    gram_index = probe_kernels.gram_cell_rows(
        device, {"bench": (TILE * len(VALS), bench_prob.rated,
                           bench_prob.R_obs)}, d=D)
    gram_index += probe_kernels.gram_cell_rows(device)
    for r in gram_index:
        check(r["launches"] == 1 and r["rel_vs_plain"]
              <= GRAM_INDEX_RTOL[r["dtype"]],
              f"the index Gram kernel disagrees with its plain version: {r}")
    gram_index_row = next(r for r in gram_index if r["cell"] == "bench"
                          and r["side"] == "V" and r["dtype"] == "float32")

    stamp("38")
    # ---- 38. the lane noise (N1) against the per-lane calls it replaces,
    # at both lookahead cells' rounds, f32 and f64: two rounds' values bit
    # for bit, the generators' offsets after them, one launch a round
    noise = probe_kernels.noise_cell_rows(device)
    for r in noise:
        check(r["equal"] and r["offsets_equal"] and r["launches"] == {
            f"normal+gamma/torch.{r['dtype']}": r["rounds"]},
              f"the lane-noise kernel is not the per-lane calls: {r}")
    noise_row = next(r for r in noise if r["cell"] == "db70x306-bpmf-d20"
                     and r["dtype"] == "float32")

    stamp("3")
    # ---- 3. the f32 lookahead tile at the bench shape: the bench's
    # headline (phase 37), its first timed tile at seed 3
    rng = np.random.default_rng(0)
    real, known, _ = make_fake_data(
        num_users=N, num_items=M, rank=D, noise=0.5,
        mask_type=0.05 * 100000 / (N * M), rng=rng)
    real = np.clip(np.round(real - real.mean() + 3.0), 1.0, 5.0)
    bench_real, bench_known, prob = bench_rows["problem"]
    check(np.array_equal(real, bench_real) and np.array_equal(
        known, bench_known), "the bench's problem is not phase 3's")
    head = bench_rows["gibbs"]
    pst, stats, pcfg, gcfg = head["state"]
    print(f"MAP fit + {BASE_SAMPS}-sample base chain s "
          f"{head['setup_s']:.2f}", flush=True)
    cand = cand32 = head["cand"][:TILE]

    def tile(dtype_pst, dtype_prob, dtype_stats):
        return bpmf_gibbs.exp_variance_scores(
            3, dtype_pst, dtype_prob, pcfg, gcfg, dtype_stats, VALS,
            num_samps=LA_SAMPS, fit_budget=FIT_BUDGET, cand=cand,
            n_base_samples=BASE_SAMPS, poly_ls=True)

    scores = head["scores"][0]
    # the headline's launches, counted in phase 37 (phase 2 has launched the
    # kernel and the plain version since); from here the counts run on
    # from them for phase 4
    la_launches = bench_counts["b1"]["gram_fed"]
    ck.chol_gram_solve_sample_cuda.launches = la_launches
    ck.chol_solve_sample_batch_minor.launches = bench_counts["b1"]["s_given"]
    ck.chol_solve_sample_reference.calls = bench_counts["b1"]["plain"]
    check(scores.shape == (TILE,), f"scores shape {tuple(scores.shape)}")
    check(bool(torch.isfinite(scores).all()), f"non-finite scores {scores}")
    check(bool((scores > 0).all()), f"non-positive scores {scores}")
    # a tile: 30 rounds of 2 sweeps, a U and a V draw each, one launch a
    # draw; the base chain the same over its 128 rounds
    draws = LA_SAMPS * gcfg.num_gibbs * 2
    base_draws = BASE_SAMPS * gcfg.num_gibbs * 2
    check(la_launches == base_draws + head["tiles_run"] * draws,
          f"the base chain and {head['tiles_run']} lookahead tiles launched "
          f"the Gram-fed kernel {la_launches} times: want {base_draws} + "
          f"{draws} a tile")
    check(ck.chol_solve_sample_batch_minor.launches == 0,
          "the S-given entry ran on the CUDA main path")
    check(ck.chol_solve_sample_reference.calls == 0,
          "the plain version ran on the CUDA main path")
    n_tiles = len(head["scores"])
    print(json.dumps(dict(
        phase="lookahead_f32", lanes=TILE * len(VALS),
        warm_tile_s=head["warm_s"], tiles=n_tiles, tiles_s=head["tiles_s"],
        tile_s_mean=head["tiles_s"] / n_tiles,
        candidates_per_s=head["value"],
        device_only_candidates_per_s=head["device_only"],
        one_tile_s=head["t1_s"], three_tiles_s=head["t3_s"],
        peak_mem_gib=head["peak_mem_gib"], kernel_launches=la_launches,
        launches_a_tile=draws, scores_min=scores.min().item(),
        scores_max=scores.max().item())), flush=True)

    # where a warm tile spends its time (profiled apart from the timed tiles
    # and from the launch counts above)
    split = device_split(lambda: tile(pst, prob, stats), top=14)
    ck.chol_gram_solve_sample_cuda.launches = la_launches
    print(json.dumps(dict(phase="lookahead_tile_profile", **split)),
          flush=True)

    stamp("4")
    # ---- 4. the active loop on a 64-cell pool
    q = np.flatnonzero(prob.queryable.cpu().numpy().ravel())
    pool = np.zeros(N * M, bool)
    pool[rng.choice(q, size=POOL, replace=False)] = True
    pool = pool.reshape(N, M)
    prob_pool = types.problem_from_dense(real, known, queryable=pool,
                                         dtype=torch.float32, device=device)
    before = ck.chol_gram_solve_sample_cuda.launches
    index_before = gk.masked_gram_cuda.launches
    ln.lane_noise_cuda.launches.clear()
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
    index_launches = gk.masked_gram_cuda.launches - index_before
    noise_launches = dict(ln.lane_noise_cuda.launches)
    # the problem's 0.3 % density takes the index Gram: one launch a draw
    check(index_launches == loop_launches,
          f"the active loop's {loop_launches} row draws launched the index "
          f"Gram {index_launches} times")
    # a Gibbs round: one lane-noise launch, then a U and a V draw a sweep
    a_round = 2 * gcfg.num_gibbs
    check(loop_launches % a_round == 0 and noise_launches == {
        ("normal+gamma", "torch.float32"): loop_launches // a_round},
          f"the active loop's {loop_launches // a_round} Gibbs rounds "
          f"launched the lane noise {noise_launches}")
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
        kernel_launches=loop_launches,
        lane_noise_launches=sum(noise_launches.values()))), flush=True)

    stamp("5")
    # ---- 5. the same tile in f64, through the kernel and the plain version
    def f64(x):
        return x.double() if torch.is_tensor(x) and x.is_floating_point() else x

    pst64 = dataclasses.replace(pst, **{
        f.name: f64(getattr(pst, f.name)) for f in dataclasses.fields(pst)})
    stats64 = bpmf_gibbs.PredStats(*(None if x is None else f64(x)
                                     for x in stats))
    prob64 = prob.to(dtype=torch.float64)
    t0 = time.perf_counter()
    s_kernel = tile(pst64, prob64, stats64)
    torch.cuda.synchronize()
    t_kernel = time.perf_counter() - t0
    check(ck.chol_gram_solve_sample_cuda.launches == main_launches + draws
          and ck.chol_solve_sample_reference.calls == 0,
          "the f64 tile did not go through the Gram-fed kernel alone")
    # the row draws through the plain version for this one tile
    bpmf_gibbs.chol_gram_solve_sample = functools.partial(
        ck.chol_gram_solve_sample, kernel=False)
    try:
        t0 = time.perf_counter()
        s_plain = tile(pst64, prob64, stats64)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
    finally:
        bpmf_gibbs.chol_gram_solve_sample = ck.chol_gram_solve_sample
    rel = ((s_kernel - s_plain).abs() / s_plain.abs()).max().item()
    print(json.dumps(dict(
        phase="lookahead_f64_kernel_vs_plain", max_rel_diff=rel,
        rtol=SCORE_RTOL_F64, tile_s_kernel=t_kernel, tile_s_plain=t_plain,
        plain_calls=ck.chol_solve_sample_reference.calls)),
        flush=True)
    check(bool(torch.isfinite(s_kernel).all()), "non-finite f64 scores")
    check(rel <= SCORE_RTOL_F64, f"f64 kernel vs plain scores differ by {rel}")

    stamp("6")
    # ---- 6. value+gradient kernel vs plain version, every variant
    vg = value_grad_rows(device, prob.R_obs, prob.rated)

    stamp("7")
    # ---- 7. the bench's lane-blocked PMF refit: 1024 candidates, 8 tiles;
    # the bf16 sweep is the bench's refit row (phase 37), the f32 one here
    refit_row = bench_rows["refit"]
    rst, rcfg = refit_row["state"]
    di, dj, dv = refit_row["cells"]
    tiles = [slice(s, s + PK_TILE) for s in range(0, PK_N_CAND, PK_TILE)]
    check(len(tiles) == refit_row["tiles"], "the bench's refit tiles")

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
    refit_rate = {True: refit_row["rate"]}
    refit_f = {True: refit_row["neg_ll"]}
    sweep(False)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    refit_f[False] = sweep(False)
    torch.cuda.synchronize()
    refit_rate[False] = PK_N_CAND / (time.perf_counter() - t0)
    # the bf16 launches are the bench row's, counted in phase 37
    refit_launches = {**{tuple(k.split("/")): v
                         for k, v in bench_counts["b2"].items()},
                      **pk.pmf_value_grad_cuda.launches}
    refit_index = index_builds_per_refit(since)
    check(pk.pmf_value_grad_plain.calls == 0,
          "the plain value+grad version ran on the refit path")
    check(refit_index[0] == refit_index[1] == 2 * len(tiles),
          f"index builds and refits of the f32 sweeps: {refit_index}")
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

    stamp("8")
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
    inner_boost_tile = add_rmse_boosts.boost_tile
    inner_descent = pmf.adaptive_descent

    def descent(*a, **kw):  # records the slowest lane's proposals
        x, info = inner_descent(*a, **kw)
        if tile_log:  # not the CLI's base fit
            tile_log[-1]["proposals"] = int(info.n_iters.max())
        return x, info

    def timed_tile(*a, **kw):
        tile_log.append({})
        t0 = time.perf_counter()
        out = inner_boost_tile(*a, **kw)
        torch.cuda.synchronize()
        tile_log[-1]["s"] = time.perf_counter() - t0
        return out

    add_rmse_boosts.boost_tile, pmf.adaptive_descent = timed_tile, descent
    pk.pmf_value_grad_cuda.launches.clear()
    pk.pmf_value_grad_plain.calls = 0
    since = (pk.rated_index.calls, fit_calls[0])
    try:
        t0 = time.perf_counter()
        add_rmse_boosts.main(["--load-data", str(data_path), "-D", str(D),
                              "--tile", str(CLI_TILE), "--out", str(out_path)])
        cli_s = time.perf_counter() - t0
    finally:
        add_rmse_boosts.boost_tile = inner_boost_tile
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
    check(len(tile_log) == CLI_POOL // CLI_TILE,
          f"the CLI's tiles did not pass through boost_tile: {tile_log}")
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

    stamp("9")
    # ---- 9. line-coefficient kernel vs plain version
    sig = torch.stack([rst.sigma_sq, rst.sigma_u_sq, rst.sigma_v_sq])
    lc = coeff_rows(pk, rst, prob, di, dj, dv, sig, device)

    stamp("10")
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

    stamp("11")
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
    # memory and e in a scratch buffer, held to the plain version; the same
    # at d = 48, and d = 48 on a problem small enough for shared memory
    gen = torch.Generator(device=device).manual_seed(11)
    small_rated = torch.rand(97, 131, generator=gen, device=device) < 0.1
    small_R = torch.randint(1, 6, (97, 131), generator=gen,
                            device=device).float() * small_rated
    small_cells = torch.nonzero(~small_rated)[:8]
    b5_global = {}
    for d, shape in ((32, "full"), (WIDE_D, "full"), (WIDE_D, "small")):
        if shape == "full":
            base = (prob.R_obs, prob.rated, ti[:8], tj[:8], tv[:8])
        else:
            base = (small_R, small_rated, small_cells[:, 0],
                    small_cells[:, 1], tv[:8])
        n_, m_ = base[0].shape
        start = [0.2 * torch.rand(d, k, generator=gen, device=device)
                 for k in (n_, m_)]
        variant = "global" if shape == "full" else "shared"
        for bf16 in (False, True):
            dtype = "bfloat16" if bf16 else "float32"
            gargs = (*start, *base[:2], *base[2:], sig, ls)
            index = (b5_index[bf16] if shape == "full" else
                     pk.rated_index(small_rated, small_R, bf16=bf16))
            before = pk.pmf_lookahead_fused_cuda.variants[variant]
            got = pk.pmf_lookahead_fused_cuda(*gargs, PK_REFIT_STEPS, bf16,
                                              index=index)
            again = pk.pmf_lookahead_fused_cuda(*gargs, PK_REFIT_STEPS, bf16,
                                                index=index)
            check(pk.pmf_lookahead_fused_cuda.variants[variant] == before + 2,
                  f"d = {d}, {shape} shape did not take the {variant} "
                  "variant")
            want, plain_ms = timed_ms(lambda: pk.pmf_lookahead_fused_plain(
                *gargs, PK_REFIT_STEPS, bf16))
            diffs = [(a.float() - b.float()).abs()
                     for a, b in zip(got[:3], want[:3])]
            row = b5_global[f"d{d}/{shape}/{dtype}"] = dict(
                lanes=8, d=d, n=n_, m=m_, variant=variant,
                steps=PK_REFIT_STEPS,
                lanes_same_evals=int((got[3] == want[3]).sum()),
                evals_max=int(got[3].max()), f_rel=rel(got[0], want[0]),
                factor_scaled=max(
                    (x / (1 + b.float().abs())).max().item()
                    for x, b in zip(diffs[1:], want[1:3])),
                max_abs_err=max(x.max().item() for x in diffs),
                ms=cuda_ms(lambda: pk.pmf_lookahead_fused_cuda(
                    *gargs, PK_REFIT_STEPS, bf16, index=index), 3),
                plain_ms=plain_ms)
            if d == WIDE_D and shape == "full":
                # bytes: the index, the base factors in, the lanes' factors
                # out; operations: 2 d a cell at every evaluation and 4 d at
                # the start and at every accept (as for the main tile)
                nnz = index.nnz
                cells = nnz + (~prob.rated[ti[:8], tj[:8]]).to(torch.int64)
                row["bound_ms"], row["bound_by"] = bound_ms(
                    (N + M + 2) * 4 + nnz * (12 + (2 if bf16 else 4))
                    + (N + M) * d * 4 + 8 * (N + M) * d * (2 if bf16 else 4),
                    d * int(((2 * got[3].to(torch.int64)
                              + 4 * (1 + got[4].to(torch.int64)))
                             * cells).sum()), dtype)
            check(all(torch.equal(g, a) for g, a in zip(got, again))
                  and row["lanes_same_evals"] == 8 and row["evals_max"] > 1
                  and row["f_rel"] <= FUSED_KERNEL_TOL["f"]
                  and row["factor_scaled"] <= FUSED_KERNEL_TOL[
                      "factors_bf16_moving" if bf16 else "factors"],
                  f"fused kernel, d = {d}, {variant} variant ({dtype}): "
                  f"{row}")
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
    stamp("12")
    # ---- 12. the main paths at d = 48
    wide = wide_main_paths(device, prob, real, knowable, rng, work)
    # ---- 13-16. the variational (ActivePMF) path
    vn = vn_phases(device, bench_rows)
    # ---- 17-21. the NUTS BPMF path
    nuts_phases(device)
    # ---- 22-24. RatingConcentration; 25-26. cold start; 27. fit types
    rc_phases(device, real, known)
    cold_start_phases(device, real, known)
    fit_type_phases(device, real, known)
    # ---- 28-29. MMMF; 30. the scan sweeps
    mmmf_phases(device, real, known)
    scan = scan_phases(device, prob, real, known,
                       vn["loops"]["vn"]["pred-variance"])
    # ---- 31-34. the result tools, the experiment runner, parity
    results = results_phases(real, known)
    # ---- 35-36. candidate and chain sharding
    shard = sharding_phases(device, prob, pst, stats, pcfg, gcfg, cand32,
                            scores)
    stamp("end")

    def wide_row(row, launches, src):
        """The d = 48 row of a kernel: its timed case of this run at the
        shape phase 12 gives it, and its launches there."""
        lib = f"{src} d={WIDE_D} " + " ".join(
            cuda_build.width_defines(src, WIDE_D))
        return {"d": WIDE_D, "L": row["L"], "launches": launches,
                **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by")},
                "build_s": build_s_by_lib[lib]}

    def vg_wide(layout, dtype, launches):
        row = next(r for r in vg if r["layout"] == layout and r["d"] == WIDE_D
                   and r["dtype"] == dtype and "ms" in r)
        return wide_row(row, launches, "pmf_value_grad")

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
            "library_ms": None,
            "d48": vg_wide(layout, dtype, wide_launches[layout, dtype])}

    # the d = 48 main paths' launches (phase 12): B4 in the CLI tile, B2 in
    # the poly-LS tiles
    wide_launches = {("L,rows,d", "float32"): wide["cli"]["b4_launches"],
                     **{("L,d,rows", dt): wide[f"refit_{dt}"]["b2_launches"]
                        for dt in ("float32", "bfloat16")}}
    # B1 at d = 48: timed at the V draw (r = 1682), held at both draws
    gram_wide = next(r for r in gram if r["d"] == WIDE_D and r["r"] == M
                     and r["dtype"] == "float32" and "ms" in r)
    lc_wide = {r["dtype"]: r for r in lc if r["d"] == WIDE_D and "ms" in r}
    b5_wide = {dt: dict(b5_global[f"d{WIDE_D}/full/{dt}"], L=8)
               for dt in ("float32", "bfloat16")}

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
        # the Gibbs exp-variance scan sweep's launches (phase 30), counted
        # from 0 just before it
        "scan_sweep_launches":
            scan["gibbs_exp_variance"]["chol_kernel"]["scan"]["gram_fed"],
        # phases 31-33, each counted from 0 just before it (the bayes
        # arm's from its own process)
        "results_phases_launches": {
            "get_samples": results["get_samples"]["gram_fed"],
            "get_criteria": results["get_criteria"]["gram_fed"],
            "experiment_bayes_arm": results["experiment"]["arm_counts"][
                "bayes_pmf"]["gram_fed"]},
        # phase 35: the world of one's tile and each rank's tile (the read
        # run), each counted from 0 just before it
        "sharding_phases_launches": {
            "world_of_one": shard["world_of_one"]["gram_fed"],
            **{f"{k}_per_rank": [int(r["gram_fed"]) for r in
                                 shard[k]["per_rank"]]
               for k in ("gloo_shared_card", "nccl_two_cards")
               if k in shard}},
        "max_abs_err": max(r["max_abs_err"] for r in gram),
        **{k: gram_row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "gram_to_x_ms", "gram_to_x_assembled_ms")},
        "library_ms": None,
        # the products it reads, from the rated-cell index in place of the
        # dense product, at its own shape (the bench tile's V draw)
        "index_gram_ms": gram_index_row["ms"],
        "dense_gram_ms": gram_index_row["library_ms"],
        "d48": wide_row(
            dict(gram_wide, max_abs_err=max(
                r["max_abs_err"] for r in gram + kern if r["d"] == WIDE_D)),
            wide["gibbs"]["b1_launches"], "chol_solve_sample"),
        "s_given_entry": {
            "max_abs_err": max(r["max_abs_err"] for r in kern),
            "ms": main_row["ms"], "launch_only_ms": main_row["launch_only_ms"],
            "plain_ms": main_row["plain_ms"], "bound_ms": chol_bound[0],
            "bound_by": chol_bound[1]},
    },
    {
        # no Pallas kernel: the JAX package leaves the Gibbs draws' masked
        # Gram to XLA as a dense product of the mask, which it replaces on
        # the card below the crossover density; launches over phase 4's
        # loop and times at the bench tile's V draw, both at d = 10
        "name": "masked_gram (rated-cell index)", "route": "cuda",
        "source": "amf_tpu_torch/csrc/masked_gram.cu", "replaces": None,
        "launches": index_launches,
        "max_rel_err": max(r["rel_vs_plain"] for r in gram_index),
        **{k: gram_index_row[k] for k in ("L", "r", "d", "ms", "device_ms",
                                          "plain_ms", "bound_ms",
                                          "library_ms")},
        "bound_by": "bytes"},
    {
        # no Pallas kernel: the JAX package draws a round's noise from each
        # lane's key inside its jitted round, and the port's per-lane calls
        # (normal_, _standard_gamma) are its plain version; launches over
        # phase 4's loop (one a Gibbs round), times at the DrugBank
        # lookahead cell's round (512 lanes, f32), every round of phase 38
        # equal bit for bit
        "name": "lane_noise (every lane's Gibbs round noise)",
        "route": "cuda", "source": "amf_tpu_torch/csrc/lane_noise.cu",
        "replaces": None, "launches": sum(noise_launches.values()),
        "max_abs_err": max(r["max_abs_err"] for r in noise),
        **{k: noise_row[k] for k in ("L", "size", "k", "ms", "device_ms",
                                     "host_ms", "plain_ms", "plain_host_ms",
                                     "bound_ms", "bound_by")},
        "rounds": {f"{r['cell']} {r['dtype']}": {
            k: r[k] for k in ("L", "ms", "plain_ms", "bound_ms")}
            for r in noise}},
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
           "library_ms": None,
           "d48": wide_row(lc_wide[dtype],
                           wide[f"refit_{dtype}"]["b3_launches"],
                           "pmf_line_coeffs")}
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
           "library_ms": None,
           "d48": wide_row(b5_wide[dtype],
                           wide[f"refit_{dtype}"]["b5_launches"],
                           "pmf_lookahead_fused")}
          for dtype in ("float32", "bfloat16")),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
