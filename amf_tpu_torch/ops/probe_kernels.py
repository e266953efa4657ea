"""Probe of the port's CUDA kernels on the card: what the compiler made of
them, how close the Cholesky kernel's launch can come to its bytes, and
whether a longer queue of lanes hides the fused refit's slowest lane.

    python -m amf_tpu_torch.ops.probe_kernels [--out results.json]

1. ``ptxas -v`` of every source of ``csrc/`` as the package builds it:
   registers a thread, spills and static shared memory of every
   instantiation.
2. ``csrc/chol_solve_sample.cu`` at d = 10 only, built once per (threads a
   block, minimum blocks an SM, z and x staged through shared memory or
   not) setting with its copy-only twins
   (``AMF_CHOL_PROBE``), all builds in parallel. For each setting, at the
   Gibbs tile's larger batch (160 lanes x 1682 rows = 269,120 matrices,
   float32): registers, the resident blocks and warps an SM that follow, the
   waves of the grid, and the CUDA-event time of four launches on the same
   buffers: the batch-minor entry, its copy-only twin (the same loads and
   stores, no factorisation), the Gram-fed entry, and its copy-only twin;
   the last two also at 1696 rows a lane, where every stream of a lane is
   128-byte aligned.
3. The fused refit (``pmf_lookahead_fused_cuda``) at the MovieLens-100k
   shape of ``chip_smoke.py`` and the ``add_rmse_boosts`` CLI's values
   (1,024 candidate cells at their true ratings, 200 steps, float32): one
   launch of 1,024 lanes beside 8 launches of 128, in turns, with each
   queue's evaluations. A launch ends with its slowest lane; with more
   lanes than SMs a finished lane's SM takes the next lane. A figure only:
   the tile width is the caller's.

Prints one JSON line per result; needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from amf_tpu_torch.ops import cuda_build

SOURCES = ("pmf_value_grad", "chol_solve_sample", "pmf_line_coeffs",
           "pmf_lookahead_fused")
L, R, D = 160, 1682, 10
P = D * (D + 1) // 2
R_ALIGNED = 1696  # the next multiple of 32 rows: every stream 128-byte aligned
# (threads a block, minimum blocks an SM, z and x staged through shared memory)
SETTINGS = [(128, 1, False), (128, 1, True), (256, 1, False),
            (256, 1, True), (64, 1, False), (128, 6, False)]
SMS, REGS_SM, WARPS_SM, SMEM_SM = 132, 65536, 64, 233472
REPS = 50


def ptxas(source: str, defines=(), out=None):
    """Compile ``csrc/<source>.cu`` with ``-Xptxas -v`` -> per kernel
    (mangled name, registers, spill stores, spill loads, static smem)."""
    out = out or (cuda_build.BUILD_DIR / "probe" / f"{source}.so")
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
           *(f"-D{d}" for d in defines), "-o", str(out),
           str(cuda_build.CSRC_DIR / f"{source}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {source}.cu:\n{proc.stderr}")
    rows, name = [], None
    spill = (0, 0)
    for line in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append(dict(kernel=name, registers=int(m.group(1)),
                             spill_stores=spill[0], spill_loads=spill[1],
                             smem=int(smem.group(1)) if smem else 0))
            name = None
    return rows


def summary(source: str):
    from amf_tpu_torch.ops import pmf_kernels as pk

    # the fused line search is built for one factor width a library
    fused = source == "pmf_lookahead_fused"
    rows = ptxas(source, pk.fused_defines(D) if fused else ())
    spilled = [r for r in rows if r["spill_stores"] or r["spill_loads"]]
    return dict(source=source, kernels=len(rows),
                registers_min=min(r["registers"] for r in rows),
                registers_max=max(r["registers"] for r in rows),
                spilled=[(r["kernel"][-40:], r["registers"],
                          r["spill_stores"]) for r in spilled][:12],
                d10_f32=[r for r in rows
                         if re.search(r"(kernelIfLi10ELb0E|Li16ELi512|"
                                      r"line_coeffsIfLi16E|fusedIf)",
                                      r["kernel"])][:8])


def cuda_ms(fn, reps=REPS):
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


def build_setting(setting):
    """One (threads, minimum blocks) build at d = 10 with the copy twins."""
    threads, min_blocks, staged = setting
    out = (cuda_build.BUILD_DIR / "probe"
           / f"chol_{threads}_{min_blocks}_{int(staged)}.so")
    defines = [f"AMF_CHOL_THREADS={threads}",
               f"AMF_CHOL_MIN_BLOCKS={min_blocks}", f"AMF_CHOL_ONLY_D={D}",
               "AMF_CHOL_PROBE"] + ["AMF_CHOL_STAGED_ZX"] * staged
    return out, ptxas("chol_solve_sample", defines, out)


def chol_setting(setting, out, rows, bufs, aligned):
    """Time the four launches of one built setting."""
    lib = ctypes.CDLL(str(out))
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.amf_chol_solve_sample_f32.argtypes = [p] * 4 + [ll, i, p]
    lib.amf_chol_gram_solve_sample_f32.argtypes = (
        [p] * 12 + [ctypes.c_double] + [ll] * 5 + [i, p])
    lib.amf_chol_copy_probe_f32.argtypes = [i] + [p] * 6 + [ll, ll, p]
    stream = torch.cuda.current_stream().cuda_stream
    threads, min_blocks, staged = setting
    s_t, rhs_t, z_t, out_t, Gt, mrt, z, alpha, mu, x = (
        t.data_ptr() for t in bufs)
    Gt_a, mrt_a, z_a, x_a = (t.data_ptr() for t in aligned)

    def call(fn, *args):
        err = fn(*args)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    times = dict(
        batch_minor_ms=cuda_ms(lambda: call(
            lib.amf_chol_solve_sample_f32, s_t, rhs_t, z_t, out_t, L * R, D,
            stream)),
        batch_minor_copy_ms=cuda_ms(lambda: call(
            lib.amf_chol_copy_probe_f32, 0, s_t, rhs_t, z_t, alpha, mu, out_t,
            L, R, stream)),
        gram_ms=cuda_ms(lambda: call(
            lib.amf_chol_gram_solve_sample_f32, Gt, mrt, z, alpha, mu, 0, 0,
            0, 0, 0, 0, x, 2.0, L, R, 1, R * D, 0, D, stream)),
        gram_copy_ms=cuda_ms(lambda: call(
            lib.amf_chol_copy_probe_f32, 1, Gt, mrt, z, alpha, mu, x, L, R,
            stream)),
        gram_aligned_rows_ms=cuda_ms(lambda: call(
            lib.amf_chol_gram_solve_sample_f32, Gt_a, mrt_a, z_a, alpha, mu,
            0, 0, 0, 0, 0, 0, x_a, 2.0, L, R_ALIGNED, 1, R_ALIGNED * D, 0, D,
            stream)),
        gram_copy_aligned_rows_ms=cuda_ms(lambda: call(
            lib.amf_chol_copy_probe_f32, 1, Gt_a, mrt_a, z_a, alpha, mu, x_a,
            L, R_ALIGNED, stream)))
    res = dict(threads=threads, min_blocks=min_blocks, staged_zx=staged,
               **times)
    for r in rows:
        m = re.search(r"kernelI([fd])Li\d+ELb([01])E", r["kernel"])
        if not m or m.group(1) != "f":  # the float32 instantiations only
            continue
        kind = ("gram" if "gram" in r["kernel"] else "batch_minor") + (
            "_copy" if m.group(2) == "1" else "")
        by_regs = REGS_SM // (r["registers"] * threads)
        by_smem = SMEM_SM // (r["smem"] + 1024) if r["smem"] else 99
        blocks_sm = min(by_regs, by_smem, WARPS_SM * 32 // threads, 32)
        grid = (L * -(-R // threads) if "gram" in kind
                else -(-L * R // threads))
        res[kind] = dict(
            registers=r["registers"], spill_stores=r["spill_stores"],
            smem=r["smem"], blocks_sm=blocks_sm,
            warps_sm=blocks_sm * threads // 32, grid=grid,
            waves=grid / (SMS * blocks_sm))
    return res


def fused_workload(dev, lanes=1024, steps=200):
    """The fused refit at the shape of ``chip_smoke.py`` and the CLI's
    values -> run(lanes' slice) giving the launcher's outputs."""
    import numpy as np

    from amf_tpu_torch import types
    from amf_tpu_torch.data.synthetic import make_fake_data
    from amf_tpu_torch.models import pmf
    from amf_tpu_torch.ops import pmf_kernels as pk
    from amf_tpu_torch.utils.rng import generator

    n, m = 943, R
    real, known, _ = make_fake_data(
        num_users=n, num_items=m, rank=D, noise=0.5,
        mask_type=0.05 * 100000 / (n * m), rng=np.random.default_rng(0))
    real = np.clip(np.round(real - real.mean() + 3.0), 1.0, 5.0)
    prob = types.problem_from_dense(real, known, dtype=torch.float32,
                                    device=dev)
    cfg = pmf.PMFConfig(latent_d=D, max_fit_steps=200)
    st = pmf.init_state(generator(7, dev), n, m, cfg, prob,
                        dtype=torch.float32, device=dev)
    st, _ = pmf.fit(st, prob, cfg)
    cand = torch.nonzero(prob.queryable.flatten())[:lanes, 0]
    di, dj = cand // m, cand % m
    dv = torch.as_tensor(real, dtype=torch.float32, device=dev)[di, dj]
    sig = torch.stack([st.sigma_sq, st.sigma_u_sq, st.sigma_v_sq])
    ls = torch.tensor([cfg.learning_rate, cfg.stop_thresh,
                       cfg.min_learning_rate], device=dev)
    index = pk.rated_index(prob.rated, prob.R_obs)
    base = (st.U.mT.contiguous(), st.V.mT.contiguous(), prob.R_obs,
            prob.rated)

    def run(s):
        return pk.pmf_lookahead_fused_cuda(*base, di[s], dj[s], dv[s], sig,
                                           ls, steps, False, index=index)

    return run


def fused_queue(run, lanes=1024, tile=128):
    """One fused-refit launch of ``lanes`` lanes beside ``lanes / tile``
    launches of ``tile``: ms of each, in turns."""
    tiles = [slice(c, c + tile) for c in range(0, lanes, tile)]

    def one():
        return run(slice(0, lanes))[3]

    def many():
        return torch.cat([run(s)[3] for s in tiles])

    same = torch.equal(one(), many())
    t = [cuda_ms(f, 3) for f in (one, many, many, one)]
    evals = one().view(len(tiles), tile)
    return dict(lanes=lanes, tile=tile, one_launch_ms=(t[0] + t[3]) / 2,
                tiled_launches_ms=(t[1] + t[2]) / 2, same_evaluations=same,
                evals_total=int(evals.sum()), evals_max=int(evals.max()),
                evals_max_by_tile=evals.max(dim=1).values.tolist())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the results here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_kernels: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    results = dict(card=card, ptxas=[], chol=[])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    # SPD matrices like the chain's, in both layouts
    W = rand(L, 48, D)
    full = torch.eye(D, device=dev) + 2.0 * (W.mT @ W)  # (L, D, D)
    a, b = torch.tril_indices(D, D, device=dev)
    packed = torch.cat([full[:, a, b], rand(L, D)], dim=1)[:, :, None]

    def gram(rows):
        return packed.expand(L, P + D, rows) + 0.01 * rand(1, 1, rows)

    Gt = gram(R)
    aligned = (gram(R_ALIGNED), rand(L, D, R_ALIGNED), rand(L, R_ALIGNED, D),
               torch.empty(L, R_ALIGNED, D, device=dev))
    alpha = torch.eye(D, device=dev).expand(L, D, D).contiguous()
    bufs = (full.reshape(L, 1, D * D).expand(L, R, D * D).reshape(
        L * R, D * D).t().contiguous(), rand(D, L * R), rand(D, L * R),
        torch.empty(D, L * R, device=dev), Gt, rand(L, D, R), rand(L, R, D),
        alpha, rand(L, D), torch.empty(L, R, D, device=dev))
    with ThreadPoolExecutor(6) as pool:
        futs = [pool.submit(summary, s) for s in SOURCES]
        # build every setting first (in parallel), then time one at a time
        builds = list(pool.map(build_setting, SETTINGS))
        for setting, (out, rows) in zip(SETTINGS, builds):
            row = chol_setting(setting, out, rows, bufs, aligned)
            results["chol"].append(row)
            print("chol-setting " + json.dumps(row), flush=True)
        for f in futs:
            row = f.result()
            results["ptxas"].append(row)
            print("ptxas " + json.dumps(row), flush=True)
    results["fused_queue"] = fused_queue(fused_workload(dev))
    print("fused_queue " + json.dumps(results["fused_queue"]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
