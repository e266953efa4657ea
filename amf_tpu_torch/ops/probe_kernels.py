"""Probe of the port's CUDA kernels on the card: what the compiler made of
them, and how close their launches come to their bounds.

    python -m amf_tpu_torch.ops.probe_kernels [--out results.json]

1. ``ptxas -v`` of every source of ``csrc/`` as the package builds it for
   d = 10 and for d = 48 (a library of that one width): registers a
   thread, spills and static shared memory of every instantiation.
2. The three PMF kernels at d = 48 (``--wide-only`` runs this section
   alone), at the shapes the d = 48 main paths of ``chip_smoke.py`` give
   them on 943 x 1682 (value+gradient (L, rows, d) at the CLI tile's 128
   lanes; (L, d, rows), the line coefficients and the fused line search,
   8 steps, at the refit tile's 8 lanes; both dtypes) and on a 97 x 131
   problem whose lanes fit shared memory: ``ptxas -v`` of each library,
   the wrapper's CUDA-event time, the launch's device time by the
   profiler, and a hash of the outputs, so that two builds of a source can
   be held bit for bit against each other.
3. ``csrc/masked_gram.cu``, the Gibbs row draws' masked Gram from the
   rated-cell index (``--gram`` runs this section alone): ``ptxas -v`` of
   its d = 20 instantiations and its library's nvcc seconds; at the two
   configurations' tile shapes (160 lanes on 943 x 1682 with 5,000 rated
   cells, 512 lanes on 70 x 306 with 400; d = 20), each side, float32 and
   float64: the kernel's CUDA-event and profiled device time beside its
   byte bound, its plain version, and the dense form it replaces
   (``gram_kernel.dense_gram``, the ``library_ms`` yardstick), with the
   relative gaps; then the crossover: both sides' kernel and dense times
   at 160 lanes, 943 x 1682, d = 20, over densities from 0.3 % to 100 %,
   in float32 and in float64.
4. ``csrc/chol_solve_sample.cu``'s Gram-fed entry, B1 (``--chol`` runs
   this section alone): at d = 10, 16, 17, 20, 32 and 48 the library the
   package builds (one a width), its nvcc seconds and ``ptxas -v``
   (registers, spills, stack frame); in float32 at the lookahead tile's two
   draws (160 lanes x 943 and x 1682 rows), 10 lanes and the active loop's
   one-lane draws, in float64 at the V draw of 160 lanes and of one: the
   wrapper's CUDA-event time, the launch's device time by the profiler, the
   largest gap to the plain version (scaled by 1 + |x|), the plain
   version's time and the bound (bytes or operations, each input and
   output counted once).
5. ``csrc/lane_noise.cu``, every lane's noise of a Gibbs round in one
   launch (``--noise`` runs this section alone): ``ptxas -v`` and nvcc
   seconds; at the two lookahead cells' rounds (160 lanes of 105,840
   normals, 512 lanes of 15,880, each with 40 Gamma variates; d = 20,
   float32 and float64): whether two rounds of the kernel's values equal
   the per-lane calls' and leave the generators at the same offsets, its
   profiled device time beside its byte bound (the normals and Gamma
   variates written once, the seeds read), its CUDA-event and host time a
   round, the same with the Gamma variates in a second launch, and the
   per-lane calls' host time a round (``lane_noise_plain``); then one
   DrugBank-shaped lookahead tile (512 lanes, 30 rounds) under tracing:
   its ``gibbs.noise`` spans, how many were ``batched``, and N1's
   launches.

Prints one JSON line per result; needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from amf_tpu_torch.ops import cuda_build

SOURCES = ("pmf_value_grad", "chol_solve_sample", "pmf_line_coeffs",
           "pmf_lookahead_fused")
R, D = 1682, 10
WIDE_D = 48  # a width above the shared libraries' 32
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
    spill, stack = (0, 0), 0
    for line in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            stack = int(m.group(1))
            spill = (int(m.group(2)), int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append(dict(kernel=name, registers=int(m.group(1)),
                             spill_stores=spill[0], spill_loads=spill[1],
                             stack=stack,
                             smem=int(smem.group(1)) if smem else 0))
            name = None
    return rows


def summary(source: str, d: int = D):
    """``ptxas -v`` of the library of ``source`` that takes width d."""
    defines = cuda_build.width_defines(source, d)
    rows = ptxas(source, defines,
                 cuda_build.BUILD_DIR / "probe" / f"{source}-d{d}.so")
    spilled = [r for r in rows if r["spill_stores"] or r["spill_loads"]]
    return dict(source=source, d=d, defines=defines, kernels=len(rows),
                registers_min=min(r["registers"] for r in rows),
                registers_max=max(r["registers"] for r in rows),
                spilled=[(r["kernel"][-40:], r["registers"],
                          r["spill_stores"]) for r in spilled][:12],
                d10_f32=[r for r in rows
                         if re.search(r"(kernelIfLi10EE|Li16ELi512|"
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


def device_ms(fn, name_part: str, reps: int = 10) -> float:
    """Mean device time in ms of the kernels whose name holds ``name_part``
    over ``reps`` calls of ``fn``, by the profiler: the launch alone."""
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
    seen = sum(e.count for e in hits)
    if not seen:
        raise RuntimeError(f"the profiler saw no {name_part} launch")
    return sum(e.self_device_time_total for e in hits) / 1e3 / seen


def outputs_hash(out) -> str:
    """sha256 of a launch's outputs' bytes (tensors in order)."""
    h = hashlib.sha256()
    for t in out:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def wide_kernels(dev):
    """Section 2: the PMF kernels at d = 48, one row a (kernel, shape,
    dtype)."""
    from amf_tpu_torch.models import pmf
    from amf_tpu_torch.ops import pmf_kernels as pk

    d = WIDE_D
    # the wrappers by the part of their kernels' names the profiler shows
    wrappers = {"value_grad": pk.pmf_value_grad_cuda,
                "line_coeffs": pk.pmf_line_coeffs_cuda,
                "fused": pk.pmf_lookahead_fused_cuda}
    gen = torch.Generator(device=dev).manual_seed(48)
    cfg = pmf.PMFConfig(latent_d=d)
    sig = torch.tensor([0.9, 10.0, 10.0], device=dev)
    ls = torch.tensor([cfg.learning_rate, cfg.stop_thresh,
                       cfg.min_learning_rate], device=dev)
    rows = []
    for shape, (n, m, density) in (("full", (943, R, 4980 / (943 * R))),
                                   ("small", (97, 131, 0.1))):
        rated = torch.rand(n, m, generator=gen, device=dev) < density
        Rm = torch.randint(1, 6, (n, m), generator=gen,
                           device=dev).float() * rated
        free = torch.nonzero(~rated)
        for bf16 in (False, True):
            io = torch.bfloat16 if bf16 else torch.float32
            index = pk.rated_index(rated, Rm, bf16=bf16)

            def fac(*size):
                return (0.2 * torch.rand(*size, generator=gen,
                                         device=dev)).to(io)

            def cells(L):
                pick = free[torch.randperm(len(free), generator=gen,
                                           device=dev)[:L]]
                dv = torch.randint(1, 6, (L,), generator=gen,
                                   device=dev).float()
                return pick[:, 0].contiguous(), pick[:, 1].contiguous(), dv

            cases = []
            for transposed, L in ((False, 128), (True, 8)):
                if bf16 and not transposed:
                    continue  # the CLI tile streams float32
                di, dj, dv = cells(L)
                U, V = ((fac(L, d, k) if transposed else fac(L, k, d))
                        for k in (n, m))
                args = (U, V, Rm.to(io), rated, di, dj, dv, sig)
                kw = dict(transposed=transposed, round_resid=bf16,
                          out_dtype=io if transposed else torch.float32,
                          index=index)
                cases.append((
                    "pmf_value_grad " + ("(L,d,rows)" if transposed
                                         else "(L,rows,d)"), L, "value_grad",
                    lambda a=args, k=kw: pk.pmf_value_grad_cuda(*a, **k)))
            di, dj, dv = cells(8)
            lc = (*(fac(8, d, k) for k in (n, m, n, m)), Rm.to(io), rated,
                  di, dj, dv)
            cases.append(("pmf_line_coeffs", 8, "line_coeffs",
                          lambda a=lc: (pk.pmf_line_coeffs_cuda(
                              *a, index=index),)))
            fu = (fac(d, n).float(), fac(d, m).float(), Rm, rated, di, dj,
                  dv, sig, ls, 8, bf16)
            cases.append(("pmf_lookahead_fused (8 steps)", 8, "fused",
                          lambda a=fu: pk.pmf_lookahead_fused_cuda(
                              *a, index=index)))
            for name, L, part, fn in cases:
                before = dict(wrappers[part].variants)
                out = fn()
                variant = next(k for k, v in wrappers[part].variants.items()
                               if v != before.get(k, 0))
                row = dict(kernel=name, shape=shape, n=n, m=m, d=d, L=L,
                           dtype=str(io).split(".")[1], variant=variant,
                           outputs=outputs_hash(out), ms=cuda_ms(fn, 10),
                           device_ms=device_ms(fn, part))
                rows.append(row)
                print("wide " + json.dumps(row), flush=True)
    return rows


# (lanes, n, m, rated cells) of the two configurations' lookahead tiles
GRAM_CELLS = {"ml100k": (160, 943, 1682, 5000),
              "db70x306": (512, 70, 306, 400)}
GRAM_D = 20
GRAM_DENSITIES = (0.00315, 0.01, 0.03, 0.1, 0.2, 0.3, 0.5, 0.75, 1.0)


def uniform_mask(dev, n, m, nnz, seed=0):
    """-> (rated (n, m) bool, R (n, m)): ``nnz`` rated cells drawn
    uniformly, ratings 1..5."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    flat = torch.randperm(n * m, generator=gen, device=dev)[:nnz]
    rated = torch.zeros(n * m, dtype=torch.bool, device=dev)
    rated[flat] = True
    R = torch.randint(1, 6, (n, m), generator=gen, device=dev)
    return rated.reshape(n, m), R


def _gram_inputs(dev, L, rated, R, d, dtype, seed=0):
    """Both sides of the mask ``rated`` with ratings R as the chain reads
    them, dense and indexed, with L lanes of factors of width d."""
    from amf_tpu_torch.ops import gram_kernel, pmf_kernels

    gen = torch.Generator(device=dev).manual_seed(seed)
    n, m = rated.shape
    R = R.to(dtype)
    by_row, by_col = gram_kernel.index_sides(
        pmf_kernels.rated_index(rated, R, dtype=dtype))
    mask = rated.to(dtype)
    masked_r = torch.where(rated, R, 0.0)
    U = torch.randn(L, n, d, generator=gen, dtype=dtype, device=dev)
    V = torch.randn(L, m, d, generator=gen, dtype=dtype, device=dev)
    return {"U": (mask, masked_r, V, by_row),
            "V": (mask.t().contiguous(), masked_r.t().contiguous(), U,
                  by_col)}


def _gram_bound_ms(L, r, c, nnz, d, size):
    """Bytes over 3.35 TB/s: Gt and mrt written once, the index, the
    ratings and every lane's ``other`` read once."""
    p = d * (d + 1) // 2
    n_bytes = (L * (p + 2 * d) * r + nnz + L * c * d) * size + (
        r + 1 + nnz) * 4
    return n_bytes / 3.35e12 * 1e3


def _device_ms_or_none(fn, name_part):
    """``device_ms``, or None where the profiler saw no launch (it now and
    then records nothing of a window)."""
    try:
        return device_ms(fn, name_part)
    except RuntimeError:
        return None


def gram_cell_rows(dev, cells=None, d=GRAM_D,
                   dtypes=(torch.float32, torch.float64)):
    """The masked-Gram kernel at width d on ``cells`` (name -> (lanes,
    rated (n, m) bool, ratings (n, m))), by default the two configurations'
    tile shapes on uniform masks; each side: its times beside its bound,
    its plain version and the dense product it replaces, and its relative
    gaps to both (also ``chip_smoke.py``'s phase 2 and kernel row)."""
    from amf_tpu_torch.ops import gram_kernel

    def rel(a, b):
        return max(float((x - y).norm() / y.norm()) for x, y in zip(a, b))

    if cells is None:
        cells = {name: (L, *uniform_mask(dev, n, m, nnz))
                 for name, (L, n, m, nnz) in GRAM_CELLS.items()}
    rows = []
    for cell, (L, rated, R) in cells.items():
        nnz = int(rated.sum())
        for dtype in dtypes:
            sides = _gram_inputs(dev, L, rated, R, d, dtype)
            for side, (mask, masked_r, other, idx) in sides.items():
                r, c = mask.shape
                launches = gram_kernel.masked_gram_cuda.launches
                got = gram_kernel.masked_gram(idx, other)
                plain = gram_kernel.masked_gram(idx, other, kernel=False)
                dense = gram_kernel.dense_gram(mask, masked_r, other)
                row = dict(
                    section="gram", cell=cell, side=side,
                    dtype=str(dtype)[6:], L=L, r=r, c=c, d=d, nnz=nnz,
                    rel_vs_plain=rel(got, plain), rel_vs_dense=rel(got, dense),
                    launches=gram_kernel.masked_gram_cuda.launches - launches,
                    ms=cuda_ms(lambda: gram_kernel.masked_gram(idx, other)),
                    device_ms=_device_ms_or_none(
                        lambda: gram_kernel.masked_gram(idx, other),
                        "masked_gram_rows_kernel"),
                    bound_ms=_gram_bound_ms(L, r, c, nnz, d,
                                            other.element_size()),
                    plain_ms=cuda_ms(lambda: gram_kernel.masked_gram(
                        idx, other, kernel=False), 5),
                    library_ms=cuda_ms(lambda: gram_kernel.dense_gram(
                        mask, masked_r, other), 10))
                rows.append(row)
                print("gram " + json.dumps(row), flush=True)
                del got, plain, dense
            del sides
            torch.cuda.empty_cache()
    return rows


def gram_section(dev):
    """Section 3 of the module docstring -> its rows."""
    from amf_tpu_torch.ops import gram_kernel

    rows = []
    defines = cuda_build.width_defines("masked_gram", GRAM_D)
    t0 = time.perf_counter()
    cuda_build.build("masked_gram", defines)
    build_s = time.perf_counter() - t0
    ptx = ptxas("masked_gram", defines,
                cuda_build.BUILD_DIR / "probe" / f"masked_gram-d{GRAM_D}.so")
    rows.append(dict(section="gram_ptxas", build_s=build_s, kernels=[
        (r["kernel"][-48:], r["registers"], r["spill_stores"],
         r["spill_loads"]) for r in ptx]))
    print("gram " + json.dumps(rows[-1]), flush=True)
    rows += gram_cell_rows(dev)

    # the crossover density, in both dtypes
    L, n, m, _ = GRAM_CELLS["ml100k"]
    for dtype in (torch.float32, torch.float64):
        for density in GRAM_DENSITIES:
            nnz = int(round(density * n * m))
            sides = _gram_inputs(dev, L, *uniform_mask(dev, n, m, nnz),
                                 GRAM_D, dtype)
            row = dict(section="gram_crossover", dtype=str(dtype)[6:],
                       density=density, nnz=nnz)
            for side, (mask, masked_r, other, idx) in sides.items():
                row[f"{side}_index_ms"] = cuda_ms(
                    lambda: gram_kernel.masked_gram(idx, other), 10)
                row[f"{side}_dense_ms"] = cuda_ms(
                    lambda: gram_kernel.dense_gram(mask, masked_r, other),
                    10)
            row["index_ms"] = row["U_index_ms"] + row["V_index_ms"]
            row["dense_ms"] = row["U_dense_ms"] + row["V_dense_ms"]
            rows.append(row)
            print("gram " + json.dumps(row), flush=True)
            del sides
            torch.cuda.empty_cache()
    return rows


# B1 at the widths around d = 16, where a thread's loops stop unrolling,
# the benchmark's 20 and the widest tested, 48: in float32 at the lookahead
# tile's draws (160 lanes), at 10 lanes (the d = 48 smoke tile) and at the
# active loop's one lane, (L, r, c); in float64 at the larger draw and the
# one-lane V draw
CHOL_WIDTHS = (10, 16, 17, 20, 32, WIDE_D)
CHOL_SHAPES = {torch.float32: ((160, 943, 1682), (160, 1682, 943),
                               (10, 1682, 943), (1, 943, 1682),
                               (1, 1682, 943)),
               torch.float64: ((160, 1682, 943), (1, 1682, 943))}


def _chol_inputs(dev, L, r, c, d, dtype, seed=0):
    """A row draw of L lanes at the cells' density (5,000 rated of
    943 x 1682), with centre and cells: the wrapper's arguments."""
    from amf_tpu_torch.ops import gram_kernel

    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, dtype=dtype, device=dev)

    mask = (torch.rand(r, c, generator=gen, device=dev)
            < 5000 / (943 * 1682)).to(dtype)
    masked_r = mask * torch.randint(1, 6, (r, c), generator=gen,
                                    device=dev).to(dtype)
    other = 0.5 * rand(L, c, d)
    A = rand(L, d, d)
    alpha = A @ A.mT / d + 0.5 * torch.eye(d, dtype=dtype, device=dev)
    Gt, mrt = gram_kernel.dense_gram(mask, masked_r, other)
    cells = (torch.randint(0, r, (L,), generator=gen, device=dev),
             torch.randint(0, c, (L,), generator=gen, device=dev),
             torch.ones(L, dtype=dtype, device=dev), rand(L))
    return (Gt, mrt, rand(L, r, d), alpha, rand(L, d), 2.0,
            3 + 0.1 * rand(L), cells, other)


def _chol_bound_ms(L, r, d, dtype):
    """The larger of B1's bytes (p + 4 d values a row) over 3.35 TB/s and
    its operations over 67 (f32) or 34 (f64) TFLOP/s."""
    p = d * (d + 1) // 2
    size = torch.finfo(dtype).bits // 8
    by_bytes = (p + 4 * d) * size * L * r / 3.35e12
    by_ops = (d ** 3 / 3 + 2 * d * d + 2 * p + 4 * d) * L * r / (
        67e12 if size == 4 else 34e12)
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops \
        else "operations"


def chol_section(dev):
    """Section 4: B1 as the package builds it, one row a (width, shape,
    dtype)."""
    from amf_tpu_torch.ops import chol_kernel as ck

    def build(d):
        defines = cuda_build.width_defines("chol_solve_sample", d)
        start = time.perf_counter()
        rows = ptxas("chol_solve_sample", defines,
                     cuda_build.library_path("chol_solve_sample", defines))
        return time.perf_counter() - start, [
            r for r in rows if "chol_gram_kernel" in r["kernel"]]

    with ThreadPoolExecutor(6) as pool:
        built = list(pool.map(build, CHOL_WIDTHS))
    out = []
    for d, (secs, rows) in zip(CHOL_WIDTHS, built):
        row = dict(section="chol-build", d=d, nvcc_s=round(secs, 1),
                   kernels=[dict(kernel=r["kernel"][-48:], **{
                       k: r[k] for k in ("registers", "spill_stores",
                                         "stack", "smem")}) for r in rows])
        out.append(row)
        print("chol " + json.dumps(row), flush=True)
    for d in CHOL_WIDTHS:
        for dtype, shapes in CHOL_SHAPES.items():
            for L, r, c in shapes:
                args = _chol_inputs(dev, L, r, c, d, dtype)
                want = ck.chol_gram_solve_sample(*args, kernel=False)
                bound, by = _chol_bound_ms(L, r, d, dtype)
                out.append(_chol_row(ck, args, want, dict(
                    section="chol", d=d, dtype=str(dtype)[6:], L=L, r=r,
                    bound_ms=bound, bound_by=by,
                    plain_ms=cuda_ms(lambda: ck.chol_gram_solve_sample(
                        *args, kernel=False), 3))))
                del args, want
                torch.cuda.empty_cache()
    return out


def _chol_row(ck, args, want, row):
    def call():
        return ck.chol_gram_solve_sample(*args)

    got = call()
    gap = ((got - want).abs() / (1 + want.abs())).max().item()
    d = want.shape[-1]
    row.update(group=ck.gram_group(d), max_scaled_gap=gap,
               ms=cuda_ms(call, 20),
               device_ms=_device_ms_or_none(call, "chol_gram_kernel"))
    row["bound_pct"] = (100 * row["bound_ms"] / row["device_ms"]
                        if row["device_ms"] else None)
    print("chol " + json.dumps(row), flush=True)
    return row


# the lookahead cells' rounds: (lanes, n, m) at d = 20, two sweeps a round
NOISE_CELLS = {"ml100k-bpmf-d20": (160, 943, 1682),
               "db70x306-bpmf-d20": (512, 70, 306)}
NOISE_D = 20
NOISE_SEED = 1234567891011  # lane seeds are 64-bit mixes of it


def _host_ms(fn, reps):
    """Host milliseconds a call of ``fn``, each call ending on a
    ``synchronize``, after one warm call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def noise_cell_rows(dev, dtypes=(torch.float32, torch.float64), rounds=2):
    """N1 at the two lookahead cells' rounds (d = 20), each dtype:
    ``rounds`` draws through ``LaneStreams`` held with ``torch.equal`` to
    the per-lane calls on fresh copies of the same generators, with the
    generators' offsets after both and the kernel's launches; its
    CUDA-event, profiled device and host times a round beside its byte
    bound (the normals and Gamma variates written once, the seeds read),
    the same with the Gamma variates in a second launch, and the per-lane
    calls' times (also ``chip_smoke.py``'s phase 38 and N1 row)."""
    from amf_tpu_torch.models import bpmf_gibbs
    from amf_tpu_torch.ops import lane_noise
    from amf_tpu_torch.utils.rng import LaneStreams, lane_generators

    d, rows = NOISE_D, []
    for cell, (L, n, m) in NOISE_CELLS.items():
        size = 2 * d * d + 2 * d + 2 * (n + m) * d

        def gens():
            return lane_generators(NOISE_SEED, range(L // 2), 2, dev)

        for dtype in dtypes:
            like = torch.empty((), dtype=dtype, device=dev)
            shape = torch.cat([bpmf_gibbs._dof_shape(d, d + n, like),
                               bpmf_gibbs._dof_shape(d, d + m, like)])
            kernel_gens, plain_gens = gens(), gens()
            before = lane_noise.lane_noise_cuda.launches.copy()
            with LaneStreams(kernel_gens, dev) as streams:
                got = [streams.draw(size, dtype, shape)
                       for _ in range(rounds)]
            made = lane_noise.lane_noise_cuda.launches - before
            want = [lane_noise.lane_noise_plain(plain_gens, size, dtype, dev,
                                                shape) for _ in range(rounds)]
            pairs = [(a, b) for g, w in zip(got, want) for a, b in zip(g, w)]
            equal = all(torch.equal(a, b) for a, b in pairs)
            max_abs_err = max((a - b).abs().max().item() for a, b in pairs)
            offsets_equal = ([g.get_offset() for g in kernel_gens]
                             == [g.get_offset() for g in plain_gens])
            del got, want, pairs

            streams, timing_gens = LaneStreams(gens(), dev), gens()

            def one():
                return streams.draw(size, dtype, shape)

            def two():
                return (streams.draw(size, dtype),
                        streams.draw(0, dtype, shape))

            def plain():
                return lane_noise.lane_noise_plain(timing_gens, size, dtype,
                                                   dev, shape)

            n_bytes = (L * (size + 2 * d) + 2 * d) * like.element_size() \
                + L * 8
            bound_ms = n_bytes / 3.35e12 * 1e3
            dev_ms = _device_ms_or_none(one, "lane_noise_kernel")
            row = dict(
                section="noise", cell=cell, dtype=str(dtype).split(".")[1],
                L=L, size=size, k=2 * d, rounds=rounds, equal=equal,
                offsets_equal=offsets_equal, max_abs_err=max_abs_err,
                launches={"/".join(k): v for k, v in made.items()},
                bound_ms=bound_ms, bound_by="bytes", device_ms=dev_ms,
                bound_pct=100 * bound_ms / dev_ms if dev_ms else None,
                ms=cuda_ms(one, 20), host_ms=_host_ms(one, 20),
                two_launches_ms=cuda_ms(two, 20),
                two_launches_host_ms=_host_ms(two, 20),
                plain_host_ms=_host_ms(plain, 3), plain_ms=cuda_ms(plain, 3))
            streams.close()
            rows.append(row)
            print("noise " + json.dumps(row), flush=True)
    return rows


def noise_section(dev):
    """Section 5: N1's build, one Gibbs round's lane noise at the
    lookahead cells' shapes in float32 and float64, one row a (cell,
    dtype), and a traced lookahead tile."""
    t0 = time.perf_counter()
    cuda_build.build("lane_noise")
    build_s = time.perf_counter() - t0
    ptx = ptxas("lane_noise")
    rows = [dict(section="noise_ptxas", build_s=round(build_s, 1), kernels=[
        (r["kernel"][-48:], r["registers"], r["spill_stores"],
         r["spill_loads"]) for r in ptx])]
    print("noise " + json.dumps(rows[-1]), flush=True)
    rows += noise_cell_rows(dev)
    rows.append(noise_tile_row(dev))
    print("noise " + json.dumps(rows[-1]), flush=True)
    return rows


def noise_tile_row(dev, cand_n=256, d=NOISE_D, rounds=30):
    """One exp-variance lookahead tile at the DrugBank cell's shape
    (``cand_n`` candidates x 2 values on 70 x 306 +-1 labels, 400 known,
    width d, ``rounds`` rounds) under ``profiling.tracing()``: how many
    ``gibbs.noise`` spans it opened and how many said ``batched``, N1's
    launches, and the per-lane calls the same rounds take without it."""
    import numpy as np

    from amf_tpu_torch import types
    from amf_tpu_torch.models import bpmf_gibbs, pmf
    from amf_tpu_torch.ops import lane_noise
    from amf_tpu_torch.utils import profiling
    from amf_tpu_torch.utils.rng import generator

    n, m, vals = 70, 306, (-1.0, 1.0)
    rng = np.random.default_rng(0)
    real = np.where(rng.random((n, m)) < 0.1, 1.0, -1.0)
    prob = types.problem_from_dense(real, rng.random((n, m)) < 400 / (n * m),
                                    device=dev)
    pcfg = pmf.PMFConfig(latent_d=d, subtract_mean=True)
    gcfg = bpmf_gibbs.GibbsConfig(latent_d=d, subtract_mean=True)
    pst, _ = pmf.fit(pmf.init_state(generator(1, dev), n, m, pcfg, prob,
                                    device=dev), prob, pcfg)
    _, stats, _ = bpmf_gibbs.run_chain(
        bpmf_gibbs.init_chain(pst), prob, gcfg, 8, generator=generator(2, dev),
        value_bounds=tuple(types.rating_bounds(vals)))
    cand = torch.nonzero(prob.queryable.flatten())[:cand_n, 0]
    launches = lane_noise.lane_noise_cuda.launches.copy()
    profiling.spans(reset=True)
    with profiling.tracing():
        bpmf_gibbs.exp_variance_scores(3, pst, prob, pcfg, gcfg, stats, vals,
                                       num_samps=rounds, cand=cand,
                                       n_base_samples=8)
    batched = [s.attrs["batched"] for s in profiling.spans(reset=True)
               if s.name == "gibbs.noise"]
    made = lane_noise.lane_noise_cuda.launches - launches
    return dict(section="noise_tile", lanes=2 * len(cand), rounds=len(batched),
                batched_rounds=sum(batched),
                launches={"/".join(k): v for k, v in made.items()},
                per_lane_calls_without=2 * 2 * len(cand) * len(batched))


def ptxas_section(results):
    """Section 1 of the module docstring, into ``results``."""
    with ThreadPoolExecutor(6) as pool:
        for row in pool.map(lambda a: summary(*a),
                            [(s, d) for d in (D, WIDE_D) for s in SOURCES]):
            results["ptxas"].append(row)
            print("ptxas " + json.dumps(row), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the results here")
    ap.add_argument("--wide-only", action="store_true",
                    help="run section 2 (the PMF kernels at d = 48) alone, "
                         "with ptxas -v of their d = 48 libraries")
    ap.add_argument("--gram", action="store_true",
                    help="run section 3 (the masked Gram from the index) "
                         "alone")
    ap.add_argument("--chol", action="store_true",
                    help="run section 4 (B1 at d = 10 to 48) alone")
    ap.add_argument("--noise", action="store_true",
                    help="run section 5 (the lane noise of a Gibbs round) "
                         "alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_kernels: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    results = dict(card=card, ptxas=[])
    dev = torch.device("cuda")
    if args.noise:
        results["noise"] = noise_section(dev)
    elif args.chol:
        results["chol_b1"] = chol_section(dev)
    elif args.gram:
        results["gram"] = gram_section(dev)
    elif args.wide_only:
        pmf_sources = SOURCES[:1] + SOURCES[2:]
        with ThreadPoolExecutor(6) as pool:
            futs = [pool.submit(summary, s, WIDE_D) for s in pmf_sources]
            list(pool.map(lambda s: cuda_build.build(
                s, cuda_build.width_defines(s, WIDE_D)), pmf_sources))
            for f in futs:
                results["ptxas"].append(f.result())
                print("ptxas " + json.dumps(results["ptxas"][-1]), flush=True)
    else:
        ptxas_section(results)
    if not (args.gram or args.chol or args.noise):
        results["wide"] = wide_kernels(dev)
        results["gram"] = gram_section(dev)
        results["chol_b1"] = chol_section(dev)
        results["noise"] = noise_section(dev)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
