"""Sparse-SDPA export/import for the MMMF SDP (a numpy copy of
``amf_tpu/models/sdpa_io.py``: the port imports nothing of the JAX
package, whose ``__init__`` imports JAX; the files it writes differ from
the JAX package's only in the header line naming the writer).

Capability parity with the reference's external-solver path
(mmmf/printSDPA.m:28-108, readSDPA.m:30-53): write the max-margin
matrix-factorization SDP in sparse SDPA format (.dat-s) for an external
interior-point solver (CSDP/DSDP/SDPA), and read back such a solver's
solution file into (x, xu, xv, dual variables).

The in-repo solver path (models/mmmf.solve / solve_maxnorm) makes external
solvers unnecessary for the committed experiments; this module completes the
reference's interchange surface so problems can still be handed to and
results recovered from external SDP solvers.

Problem encoding (identical to the reference's):
  primal constraint count = p (+ n+m-1 for max-norm), where p = #labels;
  block 1: the (n+m) Gram block [A X; X' B];
  block 2: diagonal p-block, positive distance from margin;
  block 3 (only when C < inf): diagonal p-block of slacks, objective -C.
Nuclear mode fixes diag of block 1 via the objective; max-norm mode ties all
diagonal entries to the leading one with extra constraints.
"""

from __future__ import annotations

import datetime
from typing import Optional, TextIO, Tuple, Union

import numpy as np


def write_sdpa(
    fid: Union[str, TextIO],
    y: np.ndarray,
    maxoravg: str = "a",
    C: float = float("inf"),
    comment: Optional[str] = None,
) -> Optional[str]:
    """Write the MMMF SDP for label matrix ``y`` (+1/0/-1) in sparse SDPA.

    fid: open text file, or a string base name — then the reference's
    naming convention ``<base>.<avg|max>_<C>.dat-s`` is used and the full
    filename returned (printSDPA.m fid/string contract).
    """
    y = np.asarray(y)
    n, m = y.shape
    ii, aa = np.nonzero(y)
    vv = y[ii, aa].astype(np.float64)
    p = len(vv)
    maxprob = bool(maxoravg and maxoravg[0] == "m")
    mode = "max" if maxprob else "avg"
    allowslack = np.isfinite(C)

    fn = None
    if isinstance(fid, str):
        cstr = "%g" % C if np.isfinite(C) else "Inf"
        fn = f"{fid}.{mode}_{cstr}.dat-s"
        f = open(fn, "w")
        close = True
    else:
        f = fid
        close = False
    try:
        f.write(f"* MMMF-MC, {n}x{m}, {p} binnary labels "
                f"({p / n / m:g} sparse)\n")
        f.write(f"* Minimizing {mode}-norm, hinge loss penalty {C:f}\n")
        f.write(f"* Generated by amf_tpu_torch.models.sdpa_io, "
                f"{datetime.date.today()}\n")
        if comment:
            f.write(f"* {comment}\n")
        f.write(f"{p + maxprob * (n + m - 1)}\n")
        f.write(f"{2 + allowslack}\n")
        sizes = [str(n + m), str(-p)] + ([str(-p)] if allowslack else [])
        f.write(" ".join(sizes) + " \n")
        f.write(" ".join(["1.000000"] * p
                         + ["0.000000"] * (maxprob * (n + m - 1))) + " \n")

        # <mat#> <blk#> <i> <j> <value>, 1-indexed, upper triangle
        for t in range(p):
            f.write(f"{t + 1} 1 {ii[t] + 1} {n + aa[t] + 1} "
                    f"{vv[t] / 2:f}\n")
        for t in range(p):
            f.write(f"{t + 1} 2 {t + 1} {t + 1} -1\n")
        if allowslack:
            for t in range(p):
                f.write(f"{t + 1} 3 {t + 1} {t + 1} 1\n")
            for t in range(p):
                f.write(f"0 3 {t + 1} {t + 1} {-C:f}\n")
        if maxprob:
            for t in range(n + m - 1):
                f.write(f"{p + 1 + t} 1 {t + 2} {t + 2} 1.0\n")
            for t in range(n + m - 1):
                f.write(f"{p + 1 + t} 1 1 1 -1.0\n")
            f.write("0 1 1 1 -1.0\n")
        else:
            for t in range(n + m):
                f.write(f"0 1 {t + 1} {t + 1} -1.0\n")
    finally:
        if close:
            f.close()
    return fn


def read_sdpa_solution(
    filename: str, n: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Read a CSDP/DSDP-style solution to a problem from :func:`write_sdpa`.

    Returns (x, xu, xv, q): the learned n x m matrix (block-2 primal matrix's
    off-diagonal block), its low-norm factors from the SVD of the symmetrized
    Gram block, and the dual variables from the first line(s)
    (readSDPA.m:30-53 semantics; DSDP's '*'-prefixed header handled).
    """
    with open(filename) as f:
        first = f.readline()
        if first.startswith("*"):  # DSDP-style
            f.readline()
            f.readline()
            f.readline()  # block sizes line (unused here beyond skipping)
            q = -np.array([float(t) for t in f.readline().split()])
        else:  # CSDP-style: duals on the first line
            q = -np.array([float(t) for t in first.split()])
        entries = np.array([float(t) for t in f.read().split()])
    v = entries.reshape(-1, 5).T
    sel = (v[0] == 2) & (v[1] == 1)  # primal matrix (#2), Gram block (#1)
    size = int(max(v[2][sel].max(), v[3][sel].max()))
    G = np.zeros((size, size))
    G[v[2][sel].astype(int) - 1, v[3][sel].astype(int) - 1] = v[4][sel]
    x = G[:n, n:].copy()
    full = G + G.T - np.diag(np.diag(G))
    U, S, _ = np.linalg.svd(full)
    US = U * np.sqrt(np.maximum(S, 0.0))[None, :]
    return x, US[:n], US[n:], q
