"""Arithmetic the per-layer readers share: kernel shares, B1's roofline,
the step's share of the card's peak."""

from __future__ import annotations

import re

from portbench import counts

GEMM = re.compile(r"gemm|gemv|cutlass|xmma|cublas", re.IGNORECASE)
B1 = "chol_gram_kernel"


def gemm_pct(tr):
    ks = tr.kernels if tr is not None else []
    total = sum(d for _, _, d in ks)
    if total <= 0:
        return None
    return 100.0 * sum(d for n, _, d in ks if GEMM.search(n)) / total


def idle_pct(tr):
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def b1_roofline_pct(r, lanes: int):
    """B1's least time over its device time in the traced units: its
    launches alternate the n rows of U and the m rows of V."""
    peak = counts.peaks(r.device_name)
    if r.trace is None or peak is None:
        return None
    launches = [d for n, _, d in r.trace.kernels if B1 in n]
    if not launches:
        return None
    n, m, d = r.config["rows"], r.config["cols"], r.config["latent_d"]
    least = 0.0
    for k in range(len(launches)):
        rows = n if k % 2 == 0 else m
        least += counts.least_seconds(counts.b1_flops(lanes, rows, d),
                                      counts.b1_bytes(lanes, rows, d), peak)
    return 100.0 * least / (sum(launches) * 1e-6)


def mfu_pct(r, flops: float):
    peak = counts.peaks(r.device_name)
    if peak is None or r.window.seconds <= 0:
        return None
    return 100.0 * flops / r.window.seconds / peak["f32_flops"]
