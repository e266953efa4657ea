"""Operations and bytes the cells' work needs, and the card's peaks.

Everything here is computed from shapes and counts alone, never from a
profiler or from the port, so a faster implementation of the same work
reads a higher share and the same count.

**A Gibbs sample of one lane** (``chain_sample_flops``), on an n x m
problem of width d with ``nnz`` rated cells (the known ones, plus the
lane's own for a lookahead lane), p = d (d + 1) / 2:

  * the hyperparameter draw of each side of N rows (``hyper_flops``):
    the mean and the centred scatter 2 N d^2 + 2 N d; two d x d inverses
    (2 d^3 each), two Cholesky factors (d^3 / 3 each), the Bartlett
    product and the Wishart's outer product (2 d^3 each), the mean's
    draw 2 d^2;
  * in each of the ``num_gibbs`` = 2 sweeps, the row draws of U and of V:
    the Gram and right-hand-side accumulation over the rated cells only,
    2 p + 2 d a cell (the lower triangle of v v^T and r v, a multiply and
    an add each) on each side (``gram_flops``); and for every row
    (``row_flops``) the precision S = alpha + beta G (2 p), the
    right-hand side beta (mr - c G_o) + alpha mu (3 d + 2 d^2), the
    Cholesky factor (d^3 / 3), two triangular solves for the mean and
    one for the noise (3 d^2) and the sum (d);
  * the predictive statistic, 2 n m d (the product U V^T).

The lane's MAP refit before its chain is left out: its steps depend on
the line search. So is every dense pass over the 99.7 %-zero mask that
an implementation may choose. The count is therefore an undercount of
what the port does, and the same whatever implements the step.

**B1** (``b1_bytes``, ``b1_flops``): the Cholesky solve-and-sample kernel
fed by the masked Gram products (``amf_tpu_torch/csrc/chol_solve_sample.cu``,
Gram-fed entry). One launch draws r rows of L lanes. Each input is read
once and the output written once: a row's packed Gram p + d values, its
right-hand side d, its noise d and its draw d, that is p + 4 d values (95
at d = 10, the 102.3 MB of 160 lanes x 1,682 rows in ``PERF.md`` §6 of
the port's bring-up); a lane's alpha (d^2), mu (d) and centre (1), and its
one cell (the factor row d, dm and dr, two 8-byte indices). Its operations
are ``row_flops`` a row and 2 d^2 + 4 d + 2 p a lane (alpha mu and the
cell's update). Any d up to the kernel's widths.
"""

from __future__ import annotations

from typing import Optional

# NVIDIA's data sheet, H100 SXM5 (the "80GB HBM3" part): dense float32
# outside the tensor cores, HBM bandwidth, at the full 700 W power limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "bytes_per_s": 3.35e12},
}


def peaks(device_name: str) -> Optional[dict]:
    """The card's peaks, or None for a card the table lacks."""
    return PEAKS.get(device_name)


def tri(d: int) -> int:
    return d * (d + 1) // 2


def hyper_flops(N: int, d: int) -> float:
    return 2 * N * d * d + 2 * N * d + 2 * (2 * d ** 3) + 2 * (d ** 3 / 3) \
        + 2 * (2 * d ** 3) + 2 * d * d


def gram_flops(nnz: int, d: int) -> float:
    return nnz * (2 * tri(d) + 2 * d)


def row_flops(d: int) -> float:
    return 2 * tri(d) + 3 * d + 2 * d * d + d ** 3 / 3 + 3 * d * d + d


def chain_sample_flops(n: int, m: int, d: int, nnz: int,
                       num_gibbs: int = 2) -> float:
    """Operations of one Gibbs sample of one lane (see the module)."""
    sweep = 2 * gram_flops(nnz, d) + (n + m) * row_flops(d)
    return hyper_flops(n, d) + hyper_flops(m, d) + num_gibbs * sweep \
        + 2 * n * m * d


def b1_bytes(L: int, r: int, d: int, itemsize: int = 4) -> float:
    """Bytes one Gram-fed B1 launch of L lanes x r rows must move."""
    per_row = tri(d) + 4 * d
    per_lane = d * d + d + 1 + d + 2
    return itemsize * (L * r * per_row + L * per_lane) + 16 * L


def b1_flops(L: int, r: int, d: int) -> float:
    """Operations one Gram-fed B1 launch of L lanes x r rows needs."""
    return L * r * row_flops(d) + L * (2 * d * d + 4 * d + 2 * tri(d))


def least_seconds(flops: float, nbytes: float, peak: dict) -> float:
    """The least time the card could take: the larger of operations over
    its peak rate and bytes over its bandwidth."""
    return max(flops / peak["f32_flops"], nbytes / peak["bytes_per_s"])
