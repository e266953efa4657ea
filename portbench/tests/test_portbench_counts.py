"""The operation and byte counts against values worked by hand."""

import pytest

from portbench import counts


def test_b1_bytes_match_the_bring_up_count_at_d10():
    # PERF.md §6 of the bring-up: 95 values a row, 102.3 MB for 160 lanes
    # x 1,682 rows in float32 (the lanes' alpha, mu and cell are small)
    assert counts.tri(10) + 4 * 10 == 95
    rows = counts.b1_bytes(160, 1682, 10) - counts.b1_bytes(160, 0, 10)
    assert rows == 160 * 1682 * 95 * 4


def test_b1_at_a_small_shape():
    # L = 2 lanes, r = 3 rows, d = 2: p = 3, a row 3 + 8 = 11 values; a
    # lane alpha 4 + mu 2 + centre 1 + factor row 2 + dm, dr 2 = 11
    # values and two 8-byte indices
    assert counts.b1_bytes(2, 3, 2) == 4 * (2 * 3 * 11 + 2 * 11) + 32
    # a row: S 2p = 6, rhs 3d + 2d^2 = 14, Cholesky d^3/3 = 8/3,
    # solves 3 d^2 = 12, sum d = 2: 36 + 2/3; a lane 2d^2 + 4d + 2p = 22
    assert counts.b1_flops(2, 3, 2) == pytest.approx(
        2 * 3 * (36 + 2 / 3) + 2 * 22)


def test_chain_sample_at_a_small_shape():
    n, m, d, nnz = 2, 3, 2, 4
    # hyper(N): 2 N d^2 + 2 N d + 2 inverses 2 d^3 + 2 Cholesky d^3/3 +
    # Bartlett and outer products 2 x 2 d^3 + mean 2 d^2
    hyper = {N: 8 * N + 4 * N + 32 + 16 / 3 + 32 + 8 for N in (n, m)}
    assert counts.hyper_flops(n, d) == pytest.approx(hyper[n])
    gram = nnz * (6 + 4)  # 2p + 2d a rated cell
    row = 36 + 2 / 3
    sweep = 2 * gram + (n + m) * row
    pred = 2 * n * m * d
    assert counts.chain_sample_flops(n, m, d, nnz) == pytest.approx(
        hyper[n] + hyper[m] + 2 * sweep + pred)


def test_least_time_takes_the_larger_bound():
    peak = {"f32_flops": 10.0, "bytes_per_s": 2.0}
    assert counts.least_seconds(30.0, 4.0, peak) == 3.0
    assert counts.least_seconds(10.0, 8.0, peak) == 4.0
