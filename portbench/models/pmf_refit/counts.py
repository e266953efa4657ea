"""Operations and bytes of the ``pmf_refit`` family's work, from shapes and
counts alone (never from a profiler or from the port).

**B4** (``b4_flops``, ``b4_bytes``): one launch of the value+gradient
kernel (``amf_tpu_torch/csrc/pmf_value_grad.cu``) on L lanes of an n x m
problem of width d with ``nnz`` rated cells, each lane adding one cell
that is not rated. Per lane, each of its nnz + 1 cells costs in the row
pass the prediction u.v (2 d), the residual (1), its square summed (2),
the scaled residual (1) and its share of Gu (2 d), and in the column pass
the scaled residual again (1) and its share of Gv (2 d): 6 d + 5; each of
the n + m rows then takes its prior term, a division and a subtraction a
value (2 d). The threads' tree sum of the squared error is the kernel's
own arithmetic and is not counted. Bytes: each lane's factors read once
and its gradients written once ((n + m) d values each, in ``itemsize``),
its squared error (4 B), its cell (two 8-byte indices, a 4-byte value);
the index of rated cells once for all lanes (it stays in L2): CSR and CSC
pointers ((n + 1) + (m + 1) 4-byte values), and a column index, a value,
a row index and a CSC-to-CSR position a cell (16 B); the three sigmas.
The residuals that the kernel keeps in shared memory or a scratch buffer
are its choice and are not counted.

**A tile** (``tile_flops``): B4 on every evaluation of the refit's
lockstep loop (the start's and one a pass: one launch each), plus the
prediction U V^T of
every lane for its test RMSE (2 n m d a lane). The loop's elementwise
proposals and selections and the RMSE's masked sums are not counted: the
count is an undercount of what the port does, and the same whatever
implements the tile.
"""

from __future__ import annotations


def b4_flops(L: int, n: int, m: int, d: int, nnz: int) -> float:
    """Operations one B4 launch of L lanes needs (see the module)."""
    return L * ((nnz + 1) * (6 * d + 5) + 2 * d * (n + m))


def b4_bytes(L: int, n: int, m: int, d: int, nnz: int,
             itemsize: int = 4) -> float:
    """Bytes one B4 launch of L lanes must move (see the module)."""
    lane = 2 * (n + m) * d * itemsize + 4 + 8 + 8 + 4
    index = 4 * (n + 1 + m + 1) + 16 * nnz
    return L * lane + index + 3 * 4


def tile_flops(L: int, n: int, m: int, d: int, nnz: int,
               evaluations: int) -> float:
    """Counted operations of one tile whose refit loop made
    ``evaluations`` evaluations of the value and gradients (see the
    module)."""
    return evaluations * b4_flops(L, n, m, d, nnz) + L * 2 * n * m * d
