"""The port's per-lane PMF value+gradient (amf_tpu_torch/ops/pmf_kernels.py)
against the JAX package's (amf_tpu/ops/pallas_kernels.py).

Tolerances are those of tests/test_pallas_kernels.py:78-82 (float32): the
value to rtol 1e-5, the gradients to rtol 1e-4 with atol 1e-5; the sums run
in different orders. The bf16 path is held to the JAX bf16 kernel to one
bf16 rounding of the gradients (rtol 2e-2, atol 2e-2): a residual or an
output that lies near a rounding boundary may round the other way.

The JAX package is imported by a fixture, so the tests marked ``cuda`` also
run on a card host without JAX:
``python -m pytest --noconftest tests/test_torch_pmf_kernels.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from amf_tpu_torch.ops import pmf_kernels as tpk

VAL = dict(rtol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
GRAD_BF16 = dict(rtol=2e-2, atol=2e-2)


def _inputs(seed, L, n, m, d):
    """(U, V, R, rated, di, dj, dv, sigmas) as numpy, f32 / bool / int32."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(L, n, d)).astype(np.float32),
            rng.normal(size=(L, m, d)).astype(np.float32),
            rng.integers(1, 6, size=(n, m)).astype(np.float32),
            rng.random((n, m)) < 0.4,
            rng.integers(0, n, L).astype(np.int32),
            rng.integers(0, m, L).astype(np.int32),
            rng.integers(1, 6, L).astype(np.float32),
            np.asarray([0.8, 10.0, 7.0], np.float32))


def _torch(arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


def _t(x):
    """(L, a, b) -> (L, b, a), numpy or torch."""
    return np.swapaxes(x, 1, 2) if isinstance(x, np.ndarray) else x.mT


def _jax(jpk, arrays):
    return [jpk.jnp.asarray(a) for a in arrays]


def _close(got, want, grad_tol=GRAD, val_tol=VAL):
    np.testing.assert_allclose(got[0].float().numpy(), np.asarray(want[0]),
                               **val_tol)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), **grad_tol)


@pytest.fixture(scope="module")
def jpk():
    """The JAX package's pallas_kernels module."""
    pytest.importorskip("jax")
    from amf_tpu.ops import pallas_kernels

    return pallas_kernels


@pytest.fixture
def interpret(jpk, monkeypatch):
    """Run the Pallas kernels in interpret mode on the CPU, as
    tests/test_pallas_kernels.py:109-118 does."""
    orig_call = jpk.pl.pallas_call

    def interp_call(*args, **kw):
        kw["interpret"] = True
        return orig_call(*args, **kw)

    monkeypatch.setattr(jpk.pl, "pallas_call", interp_call)


@pytest.mark.parametrize("shape",
                         [(3, 12, 9, 4), (5, 13, 8, 4), (2, 7, 11, 1)])
def test_plain_matches_jax_reference(jpk, shape):
    x = _inputs(sum(shape), *shape)
    want = jpk.pmf_batched_value_grad_reference(*_jax(jpk, x))
    _close(tpk.pmf_batched_value_grad_reference(*_torch(x)), want)


@pytest.mark.parametrize("n", [16, 13])
def test_wrapper_matches_pallas_kernel_interpret(jpk, interpret, n):
    """(L, rows, d) layout; n = 13 is not a multiple of the 8-row block."""
    x = _inputs(n, 4, n, 8, 4)
    want = jpk.pmf_batched_value_grad.__wrapped__(*_jax(jpk, x),
                                                  block_rows=8)
    _close(tpk.pmf_batched_value_grad(*_torch(x), block_rows=8), want)


def test_t_wrapper_matches_lane_blocked_kernel_interpret(jpk, interpret):
    """(L, d, rows) layout with lane padding (L = 5, 2 lanes a block) and
    row padding (n = 13, 8-row blocks)."""
    x = _inputs(7, 5, 13, 8, 4)
    xt = (_t(x[0]), _t(x[1])) + x[2:]
    want = jpk.pmf_batched_value_grad_t.__wrapped__(
        *_jax(jpk, xt), block_rows=8, lanes_per_block=2, bf16=False)
    got = tpk.pmf_batched_value_grad_t(*_torch(xt), block_rows=8,
                                       lanes_per_block=2, bf16=False)
    assert got[1].shape == (5, 4, 13) and got[1].dtype == torch.float32
    _close(got, want)


def test_t_wrapper_bf16_matches_lane_blocked_kernel_interpret(jpk, interpret):
    """bf16: R, mask and factors in bf16, the residual rounded to bf16 before
    the contractions, bf16 gradients, float32 sums and value."""
    x = _inputs(8, 4, 13, 8, 4)
    xt = (_t(x[0]), _t(x[1])) + x[2:]
    want = jpk.pmf_batched_value_grad_t.__wrapped__(
        *_jax(jpk, xt), block_rows=8, lanes_per_block=2, bf16=True)
    got = tpk.pmf_batched_value_grad_t(*_torch(xt), block_rows=8,
                                       lanes_per_block=2, bf16=True)
    assert got[1].dtype == got[2].dtype == torch.bfloat16
    assert got[0].dtype == torch.float32
    _close(got, want, grad_tol=GRAD_BF16)


def test_cpu_wrappers_run_the_plain_version_and_launch_nothing():
    x = _torch(_inputs(1, 3, 6, 5, 2))
    launches = sum(tpk.pmf_value_grad_cuda.launches.values())
    calls = tpk.pmf_value_grad_plain.calls
    a = tpk.pmf_batched_value_grad(*x)
    b = tpk.pmf_batched_value_grad_t(_t(x[0]), _t(x[1]), *x[2:], bf16=False)
    assert tpk.pmf_value_grad_plain.calls == calls + 2
    assert sum(tpk.pmf_value_grad_cuda.launches.values()) == launches
    for p, q in zip(a, (b[0], _t(b[1]), _t(b[2]))):
        torch.testing.assert_close(p, q, rtol=0, atol=0)


def test_cuda_launcher_refuses_cpu_tensors():
    x = _torch(_inputs(2, 2, 4, 3, 2))
    launches = sum(tpk.pmf_value_grad_cuda.launches.values())
    with pytest.raises(ValueError, match="CUDA"):
        tpk.pmf_value_grad_cuda(*x, transposed=False, round_resid=False,
                                out_dtype=torch.float32)
    assert sum(tpk.pmf_value_grad_cuda.launches.values()) == launches


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _kernel_vs_plain(fn, args, **kw):
    launches = sum(tpk.pmf_value_grad_cuda.launches.values())
    got = fn(*args, **kw)
    want = fn(*args, kernel=False, **kw)
    assert sum(tpk.pmf_value_grad_cuda.launches.values()) == launches + 1
    return [g.cpu() for g in got], [w.cpu() for w in want]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 5, 10, 32])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("layout", ["rows", "t"])
def test_cuda_kernel_matches_plain(cuda_device, layout, bf16, d):
    x = _torch(_inputs(d, 6, 37, 53, d), cuda_device)
    if layout == "t":
        got, want = _kernel_vs_plain(tpk.pmf_batched_value_grad_t,
                                     [_t(x[0]), _t(x[1]), *x[2:]], bf16=bf16)
    else:
        got, want = _kernel_vs_plain(tpk.pmf_batched_value_grad, x, bf16=bf16)
    tol = GRAD_BF16 if bf16 and layout == "t" else GRAD
    _close(got, [w.float().numpy() for w in want], grad_tol=tol)


@pytest.mark.cuda
def test_cuda_kernel_refuses_large_d(cuda_device):
    x = _torch(_inputs(0, 2, 5, 4, 33), cuda_device)
    with pytest.raises(ValueError, match="d <= 32"):
        tpk.pmf_batched_value_grad(*x)
