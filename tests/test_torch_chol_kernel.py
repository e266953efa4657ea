"""The port's Cholesky solve-and-sample (amf_tpu_torch/ops/chol_kernel.py)
against the JAX package's (amf_tpu/ops/chol_kernel.py).

Tolerances: the plain version and the JAX reference run the same two back
substitutions, so float64 agrees to rtol 1e-10. The Pallas kernel (run in
interpret mode, as tests/test_chol_kernel.py runs it) uses one forward and
one back substitution instead, so float32 agrees to rounding, 2e-4.

The JAX package is imported by a fixture, so the tests marked ``cuda`` also
run on a card host without JAX:
``python -m pytest --noconftest tests/test_torch_chol_kernel.py``.
"""

import numpy as np
import pytest
import torch

from amf_tpu_torch.ops import chol_kernel as tck

TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "float64": dict(rtol=1e-10, atol=1e-12)}


def _inputs(seed, B, d, dtype):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, d, d))
    S = (A @ np.swapaxes(A, 1, 2) + d * np.eye(d)).astype(dtype)
    rhs = rng.normal(size=(B, d)).astype(dtype)
    z = rng.normal(size=(B, d)).astype(dtype)
    return S, rhs, z


def _torch(*arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


@pytest.fixture(scope="module")
def jck():
    """The JAX package's chol_kernel module."""
    pytest.importorskip("jax")
    from amf_tpu.ops import chol_kernel

    return chol_kernel


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("d", [1, 4, 10, 20])
def test_plain_matches_jax_reference(jck, d, dtype):
    S, rhs, z = _inputs(d, 37, d, dtype)
    want = np.asarray(jck.chol_solve_sample_reference(S, rhs, z))
    got = tck.chol_solve_sample(*_torch(S, rhs, z))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])


@pytest.mark.parametrize("d", [1, 4, 10, 20])
def test_plain_matches_pallas_kernel_interpret(jck, d):
    S, rhs, z = _inputs(100 + d, 37, d, "float32")
    want = np.asarray(jck.chol_solve_sample_tpu(S, rhs, z, interpret=True))
    got = tck.chol_solve_sample(*_torch(S, rhs, z))
    np.testing.assert_allclose(got.numpy(), want, **TOL["float32"])


def test_leading_batch_dims_and_cpu_leaves_kernel_count():
    S, rhs, z = _inputs(2, 6, 4, "float64")
    launches = tck.chol_solve_sample_batch_minor.launches
    calls = tck.chol_solve_sample_reference.calls
    out = tck.chol_solve_sample(*_torch(
        S.reshape(2, 3, 4, 4), rhs.reshape(2, 3, 4), z.reshape(2, 3, 4)))
    assert out.shape == (2, 3, 4)
    flat = tck.chol_solve_sample(*_torch(S, rhs, z))
    np.testing.assert_array_equal(out.reshape(6, 4).numpy(), flat.numpy())
    assert tck.chol_solve_sample_batch_minor.launches == launches
    assert tck.chol_solve_sample_reference.calls == calls + 2


def test_cuda_wrapper_refuses_cpu_tensors():
    S, rhs, z = _inputs(3, 5, 3, "float32")
    launches = tck.chol_solve_sample_batch_minor.launches
    with pytest.raises(ValueError, match="CUDA"):
        tck.chol_solve_sample_cuda(*_torch(S, rhs, z))
    assert tck.chol_solve_sample_batch_minor.launches == launches


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("d", [1, 5, 10, 20, 32])
def test_cuda_kernel_matches_plain(cuda_device, d, dtype):
    S, rhs, z = _inputs(d, 4097, d, dtype)
    St, bt, zt = _torch(S, rhs, z, device=cuda_device)
    launches = tck.chol_solve_sample_batch_minor.launches
    got = tck.chol_solve_sample(St, bt, zt)
    want = tck.chol_solve_sample(St, bt, zt, kernel=False)
    assert tck.chol_solve_sample_batch_minor.launches == launches + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **TOL[dtype])


@pytest.mark.cuda
def test_cuda_kernel_refuses_large_d(cuda_device):
    S, rhs, z = _inputs(0, 3, 33, "float32")
    with pytest.raises(ValueError, match="d <= 32"):
        tck.chol_solve_sample(*_torch(S, rhs, z, device=cuda_device))
