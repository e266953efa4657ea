"""The port's Cholesky solve-and-sample (amf_tpu_torch/ops/chol_kernel.py)
against the JAX package's (amf_tpu/ops/chol_kernel.py).

Tolerances: the plain version and the JAX reference run the same two back
substitutions, so float64 agrees to rtol 1e-10. The Pallas kernel (run in
interpret mode, as tests/test_chol_kernel.py runs it) uses one forward and
one back substitution instead, so float32 agrees to rounding, 2e-4.

The Gram-fed function (``chol_gram_solve_sample``, what the Gibbs row draws
call) is held, from numpy seeds, to the assembly of S and the right-hand
side written out here as tensor operations, and through it to the JAX
package's kernel and reference on that S, right-hand side and z.

The JAX package is imported by a fixture, so the tests marked ``cuda`` also
run on a card host without JAX:
``python -m pytest --noconftest tests/test_torch_chol_kernel.py``.
"""

import functools

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a worker)
from amf_tpu_torch.ops import chol_kernel as tck
from amf_tpu_torch.ops import cuda_build

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


def test_wide_d_on_the_cpu_matches_jax_plain_version(jck):
    """d = 40 is above the kernels' 32: both dispatchers take the plain
    version."""
    S, rhs, z = _inputs(40, 6, 40, "float64")
    want = np.asarray(jck.chol_solve_sample(S, rhs, z))
    got = tck.chol_solve_sample(*_torch(S, rhs, z))
    np.testing.assert_allclose(got.numpy(), want, **TOL["float64"])


@pytest.mark.parametrize("cli", ["bayes_pmf", "add_rmse_boosts"])
def test_help_states_the_widest_factor_the_kernels_take(cli, capsys):
    """Any width runs on the card and on the CPU; above 32 the kernels build
    a library of that width at its first use: said where a user picks
    -D."""
    import importlib

    main = importlib.import_module(f"amf_tpu_torch.run.{cli}").main
    with pytest.raises(SystemExit):
        main(["--help"])
    text = " ".join(capsys.readouterr().out.split())
    assert "any d on the card" in text
    assert "a wider d builds a library of its own" in text
    assert cuda_build.BUCKETED_D == 32
    assert cuda_build.width_defines("chol_solve_sample", 48) == (
        "AMF_ONLY_D=48",)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_indefinite_matrix_gives_nan_on_its_row_only(jck, dtype):
    """One S of the batch is not positive definite: the plain version gives
    NaN on that row and the others' values, as the JAX reference does, and
    raises nothing (no host wait on the factorisation's info)."""
    S, rhs, z = _inputs(3, 4, 5, dtype)
    S[2] = -S[2]
    want = np.asarray(jck.chol_solve_sample_reference(S, rhs, z))
    got = tck.chol_solve_sample(*_torch(S, rhs, z)).numpy()
    assert np.isnan(want[2]).all() and np.isnan(got[2]).all()
    keep = [0, 1, 3]
    assert np.isfinite(got[keep]).all()
    np.testing.assert_allclose(got[keep], want[keep], **TOL[dtype])
    x = _gram_case(5, 2, 6, 4, 3, dtype, True, False)
    x["alpha"][1] = -x["alpha"][1] - 100 * np.eye(3)
    gram = tck.chol_gram_solve_sample(*_gram_args(x)).numpy()
    assert np.isnan(gram[1]).all() and np.isfinite(gram[0]).all()


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
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_kernel_takes_large_d(cuda_device, dtype):
    """d = 48, above the shared library's 32: the kernel of a library built
    for that width, through the dispatcher, against the plain version; no
    plain version runs unless the caller says ``kernel=False``."""
    args = _torch(*_inputs(48, 300, 48, dtype), device=cuda_device)
    calls = tck.chol_solve_sample_reference.calls
    launches = tck.chol_solve_sample_batch_minor.launches
    got = tck.chol_solve_sample(*args)
    assert tck.chol_solve_sample_batch_minor.launches == launches + 1
    assert tck.chol_solve_sample_reference.calls == calls
    want = tck.chol_solve_sample(*args, kernel=False)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **TOL[dtype])


# ---------------------------------------------------------------------------
# the Gram-fed function

BETA = 2.0


def _gram_case(seed, L, r, c, d, dtype, center, cells):
    """A small row-draw problem as numpy: the shared mask and ratings, each
    lane's other factor, prior, noise, centre and cell."""
    rng = np.random.default_rng(seed)
    mask = (rng.random((r, c)) < 0.5).astype(dtype)
    A = rng.normal(size=(L, d, d))
    x = dict(
        mask=mask, masked_r=mask * rng.integers(1, 6, (r, c)).astype(dtype),
        other=rng.normal(size=(L, c, d)).astype(dtype),
        alpha=(A @ np.swapaxes(A, 1, 2) / d + np.eye(d)).astype(dtype),
        mu=rng.normal(size=(L, d)).astype(dtype),
        z=rng.normal(size=(L, r, d)).astype(dtype), center=None, cells=None)
    if center:
        x["center"] = rng.normal(size=L).astype(dtype) + 3
    if cells:
        # lane 0 on the ragged last row; dm = 0 is a cell already rated
        row = rng.integers(0, r, L)
        row[0] = r - 1
        x["cells"] = (row, rng.integers(0, c, L),
                      (np.arange(L) % 2).astype(dtype),
                      rng.normal(size=L).astype(dtype))
    return x


def _assembled(x):
    """(S (L, r, d, d), rhs (L, r, d)): the row draws' precision and
    right-hand side from dense (L, r, d, d) tensor operations."""
    mask, masked_r, other, alpha, mu = _torch(
        x["mask"], x["masked_r"], x["other"], x["alpha"], x["mu"])
    L, c, d = other.shape
    r = mask.shape[0]
    vv = (other[..., :, None] * other[..., None, :]).reshape(L, c, d * d)
    G = torch.bmm(mask.expand(L, r, c), torch.cat([vv, other], dim=-1))
    S = alpha[:, None] + BETA * G[..., :d * d].reshape(L, r, d, d)
    mr = torch.bmm(masked_r.expand(L, r, c), other)
    center = None if x["center"] is None else torch.as_tensor(x["center"])
    if center is not None:
        mr = mr - center[:, None, None] * G[..., d * d:]
    rhs = BETA * mr + (alpha @ mu[..., None])[:, None, :, 0]
    if x["cells"] is not None:
        row, col, dm, dr = _torch(*x["cells"])
        lane = torch.arange(L)
        o = other[lane, col]
        S[lane, row] += (BETA * dm)[:, None, None] * (o[:, :, None]
                                                      * o[:, None, :])
        shift = dr if center is None else dr - dm * center
        rhs[lane, row] += (BETA * shift)[:, None] * o
    return S, rhs


def _gram_args(x, device="cpu"):
    """The Gram-fed function's arguments, the products taken with numpy."""
    d = x["other"].shape[2]
    a, b = np.tril_indices(d)
    ot = np.swapaxes(x["other"], 1, 2)  # (L, d, c)
    Xt = np.concatenate([ot[:, a] * ot[:, b], ot], axis=1)
    Gt = Xt @ x["mask"].T
    mrt = ot @ x["masked_r"].T

    def dev(v):
        return None if v is None else torch.as_tensor(v, device=device)

    cells = x["cells"] and tuple(dev(v) for v in x["cells"])
    return (dev(Gt), dev(mrt), dev(x["z"]), dev(x["alpha"]), dev(x["mu"]),
            BETA, dev(x["center"]), cells, dev(x["other"]))


GRAM_CASES = pytest.mark.parametrize("d,center,cells", [
    (d, ce, cl) for d in (1, 5, 10, 16, 17, 20, 32) for ce in (False, True)
    for cl in (False, True)])
# the CUDA kernel's widths held to the plain version at many shapes: its
# groups of 2 (to d = 10), 4 (to 20) and 8 threads a matrix, d = 16 (the
# widest a thread's loops unroll in the S-given entry), 17 and the
# benchmark's 20
CUDA_WIDTHS = (1, 5, 10, 16, 17, 20, 32)


@GRAM_CASES
def test_gram_plain_matches_assembled_reference(d, center, cells):
    x = _gram_case(d, 3, 37, 29, d, "float64", center, cells)
    launches = tck.chol_gram_solve_sample_cuda.launches
    got = tck.chol_gram_solve_sample(*_gram_args(x))
    assert tck.chol_gram_solve_sample_cuda.launches == launches
    S, rhs = _assembled(x)
    want = tck.chol_solve_sample_reference(S, rhs, torch.as_tensor(x["z"]))
    assert got.shape == (3, 37, d) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@GRAM_CASES
def test_gram_plain_matches_jax_reference(jck, d, center, cells, dtype):
    x = _gram_case(50 + d, 2, 21, 40, d, dtype, center, cells)
    got = tck.chol_gram_solve_sample(*_gram_args(x)).numpy()
    S, rhs = (t.reshape(-1, *t.shape[2:]).numpy() for t in _assembled(x))
    want = np.asarray(jck.chol_solve_sample_reference(
        S, rhs, x["z"].reshape(-1, d)))
    np.testing.assert_allclose(got.reshape(-1, d), want, **TOL[dtype])


@pytest.mark.parametrize("d", [1, 5, 10, 32])
def test_gram_plain_matches_pallas_kernel_interpret(jck, d):
    """With and without centre and cells, as one batch of the JAX kernel."""
    got, ins = [], []
    for k, (center, cells) in enumerate(
            [(False, False), (False, True), (True, False), (True, True)]):
        x = _gram_case(70 + 4 * d + k, 2, 21, 40, d, "float32", center, cells)
        got.append(tck.chol_gram_solve_sample(*_gram_args(x)).numpy())
        S, rhs = _assembled(x)
        ins.append((S.numpy(), rhs.numpy(), x["z"]))
    S, rhs, z = (np.concatenate([c[k].reshape(-1, *c[k].shape[2:])
                                 for c in ins]) for k in range(3))
    want = np.asarray(jck.chol_solve_sample_tpu(S, rhs, z, interpret=True))
    np.testing.assert_allclose(np.concatenate(got).reshape(-1, d), want,
                               **TOL["float32"])


def test_launch_counts_count_plain_calls_on_the_cpu():
    """``launch_counts`` gives the two entries' launches and the plain
    version's calls; on the CPU the plain version runs and no launch
    counts."""
    x = _gram_case(1, 2, 9, 5, 20, "float64", True, True)
    before = tck.launch_counts()
    assert set(before) == {"gram_fed", "s_given", "plain"}
    tck.chol_gram_solve_sample(*_gram_args(x))
    after = tck.launch_counts()
    assert after["plain"] == before["plain"] + 1
    assert all(after[k] == before[k] for k in before if k != "plain")


def test_gram_kernel_widths_fit_shared_memory():
    """The Gram-fed kernel's block (groups of 2 to 32 threads a matrix,
    each row a record at an odd stride) fits the H100's 227 KB of shared
    memory up to d = 149 in float32, and up to 77 and from 81 to 104 in
    float64, where groups of 32 hold half as many records as groups of
    16; the benchmark's d = 20 takes 35,688 and 71,376 bytes."""
    assert [tck.gram_group(d) for d in (1, 10, 11, 20, 21, 40, 41, 80, 81)] \
        == [2, 2, 4, 4, 8, 8, 16, 16, 32]
    fits = {size: [d for d in range(1, 200)
                   if tck.gram_smem_bytes(d, size) <= tck.SMEM_PER_BLOCK]
            for size in (4, 8)}
    assert fits[4] == list(range(1, 150))
    assert fits[8] == list(range(1, 78)) + list(range(81, 105))
    assert (tck.gram_smem_bytes(20, 4), tck.gram_smem_bytes(20, 8)) \
        == (35688, 71376)


def test_gram_cuda_wrapper_refuses_cpu_tensors():
    x = _gram_case(0, 2, 5, 4, 3, "float32", True, True)
    launches = tck.chol_gram_solve_sample_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        tck.chol_gram_solve_sample_cuda(*_gram_args(x))
    assert tck.chol_gram_solve_sample_cuda.launches == launches


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@GRAM_CASES
def test_gram_cuda_kernel_matches_plain(cuda_device, d, center, cells, dtype):
    """r = 300 spans three blocks of a lane, the last ragged; z and other
    are handed over with a lane stride that is not their size."""
    x = _gram_case(d, 3, 300, 41, d, dtype, center, cells)
    args = list(_gram_args(x, cuda_device))
    wide = torch.zeros((3, 2, 300, d), dtype=args[2].dtype,
                       device=cuda_device)
    wide[:, 1] = args[2]
    args[2] = wide[:, 1]
    launches = tck.chol_gram_solve_sample_cuda.launches
    calls = tck.chol_solve_sample_reference.calls
    got = tck.chol_gram_solve_sample(*args)
    assert tck.chol_gram_solve_sample_cuda.launches == launches + 1
    assert tck.chol_solve_sample_reference.calls == calls
    want = tck.chol_gram_solve_sample(*args, kernel=False)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_gram_cuda_kernel_takes_large_d(cuda_device, dtype):
    """d = 48 with centre and cells, against the plain version."""
    x = _gram_case(48, 3, 200, 64, 48, dtype, True, True)
    args = _gram_args(x, cuda_device)
    calls = tck.chol_solve_sample_reference.calls
    launches = tck.chol_gram_solve_sample_cuda.launches
    got = tck.chol_gram_solve_sample(*args)
    assert tck.chol_gram_solve_sample_cuda.launches == launches + 1
    assert tck.chol_solve_sample_reference.calls == calls
    want = tck.chol_gram_solve_sample(*args, kernel=False)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("r", [70, 300, 1682])
@pytest.mark.parametrize("L,extras", [(3, True), (3, False), (1, True)])
@pytest.mark.parametrize("d", CUDA_WIDTHS)
def test_gram_cuda_widths_match_plain(cuda_device, d, L, extras, r, dtype):
    """The kernel against the plain version: every r leaves a ragged last
    block (groups of 2, 4 or 8 threads a matrix take 64, 32 or 16 rows a
    block), with and without centre and cells, and a launch of one lane, as
    the active loop's chain makes."""
    x = _gram_case(100 + d, L, r, 41, d, dtype, extras, extras)
    args = _gram_args(x, cuda_device)
    launches = tck.chol_gram_solve_sample_cuda.launches
    got = tck.chol_gram_solve_sample(*args)
    assert tck.chol_gram_solve_sample_cuda.launches == launches + 1
    want = tck.chol_gram_solve_sample(*args, kernel=False)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("d", [5, 20])
def test_gram_cuda_indefinite_matrix_gives_nan_on_its_row_only(
        cuda_device, d, dtype):
    """Row 37 of lane 1 gets a negative first pivot: the kernel gives NaN on
    that row alone, and its neighbours in the block and in its warp keep
    the plain version's values."""
    x = _gram_case(7, 2, 70, 41, d, dtype, True, True)
    args = list(_gram_args(x, cuda_device))
    args[0] = args[0].clone()
    args[0][1, 0, 37] = -1e3  # the Gram's (0, 0) entry
    got = tck.chol_gram_solve_sample(*args).cpu().numpy()
    want = tck.chol_gram_solve_sample(*args, kernel=False).cpu().numpy()
    bad = np.isnan(got).any(axis=-1)
    assert np.isnan(got[1, 37]).all() and np.isnan(want[1, 37]).all()
    assert bad.sum() == 1 and np.isfinite(got[~bad]).all()
    np.testing.assert_allclose(got[~bad], want[~bad], **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [5, 20])
def test_cuda_launch_counts_and_chain_launches_b1_once_a_half_sweep(
        cuda_device, d, monkeypatch):
    """Each launch counts under ``gram_fed``, and a chain's row draws launch
    the kernel once a half sweep; with the plain version put in its place
    for the call, they launch nothing and call the plain version as
    often."""
    from amf_tpu_torch import types as ttypes
    from amf_tpu_torch.models import bpmf_gibbs

    x = _gram_case(d, 2, 40, 30, d, "float32", True, True)
    before = tck.launch_counts()
    tck.chol_gram_solve_sample(*_gram_args(x, cuda_device))
    after = tck.launch_counts()
    assert after == dict(before, gram_fed=before["gram_fed"] + 1)

    rng = np.random.default_rng(d)
    known = rng.random((12, 15)) < 0.3
    prob = ttypes.problem_from_dense(
        rng.integers(1, 6, (12, 15)).astype(float), known,
        dtype=torch.float32, device=cuda_device)
    cfg = bpmf_gibbs.GibbsConfig(latent_d=d)
    draws = 2 * cfg.num_gibbs * 2  # rounds x sweeps x (U, V)
    for kernel in (True, False):
        chain = bpmf_gibbs.ChainState(
            torch.randn(12, d, device=cuda_device),
            torch.randn(15, d, device=cuda_device),
            torch.tensor(3.0, device=cuda_device))
        with monkeypatch.context() as mp:
            if not kernel:
                mp.setattr(bpmf_gibbs, "chol_gram_solve_sample",
                           functools.partial(tck.chol_gram_solve_sample,
                                             kernel=False))
            before = tck.launch_counts()
            bpmf_gibbs.run_chain(
                chain, prob, cfg, 2,
                generator=torch.Generator(device=cuda_device).manual_seed(1))
            after = tck.launch_counts()
        key = "gram_fed" if kernel else "plain"
        assert after == dict(before, **{key: before[key] + draws})


@pytest.mark.cuda
def test_gram_cuda_wrapper_refuses_a_width_past_shared_memory(cuda_device):
    """d = 150 in float32 and d = 78 in float64 need more shared memory a
    block than the card has: the wrapper says so before it builds a
    library, and launches nothing."""
    launches = tck.chol_gram_solve_sample_cuda.launches
    for d, dtype in ((150, "float32"), (78, "float64")):
        x = _gram_case(d, 1, 3, 2, d, dtype, False, False)
        with pytest.raises(ValueError, match="shared memory"):
            tck.chol_gram_solve_sample(*_gram_args(x, cuda_device))
    assert tck.chol_gram_solve_sample_cuda.launches == launches
