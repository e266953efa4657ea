"""The port's whole-line-search lookahead refit
(``amf_tpu_torch/ops/pmf_kernels.py::pmf_lookahead_fused_t``) against the
JAX package's Pallas kernel (``amf_tpu/ops/pallas_kernels.py``, interpret
mode) and against the port's own proposal loop.

Every lane starts at a fitted base state, so at ``max_steps = 40`` every
lane converges before its budget ends (two after one step, one after 38)
and skips the steps left. Tolerances are those of
tests/test_pallas_kernels.py:176-186, which holds the JAX fused kernel to
its proposal loop: the value to rtol 1e-4, the factors to rtol 1e-3 with
atol 1e-5. The two sides take the same accept/reject decisions, but sum
each evaluation in another order, and over a long trajectory at a growing
lr those float32 differences grow (to ~2e-5 of the value here). bf16 rounds
the same values at the same points on both sides; its factors are held to
one bf16 rounding (rtol 2^-7, atol 1e-3).

The kernel walks the index of the rated cells (``rated_index``), which only
the card reads, on two sets of state buffers. Both are held here on the
CPU in numpy: one evaluation by the kernel's walk (a row pass over CSR that
keeps each cell's residual, a column pass over CSC that fetches it through
``csc_pos``) gives the plain version's and the JAX reference's value and
gradients, in float64 to 1e-12 scaled (the same products, summed in
another order); and the kernel's whole search (proposal into the spare set,
swap on accept, no column pass on reject, the copy of a lane that ends on
set 1) makes the plain version's evaluations and ends at its value (rtol
1e-4) and factors (1e-3 scaled: numpy's float32 dot sums in yet another
order, and over 38 steps at a growing lr the difference reads 1.5e-4).

The JAX package is imported by a fixture, so the tests marked ``cuda`` also
run on a card host without JAX:
``python -m pytest --noconftest tests/test_torch_lookahead_fused.py -m cuda``.
"""

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a worker)
from amf_tpu_torch.models import pmf as tpmf
from amf_tpu_torch.ops import pmf_kernels as tpk
from amf_tpu_torch.types import Problem

STEPS = 40
TOL = {False: dict(val=1e-4, rtol=1e-3, atol=1e-5),
       True: dict(val=1e-4, rtol=2 ** -7, atol=1e-3)}


def _problem(rng, n, m):
    rated = rng.random((n, m)) < 0.5
    R = np.where(rated, rng.integers(1, 6, (n, m)), 0).astype(np.float32)
    return R, rated


@pytest.fixture(scope="module")
def case():
    """(Ut0, Vt0, R, rated, di, dj, dv, sigmas, ls_params) as numpy: the
    base factors fitted by the port's ``fit`` on a 13 x 9 problem, d = 3,
    and three lanes, the first on a rated cell."""
    rng = np.random.default_rng(21)
    n, m, d = 13, 9, 3
    R, rated = _problem(rng, n, m)
    cfg = tpmf.PMFConfig(latent_d=d)
    prob = Problem(R_obs=torch.as_tensor(R), rated=torch.as_tensor(rated),
                   queryable=torch.as_tensor(~rated),
                   test=torch.as_tensor(rated))
    st = tpmf.init_state(torch.Generator().manual_seed(0), n, m, cfg, prob,
                         device="cpu")
    st, _ = tpmf.fit(st, prob, cfg)
    on = np.argwhere(rated)[0]
    di = np.asarray([on[0], 5, 12], np.int32)
    dj = np.asarray([on[1], 8, 0], np.int32)
    dv = np.asarray([3.0, 1.0, 5.0], np.float32)
    sig = np.asarray([1.0, 10.0, 10.0], np.float32)
    ls = np.asarray([cfg.learning_rate, cfg.stop_thresh,
                     cfg.min_learning_rate], np.float32)
    return (st.U.T.numpy().copy(), st.V.T.numpy().copy(), R, rated, di, dj,
            dv, sig, ls)


def _torch(arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                               rtol=tol["val"])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w, np.float32),
                                   rtol=tol["rtol"], atol=tol["atol"])


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


@pytest.mark.parametrize("bf16", [False, True])
def test_matches_pallas_kernel_interpret(jpk, interpret, case, bf16):
    """Lane padding (L = 3, 2 lanes a block) and row padding (n = 13,
    8-row blocks) on the JAX side; every lane converges early."""
    want = jpk.pmf_lookahead_fused_t.__wrapped__(
        *(jpk.jnp.asarray(a) for a in case), max_steps=STEPS, block_rows=8,
        lanes_per_block=2, bf16=bf16)
    got = tpk.pmf_lookahead_fused_t(*_torch(case), max_steps=STEPS,
                                    block_rows=8, lanes_per_block=2,
                                    bf16=bf16)
    assert got[1].shape == (3, 3, 13) and got[2].shape == (3, 3, 9)
    assert all(x.dtype == torch.float32 for x in got)
    _close([x.numpy() for x in got], want, TOL[bf16])
    evals = tpk.pmf_lookahead_fused_plain(*_torch(case), STEPS, bf16)[3]
    assert 1 < int(evals.max()) < 1 + STEPS  # converged lanes stopped


def test_float32_equals_the_proposal_loop(case):
    """In float32 the fused line search is the lane-blocked proposal loop
    of ``fit_lookahead_batch``."""
    Ut0, Vt0, R, rated, di, dj, dv, sig, ls = _torch(case)
    f, Ut, Vt = tpk.pmf_lookahead_fused_t(
        Ut0, Vt0, R, rated, di, dj, dv, sig, ls, max_steps=STEPS, bf16=False)
    state = tpmf.PMFState(U=Ut0.T, V=Vt0.T, sigma_sq=sig[0],
                          sigma_u_sq=sig[1], sigma_v_sq=sig[2],
                          mean_rating=torch.tensor(0.0))
    prob = Problem(R_obs=R, rated=rated, queryable=~rated, test=rated)
    U, V, f_loop = tpmf.fit_lookahead_batch(
        state, prob, di, dj, dv, tpmf.PMFConfig(latent_d=3),
        max_steps=STEPS, lane_block=2, bf16=False)
    _close([f.numpy(), Ut.mT.numpy(), Vt.mT.numpy()],
           [f_loop.numpy(), U.numpy(), V.numpy()],
           TOL[False])


class _KernelWalk:
    """One lane of the kernel in numpy: ``value`` and ``grad_v`` of an
    evaluation on the index, and ``search``, the loop on two sets."""

    def __init__(self, ix, di, dj, dv, sig):
        (self.row_ptr, self.col_idx, self.r_row, self.col_ptr, self.row_idx,
         _, self.csc_pos) = (t.numpy() for t in ix[:7])
        self.n, self.m = ix.shape
        self.nnz = ix.nnz
        self.di, self.dj, self.dv, self.sig = di, dj, dv, sig

    def value(self, up, vp):
        """f at the proposal (d, n), (d, m); keeps e; returns (f, Gu)."""
        dt = up.dtype.type
        self.e = np.zeros(self.nnz + 1, up.dtype)
        gu = np.zeros_like(up)
        sq = dt(0)
        for i in range(self.n):
            cells = [(e, self.col_idx[e], self.r_row[e])
                     for e in range(self.row_ptr[i], self.row_ptr[i + 1])]
            if i == self.di:
                hit = [k for k, c in enumerate(cells) if c[1] == self.dj]
                if hit:
                    cells[hit[0]] = (cells[hit[0]][0], self.dj, self.dv)
                else:
                    cells.append((self.nnz, self.dj, self.dv))
            for e, j, r in cells:
                self.e[e] = dt(r) - up[:, i] @ vp[:, j]
                sq += self.e[e] * self.e[e]
                gu[:, i] += self.e[e] / self.sig[0] * vp[:, j]
            gu[:, i] -= up[:, i] / self.sig[1]
        f = (sq / (2 * self.sig[0]) + (up * up).sum() / (2 * self.sig[1])
             + (vp * vp).sum() / (2 * self.sig[2]))
        return f, gu

    def grad_v(self, up, vp):
        """Gv at the proposal ``value`` just took, from its e."""
        gv = np.zeros_like(vp)
        for j in range(self.m):
            found = False
            for e in range(self.col_ptr[j], self.col_ptr[j + 1]):
                i = self.row_idx[e]
                found |= j == self.dj and i == self.di
                gv[:, j] += self.e[self.csc_pos[e]] / self.sig[0] * up[:, i]
            if j == self.dj and not found:
                gv[:, j] += self.e[self.nnz] / self.sig[0] * up[:, self.di]
            gv[:, j] -= vp[:, j] / self.sig[2]
        return gv

    def search(self, u0, v0, ls, max_steps):
        """(f, U, V, evaluations, accepted proposals) in float32, as the
        kernel runs it."""
        f32 = np.float32
        lr, stop, min_lr = (f32(x) for x in ls)
        U, V, GU, GV = ([None, None] for _ in range(4))
        U[0], V[0] = u0.copy(), v0.copy()
        f, GU[0] = self.value(U[0], V[0])
        GV[0] = self.grad_v(U[0], V[0])
        cur, evals, accepts, done = 0, 1, 0, False
        for _ in range(max_steps):
            if done:
                break
            nxt = cur ^ 1
            U[nxt] = U[cur] + lr * GU[cur]
            V[nxt] = V[cur] + lr * GV[cur]
            fp, GU[nxt] = self.value(U[nxt], V[nxt])
            evals += 1
            accept = bool(np.isfinite(fp) and fp < f)
            done = bool((f - fp) < stop if accept else lr * f32(0.5) < min_lr)
            if accept:
                GV[nxt] = self.grad_v(U[nxt], V[nxt])
                f, lr, cur = fp, lr * f32(1.25), nxt
                accepts += 1
            else:
                lr = lr * f32(0.5)
        if cur == 1:
            U[0], V[0] = U[1].copy(), V[1].copy()
        return f, U[0], V[0], evals, accepts


def _ragged_eval_case(seed):
    """37 x 53 at 30 % rated with an empty row and an empty column, float64
    (d, rows) factors; the cells of three lanes: a rated one, an unrated
    one in the empty row, an unrated one in the empty column."""
    rng = np.random.default_rng(seed)
    n, m, d = 37, 53, 5
    rated = rng.random((n, m)) < 0.3
    rated[11, :] = False
    rated[:, 17] = False
    rated[3, 4] = True
    R = np.where(rated, rng.integers(1, 6, (n, m)), 0).astype(np.float64)
    return (rng.normal(size=(d, n)), rng.normal(size=(d, m)), R, rated,
            [(3, 4, 2.0), (11, 30, 5.0), (20, 17, 1.0)],
            np.asarray([0.8, 10.0, 7.0]))


@pytest.mark.parametrize("seed", [0, 1])
def test_evaluation_walk_matches_plain_and_jax_reference(jpk, seed):
    ut, vt, R, rated, cells, sig = _ragged_eval_case(seed)
    ix = tpk.rated_index(torch.as_tensor(rated), torch.as_tensor(R))
    ix = ix._replace(r_row=torch.as_tensor(R[rated]))  # keep float64
    for di, dj, dv in cells:
        walk = _KernelWalk(ix, di, dj, dv, sig)
        f, gu = walk.value(ut, vt)
        got = (f, gu.T, walk.grad_v(ut, vt).T)
        args = (ut.T[None], vt.T[None], R, rated, np.asarray([di]),
                np.asarray([dj]), np.asarray([dv]), sig)
        plain = tpk.pmf_batched_value_grad_reference(*_torch(args))
        jax_ref = jpk.pmf_batched_value_grad_reference(
            *(jpk.jnp.asarray(a) for a in args))
        for want in (plain, jax_ref):
            for g, w in zip(got, want):
                w = np.asarray(w, np.float64)[0]
                assert w.dtype == np.float64
                assert np.max(np.abs(g - w) / (1 + np.abs(w))) <= 1e-12


def test_search_on_two_sets_makes_the_plain_versions_evaluations(case):
    """Accept by swapping, no column pass on a reject: the same search."""
    x = _torch(case)
    Ut0, Vt0, R, rated, di, dj, dv, sig, ls = case
    ix = tpk.rated_index(x[3], x[2])
    f, Ut, Vt, evals, accepts = tpk.pmf_lookahead_fused_plain(*x, STEPS,
                                                              False)
    assert len(set(evals.tolist())) > 1  # lanes stop at different steps
    for lane in range(3):
        walk = _KernelWalk(ix, di[lane], dj[lane], dv[lane], sig)
        got = walk.search(Ut0, Vt0, ls, STEPS)
        assert got[3:] == (int(evals[lane]), int(accepts[lane]))
        np.testing.assert_allclose(got[0], f[lane].numpy(), rtol=1e-4)
        for g, w in zip(got[1:3], (Ut[lane].numpy(), Vt[lane].numpy())):
            assert g.dtype == np.float32
            assert np.max(np.abs(g - w) / (1 + np.abs(w))) <= 1e-3


@pytest.mark.parametrize("bf16", [False, True])
def test_plain_version_counts_the_accepted_proposals(case, bf16):
    """Every evaluation after the first is an accepted or a rejected
    proposal, and lr tells them apart: with too large a first lr every
    lane rejects before it accepts; with no steps none does either."""
    x = _torch(case)
    *_, evals, accepts = tpk.pmf_lookahead_fused_plain(*x, STEPS, bf16)
    assert evals.dtype == accepts.dtype == torch.int32
    assert bool((accepts >= 0).all() and (accepts < evals).all())
    if not bf16:
        assert int(accepts.max()) > 0
    x[8] = torch.tensor([10.0, 1e-4, 1e-10])  # lr0 far too large
    *_, evals, accepts = tpk.pmf_lookahead_fused_plain(*x, 3, bf16)
    assert evals.tolist() == [4, 4, 4] and accepts.tolist() == [0, 0, 0]
    *_, evals, accepts = tpk.pmf_lookahead_fused_plain(*x, 0, bf16)
    assert evals.tolist() == [1, 1, 1] and accepts.tolist() == [0, 0, 0]


def test_index_is_ignored_on_the_cpu(case):
    x = _torch(case)
    ix = tpk.rated_index(x[3], x[2])
    a = tpk.pmf_lookahead_fused_t(*x, max_steps=5, bf16=False, index=ix)
    b = tpk.pmf_lookahead_fused_t(*x, max_steps=5, bf16=False)
    for p, q in zip(a, b):
        torch.testing.assert_close(p, q, rtol=0, atol=0)


def test_cpu_wrapper_runs_the_plain_version_and_launches_nothing(case):
    x = _torch(case)
    launches = sum(tpk.pmf_lookahead_fused_cuda.launches.values())
    calls = tpk.pmf_lookahead_fused_plain.calls
    tpk.pmf_lookahead_fused_t(*x, max_steps=3, bf16=False)
    tpk.pmf_lookahead_fused_t(*x, max_steps=3, bf16=True)
    assert tpk.pmf_lookahead_fused_plain.calls == calls + 2
    assert sum(tpk.pmf_lookahead_fused_cuda.launches.values()) == launches


def test_cuda_launcher_refuses_cpu_tensors(case):
    launches = sum(tpk.pmf_lookahead_fused_cuda.launches.values())
    with pytest.raises(ValueError, match="CUDA"):
        tpk.pmf_lookahead_fused_cuda(*_torch(case), 3, False)
    assert sum(tpk.pmf_lookahead_fused_cuda.launches.values()) == launches


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 16, 32])
@pytest.mark.parametrize("bf16", [False, True])
def test_cuda_kernel_matches_plain(cuda_device, bf16, d):
    """Random base factors (no lane converges at once), ragged 13 x 9."""
    rng = np.random.default_rng(d)
    R, rated = _problem(rng, 13, 9)
    x = [0.3 * rng.random((d, 13)).astype(np.float32),
         0.3 * rng.random((d, 9)).astype(np.float32), R, rated,
         np.asarray([0, 5, 12], np.int32), np.asarray([1, 8, 0], np.int32),
         np.asarray([3.0, 1.0, 5.0], np.float32),
         np.asarray([1.0, 10.0, 10.0], np.float32),
         np.asarray([1e-2, 1e-4, 1e-10], np.float32)]
    x = _torch(x, cuda_device)
    launches = sum(tpk.pmf_lookahead_fused_cuda.launches.values())
    calls = tpk.pmf_lookahead_fused_plain.calls
    got = tpk.pmf_lookahead_fused_t(*x, max_steps=STEPS, bf16=bf16)
    assert sum(tpk.pmf_lookahead_fused_cuda.launches.values()) == launches + 1
    assert tpk.pmf_lookahead_fused_plain.calls == calls
    want = tpk.pmf_lookahead_fused_t(*x, max_steps=STEPS, bf16=bf16,
                                     kernel=False)
    tol = TOL[False] if not bf16 else dict(val=1e-3, rtol=2e-2, atol=2e-2)
    _close([g.cpu().numpy() for g in got], [w.cpu().numpy() for w in want],
           tol)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_cuda_kernel_on_a_ragged_index_repeats_bit_for_bit(cuda_device, bf16):
    """An empty row, an empty column, rated and unrated lane cells; the
    index is handed in; per lane the plain version's evaluations and
    accepts; the value and the factors repeat bit for bit over two
    launches."""
    ut, vt, R, rated, cells, sig = _ragged_eval_case(2)
    x = _torch([0.3 * ut.astype(np.float32), 0.3 * vt.astype(np.float32),
                R.astype(np.float32), rated,
                np.asarray([c[0] for c in cells], np.int32),
                np.asarray([c[1] for c in cells], np.int32),
                np.asarray([c[2] for c in cells], np.float32),
                sig.astype(np.float32),
                np.asarray([1e-3, 1e-4, 1e-10], np.float32)], cuda_device)
    ix = tpk.rated_index(x[3], x[2], bf16=bf16)
    builds = tpk.rated_index.calls
    before = tpk.pmf_lookahead_fused_cuda.variants["shared"]
    got = tpk.pmf_lookahead_fused_cuda(*x, 12, bf16, index=ix)
    again = tpk.pmf_lookahead_fused_cuda(*x, 12, bf16, index=ix)
    assert tpk.rated_index.calls == builds
    assert tpk.pmf_lookahead_fused_cuda.variants["shared"] == before + 2
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    want = tpk.pmf_lookahead_fused_plain(*x, 12, bf16)
    assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
    tol = TOL[False] if not bf16 else dict(val=1e-3, rtol=2e-2, atol=2e-2)
    _close([g.float().cpu().numpy() for g in got[:3]],
           [w.float().cpu().numpy() for w in want[:3]], tol)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_cuda_kernel_global_memory_variant(cuda_device, bf16):
    """943 x 1682 at d = 32 does not fit a block's shared memory."""
    rng = np.random.default_rng(5)
    n, m, d = 943, 1682, 32
    rated = rng.random((n, m)) < 0.01
    x = [0.2 * rng.random((d, n)).astype(np.float32),
         0.2 * rng.random((d, m)).astype(np.float32),
         np.where(rated, rng.integers(1, 6, (n, m)), 0).astype(np.float32),
         rated, np.asarray([0, 5, n - 1], np.int32),
         np.asarray([1, 8, m - 1], np.int32),
         np.asarray([3.0, 1.0, 5.0], np.float32),
         np.asarray([1.0, 10.0, 10.0], np.float32),
         np.asarray([1e-3, 1e-4, 1e-10], np.float32)]
    x = _torch(x, cuda_device)
    before = tpk.pmf_lookahead_fused_cuda.variants["global"]
    got = tpk.pmf_lookahead_fused_cuda(*x, 6, bf16)
    assert tpk.pmf_lookahead_fused_cuda.variants["global"] == before + 1
    want = tpk.pmf_lookahead_fused_plain(*x, 6, bf16)
    assert torch.equal(got[3], want[3])
    tol = TOL[False] if not bf16 else dict(val=1e-3, rtol=2e-2, atol=2e-2)
    _close([g.float().cpu().numpy() for g in got[:3]],
           [w.float().cpu().numpy() for w in want[:3]], tol)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_cuda_kernel_takes_large_d(cuda_device, bf16):
    """d = 48: the kernel of the library of that width against the plain
    version, on its own outputs, and once through the public function."""
    rng = np.random.default_rng(0)
    R, rated = _problem(rng, 13, 9)
    x = _torch([0.1 * rng.random((48, 13)).astype(np.float32),
                0.1 * rng.random((48, 9)).astype(np.float32), R, rated,
                np.asarray([0, 5, 12], np.int32), np.asarray([1, 8, 0], np.int32),
                np.asarray([3.0, 1.0, 5.0], np.float32),
                np.asarray([1.0, 10.0, 10.0], np.float32),
                np.asarray([1e-3, 1e-4, 1e-10], np.float32)], cuda_device)
    calls = tpk.pmf_lookahead_fused_plain.calls
    launches = sum(tpk.pmf_lookahead_fused_cuda.launches.values())
    f = tpk.pmf_lookahead_fused_t(*x, max_steps=6, bf16=bf16)[0]
    assert bool(torch.isfinite(f).all())
    got = tpk.pmf_lookahead_fused_cuda(*x, 6, bf16)
    assert sum(tpk.pmf_lookahead_fused_cuda.launches.values()) == launches + 2
    assert tpk.pmf_lookahead_fused_plain.calls == calls
    want = tpk.pmf_lookahead_fused_plain(*x, 6, bf16)
    assert torch.equal(got[3], want[3])
    tol = TOL[False] if not bf16 else dict(val=1e-3, rtol=2e-2, atol=2e-2)
    _close([g.float().cpu().numpy() for g in got[:3]],
           [w.float().cpu().numpy() for w in want[:3]], tol)


@pytest.mark.cuda
def test_cuda_kernel_refuses_cells_outside_the_problem(cuda_device, case):
    x = _torch(case, cuda_device)
    x[5] = torch.tensor([0, 9, 0], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="outside"):
        tpk.pmf_lookahead_fused_t(*x, max_steps=3)


@pytest.mark.cuda
def test_cuda_refit_paths_launch_the_kernels_and_never_the_plain(cuda_device,
                                                                 case):
    """fit_lookahead_batch on CUDA tensors: the poly-LS path launches B2 and
    B3, the fused path B5; no plain version runs."""
    Ut0, Vt0, R, rated, di, dj, dv, sig, _ = _torch(case, cuda_device)
    state = tpmf.PMFState(U=Ut0.T, V=Vt0.T, sigma_sq=sig[0],
                          sigma_u_sq=sig[1], sigma_v_sq=sig[2],
                          mean_rating=torch.tensor(0.0, device=cuda_device))
    prob = Problem(R_obs=R, rated=rated, queryable=~rated, test=rated)
    counts = (tpk.pmf_value_grad_plain, tpk.pmf_line_coeffs_plain,
              tpk.pmf_lookahead_fused_plain)
    calls = [c.calls for c in counts]
    before = [sum(c.launches.values()) for c in (
        tpk.pmf_value_grad_cuda, tpk.pmf_line_coeffs_cuda,
        tpk.pmf_lookahead_fused_cuda)]
    for kw in (dict(poly_ls=True), dict(fused=True)):
        _, _, f = tpmf.fit_lookahead_batch(
            state, prob, di, dj, dv, tpmf.PMFConfig(latent_d=3),
            max_steps=STEPS, lane_block=2, bf16=True, **kw)
        assert bool(torch.isfinite(f).all())
    after = [sum(c.launches.values()) for c in (
        tpk.pmf_value_grad_cuda, tpk.pmf_line_coeffs_cuda,
        tpk.pmf_lookahead_fused_cuda)]
    assert after[0] > before[0] and after[1] > before[1]
    assert after[2] == before[2] + 1
    assert [c.calls for c in counts] == calls
