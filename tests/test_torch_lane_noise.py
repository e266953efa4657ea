"""Every lane's Gibbs round noise in one launch
(amf_tpu_torch/ops/lane_noise.py, csrc/lane_noise.cu, utils/rng.LaneStreams)
against the per-lane PyTorch calls it replaces.

The kernel computes what torch's own ``normal_`` and ``_standard_gamma``
compute from each lane's (seed, Philox offset), so on the card every value
is held with ``torch.equal``, and every generator's offset after a chain to
the offset the per-lane calls leave. On the CPU the lanes keep their
per-lane calls (a CPU generator is a Mersenne Twister), and what can be
checked there is the launch arithmetic and that the CPU path is unchanged.

Nothing here imports JAX, so the tests marked ``cuda`` run on a card host
without it: ``python -m pytest --noconftest tests/test_torch_lane_noise.py``.
"""

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a worker)
from amf_tpu_torch.models import bpmf_gibbs as tbg
from amf_tpu_torch.ops import lane_noise as tln
from amf_tpu_torch.utils import profiling
from amf_tpu_torch.utils.rng import (LaneStreams, lane_generators,
                                     lane_normals)

# (numel, unroll, SMs, threads a SM) -> (offset increment, grid), worked by
# hand from calc_execution_policy (ATen/native/cuda/DistributionTemplates.h)
POLICY = [
    ((1, 4, 132, 2048), (4, 1)),
    ((256, 4, 132, 2048), (4, 1)),
    ((257, 4, 132, 2048), (4, 2)),
    ((1001, 2, 132, 2048), (4, 4)),
    ((15880, 4, 132, 2048), (4, 63)),       # db70x306-bpmf-d20's round, f32
    ((105840, 4, 132, 2048), (4, 414)),     # ml100k-bpmf-d20's round, f32
    ((105840, 2, 132, 2048), (4, 414)),
    ((270336, 4, 132, 2048), (4, 1056)),    # every thread of the grid
    ((270337, 4, 132, 2048), (4, 1056)),    # a thread takes .y
    ((1081344, 4, 132, 2048), (4, 1056)),   # ... and .w
    ((1081345, 4, 132, 2048), (8, 1056)),   # a thread draws twice
    ((540673, 2, 132, 2048), (8, 1056)),    # f64: twice
    ((3 * 1081344 + 1, 4, 132, 2048), (16, 1056)),
    ((105840, 4, 114, 2048), (4, 414)),     # H100 PCIe: 912 blocks
    ((500000, 4, 114, 2048), (4, 912)),
    ((933889, 4, 114, 2048), (8, 912)),
    ((500000, 4, 132, 1536), (4, 792)),
]


@pytest.mark.parametrize("args,want", POLICY)
def test_normal_policy_is_torchs(args, want):
    assert tln.normal_policy(*args) == want


def test_increments_round_up_to_four_as_the_generator_does(monkeypatch):
    assert [tln.philox_round_up(i) for i in (0, 1, 4, 5, 10, 12)] == \
        [0, 4, 4, 8, 12, 12]
    monkeypatch.setattr(tln, "_card", lambda index: (132, 2048))
    # a db70x306-bpmf-d20 round: 4 for the normals, 12 for the Gamma call
    assert tln.draw_increment(15880, torch.float32, True, "cuda:0") == 16
    assert tln.draw_increment(1081345, torch.float32, False, "cuda:0") == 8
    assert tln.draw_increment(0, torch.float64, True, "cuda:0") == 12
    assert tln.draw_increment(0, torch.float64, False, "cuda:0") == 0


def _shape(d, n, m, dtype, device):
    like = torch.empty((), dtype=dtype, device=device)
    return torch.cat([tbg._dof_shape(d, d + n, like),
                      tbg._dof_shape(d, d + m, like)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_lanes_keep_their_per_lane_calls(dtype):
    """On the CPU a draw is each generator's ``normal_`` then
    ``_standard_gamma``, value for value, and nothing is launched."""
    launches = sum(tln.lane_noise_cuda.launches.values())
    shape = _shape(3, 6, 5, dtype, "cpu")
    with LaneStreams(lane_generators(9, [4, 1], 2, "cpu"), "cpu") as streams:
        assert not streams.batched and len(streams) == 4
        got = [streams.draw(17, dtype, shape) for _ in range(2)]
    gens = lane_generators(9, [4, 1], 2, "cpu")
    for normals, gammas in got:
        for gen, row, gam in zip(gens, normals, gammas):
            want = torch.empty(17, dtype=dtype).normal_(generator=gen)
            assert torch.equal(row, want)
            assert torch.equal(gam, torch._standard_gamma(shape,
                                                          generator=gen))
    normals = lane_normals(lane_generators(2, [0, 7, 8], 1, "cpu"), 11,
                           dtype, "cpu")
    for gen, row in zip(lane_generators(2, [0, 7, 8], 1, "cpu"), normals):
        assert torch.equal(row, torch.empty(11, dtype=dtype).normal_(
            generator=gen))
    assert sum(tln.lane_noise_cuda.launches.values()) == launches


def _chain_case(device, dtype=torch.float32, L=3, d=3, n=9, m=13):
    from amf_tpu_torch import types as ttypes

    rng = np.random.default_rng(5)
    known = rng.random((n, m)) < 0.3
    prob = ttypes.problem_from_dense(rng.integers(1, 6, (n, m)).astype(
        float), known, dtype=dtype, device=device)
    chain = tbg.ChainState(
        torch.as_tensor(rng.normal(size=(L, n, d)), dtype=dtype,
                        device=device),
        torch.as_tensor(rng.normal(size=(L, m, d)), dtype=dtype,
                        device=device),
        torch.full((L,), 3.0, dtype=dtype, device=device))
    return prob, chain, tbg.GibbsConfig(latent_d=d)


def test_the_noise_span_says_whether_the_round_was_batched():
    """``gibbs.noise`` carries ``batched`` 0 on every round of a CPU
    chain."""
    prob, chain, cfg = _chain_case("cpu", torch.float64)
    profiling.spans(reset=True)
    with profiling.tracing():
        tbg.run_chain(chain, prob, cfg, 4,
                      generators=lane_generators(1, [0, 1, 2], 1, "cpu"))
    noise = [s for s in profiling.spans(reset=True) if s.name == "gibbs.noise"]
    assert [s.attrs["batched"] for s in noise] == [0] * 4


# ---------------------------------------------------------------------------
# the CUDA kernel, on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _generators(device, L, earlier):
    """L lane generators; with ``earlier``, lane l first draws l % 3 small
    normal calls, so the lanes start at different offsets."""
    gens = lane_generators(1234567891011, range(L), 1, device)
    if earlier:
        for l, gen in enumerate(gens):
            for _ in range(l % 3):
                torch.randn(5, generator=gen, device=device)
    return gens


def _plain(device, L, earlier, size, dtype, shape, rounds=1):
    gens = _generators(device, L, earlier)
    out = [tln.lane_noise_plain(gens, size, dtype, device, shape)
           for _ in range(rounds)]
    return out, [g.get_offset() for g in gens]


def _batched(device, L, earlier, size, dtype, shape, rounds=1):
    gens = _generators(device, L, earlier)
    with LaneStreams(gens, device) as streams:
        assert streams.batched
        out = [streams.draw(size, dtype, shape) for _ in range(rounds)]
    return out, [g.get_offset() for g in gens]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("size", [15880, 105840, 1001, 270337])
@pytest.mark.parametrize("L", [1, 3, 160, 512])
def test_cuda_normals_are_torchs_bit_for_bit(cuda_device, L, size, dtype):
    """The two lookahead configurations' round sizes (db70x306-bpmf-d20,
    ml100k-bpmf-d20), a size not a multiple of 4 and one past the grid's
    270,336 threads, from generators at offset 0 (one offset for all
    lanes) and after earlier draws (an offset a lane)."""
    for earlier in (False, True):
        launches = tln.lane_noise_cuda.launches[("normal", str(dtype))]
        (got,), got_off = _batched(cuda_device, L, earlier, size, dtype,
                                   None)
        (want,), want_off = _plain(cuda_device, L, earlier, size, dtype,
                                   None)
        assert tln.lane_noise_cuda.launches[("normal", str(dtype))] == \
            launches + 1
        assert got[1] is None and want[1] is None
        assert torch.equal(got[0], want[0])
        assert got_off == want_off


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,size", [(torch.float32, 1081345),
                                        (torch.float32, 3 * 1081344 + 7),
                                        (torch.float64, 540673)])
def test_cuda_normals_where_a_thread_draws_more_than_once(cuda_device,
                                                          dtype, size):
    """Above the grid's threads times the unroll a thread loops (and the
    generator moves by 8 or 16): two rounds of it, three lanes."""
    got, got_off = _batched(cuda_device, 3, True, size, dtype, None, 2)
    want, want_off = _plain(cuda_device, 3, True, size, dtype, None, 2)
    for g, w in zip(got, want):
        assert torch.equal(g[0], w[0])
    assert got_off == want_off


SHAPES = {
    "ml100k-bpmf-d20": lambda dt, dev: _shape(20, 943, 1682, dt, dev),
    "db70x306-bpmf-d20": lambda dt, dev: _shape(20, 70, 306, dt, dev),
    "below one": lambda dt, dev: torch.tensor(
        [1e-3, 0.05, 0.3, 0.5, 0.9, 0.999, 1.0, 2.5] * 3, dtype=dt,
        device=dev),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_cuda_round_noise_is_torchs_bit_for_bit(cuda_device, name, dtype):
    """A chain's round, normals then Gamma variates at the Bartlett shapes
    of both configurations and at shapes below 1, for 512 and 3 lanes over
    three rounds: every value, and every generator's offset after the
    chain."""
    shape = SHAPES[name](dtype, cuda_device)
    for L, size, earlier in ((512, 15880, False), (3, 105840, True)):
        got, got_off = _batched(cuda_device, L, earlier, size, dtype, shape,
                                3)
        want, want_off = _plain(cuda_device, L, earlier, size, dtype, shape,
                                3)
        for g, w in zip(got, want):
            assert torch.equal(g[0], w[0])
            assert torch.equal(g[1], w[1])
        assert got_off == want_off


@pytest.mark.cuda
def test_cuda_generator_increments_are_the_ones_read_on_the_card(
        cuda_device):
    """``_standard_gamma`` moves a generator by the same rounded
    ``GAMMA_INCREMENT`` at any size, and ``normal_`` by the policy's."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    for k in (1, 40, 1000, 100000):
        start = gen.get_offset()
        torch._standard_gamma(torch.full((k,), 2.5, device=cuda_device),
                              generator=gen)
        assert gen.get_offset() - start == tln.philox_round_up(
            tln.GAMMA_INCREMENT)
    for dtype in (torch.float32, torch.float64):
        for size in (1, 15880, 540673, 1081345):
            start = gen.get_offset()
            torch.empty(size, dtype=dtype, device=cuda_device).normal_(
                generator=gen)
            assert gen.get_offset() - start == tln.draw_increment(
                size, dtype, False, cuda_device)


@pytest.mark.cuda
def test_cuda_lane_helpers_and_the_default_generator(cuda_device):
    """``lane_normals`` on the card launches the kernel, and so does a
    draw of Gamma variates alone, each giving the per-lane calls' values; a
    lane given as None draws from the device's default generator."""
    shape = SHAPES["db70x306-bpmf-d20"](torch.float32, cuda_device)
    before = sum(tln.lane_noise_cuda.launches.values())
    gens = _generators(cuda_device, 5, True)
    normals = lane_normals(gens, 400, torch.float32, cuda_device)
    with LaneStreams(gens, cuda_device) as streams:
        gammas = streams.draw(0, torch.float32, shape)[1]
    assert sum(tln.lane_noise_cuda.launches.values()) == before + 2
    gens = _generators(cuda_device, 5, True)
    want_n, _ = tln.lane_noise_plain(gens, 400, torch.float32, cuda_device)
    _, want_g = tln.lane_noise_plain(gens, 0, torch.float32, cuda_device,
                                     shape)
    assert torch.equal(normals, want_n) and torch.equal(gammas, want_g)

    default = torch.cuda.default_generators[cuda_device.index]
    outs = []
    for batched in (True, False):
        default.manual_seed(77)
        torch.randn(3, device=cuda_device)
        if batched:
            with LaneStreams([None], cuda_device) as streams:
                outs.append(streams.draw(1001, torch.float32, shape))
        else:
            outs.append(tln.lane_noise_plain([None], 1001, torch.float32,
                                             cuda_device, shape))
        outs.append(default.get_offset())
    assert torch.equal(outs[0][0], outs[2][0])
    assert torch.equal(outs[0][1], outs[2][1])
    assert outs[1] == outs[3]


@pytest.mark.cuda
def test_cuda_nothing_to_draw_launches_nothing(cuda_device):
    """No lane, or no value of either kind: empty blocks of the right
    shapes, and no launch counted."""
    before = tln.lane_noise_cuda.launches.copy()
    shape = torch.full((4,), 2.5, device=cuda_device)
    seeds = torch.arange(3, dtype=torch.int64, device=cuda_device)
    normals, gammas = tln.lane_noise_cuda(seeds[:0], 0, None, 100,
                                          torch.float32, shape)
    assert normals.shape == (0, 100) and gammas.shape == (0, 4)
    normals, gammas = tln.lane_noise_cuda(seeds, 0, None, 0, torch.float32)
    assert normals.shape == (3, 0) and gammas is None
    assert tln.lane_noise_cuda.launches == before


class _PerLaneStreams(LaneStreams):
    """``LaneStreams`` drawing through the per-lane calls on the card."""

    def __init__(self, generators, device):
        super().__init__(generators, device)
        self.batched = False


@pytest.mark.cuda
def test_cuda_chain_is_the_plain_chain_bit_for_bit(cuda_device,
                                                   monkeypatch):
    """A 30-round, 8-lane chain with its cells: its statistics and end
    state through the kernel are ``torch.equal`` to the same chain with the
    per-lane calls put in its place, every round's span says ``batched``,
    and the kernel launches once a round."""
    from amf_tpu_torch import types as ttypes

    prob, chain, cfg = _chain_case(cuda_device, L=8, d=20, n=70, m=306)
    cells = ttypes.LaneCells(
        i=torch.arange(8, device=cuda_device) % 70,
        j=torch.arange(8, device=cuda_device) * 7 % 306,
        v=torch.tensor([1.0, -1.0] * 4, device=cuda_device))
    runs = []
    for kernel in (True, False):
        gens = lane_generators(42, range(4), 2, cuda_device)
        with monkeypatch.context() as mp:
            if not kernel:
                mp.setattr(tbg, "LaneStreams", _PerLaneStreams)
            launches = tln.lane_noise_cuda.launches.copy()
            profiling.spans(reset=True)
            with profiling.tracing():
                end, stats, _ = tbg.run_chain(
                    chain, prob, cfg, 30, generators=gens, cells=cells,
                    cutoffs=(0.0,), value_bounds=(-2.0, 0.0, 2.0))
            spans = profiling.spans(reset=True)
        made = tln.lane_noise_cuda.launches - launches
        batched = [s.attrs["batched"] for s in spans
                   if s.name == "gibbs.noise"]
        assert batched == [int(kernel)] * 30
        assert made == ({("normal+gamma", "torch.float32"): 30} if kernel
                        else {})
        runs.append((end, stats, [g.get_offset() for g in gens]))
    (e1, s1, o1), (e2, s2, o2) = runs
    for a, b in zip((e1.U, e1.V, *s1), (e2.U, e2.V, *s2)):
        assert torch.equal(a, b)
    assert o1 == o2
