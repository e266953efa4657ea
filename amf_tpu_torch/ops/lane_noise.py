"""Every lane's Gibbs round noise in one launch: CUDA kernel, plain version.

A chain of L lanes draws, each round and for each lane l from its own
generator (``utils/rng.lane_generators``), one block of standard normals and
one of standard Gamma variates. The plain version makes those draws as
PyTorch calls, ``normal_`` and then ``_standard_gamma`` on each generator:
2 L calls a round. On the card a generator is a (seed, Philox offset) pair
and both calls are functions of it, so the hand-written kernel
(``amf_tpu_torch/csrc/lane_noise.cu``; it replaces no Pallas kernel) draws
every lane's normals and Gamma variates in one launch, from the lanes'
seeds and offsets, and gives the very bits the calls give.

To do so it needs what torch's calls would do on this card:

  * ``normal_policy``: the grid torch's ``normal_`` takes for a tensor of
    n values (``calc_execution_policy`` in
    ``ATen/native/cuda/DistributionTemplates.h``) and the Philox offset it
    adds, from the card's SM count and threads per SM, as torch reads them;
  * ``GAMMA_INCREMENT``: the offset ``_standard_gamma`` adds, whatever its
    size (read on the card with ``Generator.get_offset()``);
  * every increment goes through ``philox_round_up``, as
    ``CUDAGeneratorImpl::philox_cuda_state`` rounds it.

``lane_noise_cuda`` launches the kernel for lanes given as seeds and
offsets; ``utils/rng.LaneStreams`` reads those off the generators once a
chain, hands them to it every round, and moves the generators on at the
chain's end. ``lane_noise_plain`` is the per-lane version: the CPU's path
(a CPU generator is a Mersenne Twister, which no kernel imitates) and the
kernel's test oracle. ``lane_noise_cuda.launches`` counts launches by
(kind, dtype), kind ``normal+gamma``, ``normal`` or ``gamma``.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

_SOURCE = "lane_noise"
BLOCK = 256  # torch's block_size_bound, the kernel's block
# at most 4 offsets a curand call (max_generator_offsets_per_curand_call)
OFFSETS_PER_DRAW = 4
# what ``_standard_gamma`` passes to ``philox_cuda_state`` on the card,
# whatever its size (torch's Distributions.cu; read on the H100 by
# ``tests/test_torch_lane_noise.py``)
GAMMA_INCREMENT = 10
# normal_'s unroll: values a thread takes from one curand draw
UNROLL = {torch.float32: 4, torch.float64: 2}


def philox_round_up(increment: int) -> int:
    """The offset a generator moves by for a call asking ``increment``:
    ``philox_cuda_state`` rounds it up to a multiple of 4."""
    return (increment + 3) // 4 * 4


def normal_policy(numel: int, unroll: int, sm_count: int,
                  threads_per_sm: int) -> Tuple[int, int]:
    """(offset increment, grid) of torch's ``normal_`` on ``numel`` values
    (``calc_execution_policy``): blocks of 256, at most as many as the card
    keeps resident, each thread drawing ``unroll`` values a curand call."""
    grid = min(sm_count * (threads_per_sm // BLOCK), -(-numel // BLOCK))
    return (((numel - 1) // (BLOCK * grid * unroll) + 1) * OFFSETS_PER_DRAW,
            grid)


@functools.cache
def _card(index: int) -> Tuple[int, int]:
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.max_threads_per_multi_processor


def _normal_launch(size: int, dtype, device) -> Tuple[int, int]:
    """(offset increment, grid) of ``normal_`` on ``size`` values of
    ``dtype`` on ``device``; (0, 0) for no value (torch returns before
    drawing)."""
    if size == 0:
        return 0, 0
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return normal_policy(size, UNROLL[dtype], *_card(index))


def draw_increment(size: int, dtype, gammas: bool, device) -> int:
    """How far one lane's generator moves for ``size`` normals of ``dtype``
    and then, with ``gammas``, one ``_standard_gamma`` call."""
    inc = philox_round_up(_normal_launch(size, dtype, device)[0])
    return inc + (philox_round_up(GAMMA_INCREMENT) if gammas else 0)


@functools.cache
def _entry_points():
    from amf_tpu_torch.ops import cuda_build

    lib = cuda_build.load(_SOURCE)
    p, ll, u64, i = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_ulonglong,
                     ctypes.c_int)
    fns = {}
    for dtype, suffix in ((torch.float32, "f32"), (torch.float64, "f64")):
        fn = getattr(lib, "amf_lane_noise_" + suffix)
        fn.argtypes = [p, p, u64, p, ll, i, u64, p, p, i, ll, p]
        fn.restype = i
        fns[dtype] = fn
    return fns


def lane_noise_cuda(seeds: torch.Tensor, base: int,
                    starts: Optional[torch.Tensor], size: int, dtype,
                    shape: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(L, size) standard normals and, with ``shape`` (k,), (L, k) standard
    Gamma variates at those shapes, for L lanes whose generators have seeds
    ``seeds`` (L,) int64 (a seed's 64 bits) and offsets ``base`` (+
    ``starts`` (L,) int64, where given): lane l's rows are what
    ``normal_`` and then ``_standard_gamma`` on its generator would give.
    One launch on the current stream, no synchronisation, and none where
    there is nothing to draw; the generators are not moved
    (``utils/rng.LaneStreams`` does that)."""
    if dtype not in UNROLL:
        raise ValueError(f"lane noise is float32 or float64, not {dtype}")
    dev = seeds.device
    if dev.type != "cuda" or seeds.dtype != torch.int64 or seeds.dim() != 1:
        raise ValueError("seeds are a 1-D int64 CUDA tensor")
    if starts is not None and (starts.device != dev
                               or starts.dtype != torch.int64
                               or starts.shape != seeds.shape):
        raise ValueError("starts are an int64 tensor like seeds")
    if not 0 <= size < 2 ** 31:
        raise ValueError(f"size {size} is not a 32-bit count")
    L = seeds.shape[0]
    normal_inc, grid = _normal_launch(size, dtype, dev)
    normals = torch.empty((L, size), dtype=dtype, device=dev)
    gammas, k = None, 0
    if shape is not None:
        if shape.dtype != dtype or shape.device != dev or shape.dim() != 1:
            raise ValueError("shape is a 1-D tensor of the draws' dtype, on "
                             "the seeds' device")
        shape = shape.contiguous()
        k = shape.shape[0]
        gammas = torch.empty((L, k), dtype=dtype, device=dev)
    if L == 0 or size == k == 0:
        return normals, gammas  # nothing to draw, nothing launched
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _entry_points()[dtype](
        seeds.data_ptr(), 0 if starts is None else starts.data_ptr(),
        int(base), normals.data_ptr(), size, grid,
        philox_round_up(normal_inc), 0 if shape is None else shape.data_ptr(),
        0 if gammas is None else gammas.data_ptr(), k, L, stream)
    if err:
        raise RuntimeError(f"lane_noise kernel launch failed: CUDA error "
                           f"{err} (L={L}, size={size}, k={k}, {dtype})")
    kind = "+".join(n for n, on in (("normal", size), ("gamma", k)) if on)
    lane_noise_cuda.launches[(kind, str(dtype))] += 1
    return normals, gammas


lane_noise_cuda.launches = collections.Counter()


def lane_noise_plain(generators: Sequence[Optional[torch.Generator]],
                     size: int, dtype, device,
                     shape: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain version: row l of (L, size) normals by one ``normal_`` on
    generator l, then, with ``shape``, row l of the (L, k) Gamma variates by
    one ``_standard_gamma`` on it."""
    normals = torch.empty((len(generators), size), dtype=dtype, device=device)
    for row, gen in zip(normals, generators):
        row.normal_(generator=gen)
    gammas = None
    if shape is not None:
        gammas = torch.stack([torch._standard_gamma(shape, generator=gen)
                              for gen in generators])
    return normals, gammas
