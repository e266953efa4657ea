"""Process groups over devices (mirrors ``amf_tpu/parallel/mesh.py``).

The JAX package is single-controller: one process drives a 1-D ``Mesh``
of devices and shards the candidate axis over it with ``shard_map``. The
counterpart here is one process a device, joined by a
``torch.distributed`` process group. The port's paths are host-bound (a
launch at a time, syncs inside every sampler transition), so one thread
driving several cards would run them one after another; one process a
card runs them side by side.

Every rank runs the whole active loop on a replicated state (the same
problem, fits and chains under the same seeds); only the lookahead
scoring is split (``parallel/sharding``). :func:`launch` starts the ranks
(``torch.multiprocessing`` with the ``spawn`` method) or, under
``torchrun``, joins the group that the environment describes.

Device of a rank: on ``cuda`` rank r calls ``torch.cuda.set_device`` before
it makes any tensor or generator, and ``"cuda"`` then means that card. The
default backend is ``nccl`` on ``cuda`` and ``gloo`` on ``cpu``. More ranks
than cards raises, unless the caller names ``backend="gloo"``: then ranks
share the cards round-robin and gloo stages every gather through the host.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import shutil
import sys
import tempfile
import time
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

# the name of the JAX package's mesh axis: the ranks split this axis
CANDIDATE_AXIS = "candidates"

# a collective that waits longer than this fails the run (gloo's default
# is half an hour)
TIMEOUT = datetime.timedelta(seconds=300)


@dataclasses.dataclass
class CandidateMesh:
    """This process's place in a group of ranks, one a device.

    ``group`` None means the default process group. ``stats`` holds
    ``setup_s``, the seconds from :func:`launch` to the group's first
    collective (absent when the group was not started by ``launch``); the
    sharded scorers' times are spans (``parallel/sharding``).
    """

    rank: int
    size: int
    device: torch.device
    backend: str
    group: Optional[Any] = None
    stats: dict = dataclasses.field(default_factory=dict)
    owns_group: bool = False

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (same shape on every rank), in rank order, on
        ``t``'s device. gloo gathers host copies; booleans travel as
        bytes."""
        if self.size == 1:
            return [t]
        src = t.contiguous()
        if src.dtype == torch.bool:
            src = src.to(torch.uint8)
        if self.backend == "gloo" and src.device.type != "cpu":
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return [p.to(device=t.device, dtype=t.dtype) for p in parts]

    def check_same(self, value: int, what: str) -> None:
        """Raise unless every rank holds the same integer ``value``: ranks
        that part ways would otherwise wait on each other's collectives
        until the timeout, or record different runs without a word."""
        if self.size == 1:
            return
        dev = self.device if self.backend == "nccl" else torch.device("cpu")
        got = self.all_gather(torch.tensor([int(value)], dtype=torch.int64,
                                           device=dev))
        seen = [int(g) for g in got]
        if any(s != seen[0] for s in seen):
            raise RuntimeError(f"ranks disagree on {what}: {seen}")

    def close(self) -> None:
        """Destroy the process group if this mesh started it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_group = False


def _backend_for(device: torch.device, backend: Optional[str]) -> str:
    if backend is None:
        return "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', not {backend!r}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs device='cuda'")
    return backend


def _check_world(n_devices: int, device: torch.device, backend: str) -> None:
    """The refusals that hold before any rank starts."""
    if n_devices < 1:
        raise ValueError(f"a mesh needs at least one rank, not {n_devices}")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device cuda requested but CUDA is not "
                               "available")
        count = torch.cuda.device_count()
        if n_devices > count and backend != "gloo":
            raise ValueError(
                f"{n_devices} ranks need {n_devices} cards and this host has "
                f"{count}; name backend='gloo' to share cards between ranks")


def _resolve(device, backend):
    from amf_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    return dev, _backend_for(dev, backend)


def _under_torchrun() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))


def _select_card(rank: int, device: torch.device) -> torch.device:
    if device.type != "cuda":
        return device
    card = rank % torch.cuda.device_count()
    torch.cuda.set_device(card)
    return torch.device("cuda", card)


def make_mesh(n_devices: Optional[int] = None, device=None,
              backend: Optional[str] = None) -> CandidateMesh:
    """The mesh of this process.

    Uses the default process group when one is initialized (as by
    :func:`launch`), joins the one the environment describes under
    ``torchrun`` (``env://``), and otherwise starts a world of one
    (``n_devices`` None or 1), which :meth:`CandidateMesh.close` ends.
    ``n_devices``, when given, must equal the group's size.
    """
    dev, backend = _resolve(device, backend)
    owns = False
    if not dist.is_initialized():
        if _under_torchrun():
            # the ranks of this host share its cards
            _check_world(int(os.environ.get("LOCAL_WORLD_SIZE",
                                            os.environ["WORLD_SIZE"])),
                         dev, backend)
            dev = _select_card(int(os.environ.get("LOCAL_RANK",
                                                  os.environ["RANK"])), dev)
            dist.init_process_group(backend, init_method="env://",
                                    timeout=TIMEOUT)
        else:
            if n_devices not in (None, 1):
                raise RuntimeError(
                    f"no process group for {n_devices} ranks: start them "
                    "with parallel.mesh.launch or torchrun")
            _check_world(1, dev, backend)
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1, timeout=TIMEOUT)
        owns = True
    elif dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"asked for {n_devices} ranks; the process group "
                         f"has {size}")
    return CandidateMesh(rank=rank, size=size, device=dev,
                         backend=dist.get_backend(), owns_group=owns)


def _rank_main(rank: int, n_devices: int, device: str, backend: str,
               store_path: str, result_path: str, threads: int,
               t_launch: float, fn: Callable, args: tuple) -> None:
    """One spawned rank: join the group, run ``fn(mesh, *args)``, and on
    rank 0 write its result for the parent."""
    torch.set_num_threads(threads)
    dev = _select_card(rank, torch.device(device))
    dist.init_process_group(
        backend, init_method=f"file://{store_path}", rank=rank,
        world_size=n_devices, timeout=TIMEOUT)
    try:
        mesh = make_mesh(n_devices, dev, backend)
        mesh.check_same(0, "the first collective")
        mesh.stats["setup_s"] = time.time() - t_launch
        result = fn(mesh, *args)
        if rank == 0:
            with open(result_path, "wb") as f:
                pickle.dump(result, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, n_devices: int, device=None,
           backend: Optional[str] = None, *args):
    """Run ``fn(mesh, *args)`` on ``n_devices`` ranks that join one group;
    return rank 0's result (the other ranks' results are dropped).

    ``fn`` and ``args`` go to fresh interpreters (the ``spawn`` method), so
    ``fn`` is a module-level function of this package and ``args`` pickle.
    Each rank runs with the caller's number of torch threads. A rank's
    exception fails the call; a collective that waits :data:`TIMEOUT` fails
    its rank. Under ``torchrun`` this process is one of the ranks: it runs
    ``fn`` on the group that the environment describes and returns its
    result on rank 0 and None elsewhere.
    """
    dev, backend = _resolve(device, backend)
    if _under_torchrun():
        mesh = make_mesh(n_devices, dev, backend)
        try:
            result = fn(mesh, *args)
            return result if mesh.rank == 0 else None
        finally:
            mesh.close()
    _check_world(n_devices, dev, backend)
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="amf_torch_mesh_")
    try:
        result_path = os.path.join(tmp, "result.pkl")
        mp.spawn(_rank_main, nprocs=n_devices, join=True,
                 args=(n_devices, dev.type, backend,
                       os.path.join(tmp, "store"), result_path,
                       torch.get_num_threads(), time.time(), fn, args))
        with open(result_path, "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def launch_cli(run: Callable, args, *rest):
    """A command line's body ``run(mesh, args, *rest)``: on
    ``args.shard_candidates`` ranks (``--device`` names their devices) when
    that is set, else here with no mesh. A ``--scan`` sweep runs unsharded,
    as in the JAX package's command lines, and says so on stderr."""
    n = getattr(args, "shard_candidates", 0)
    if n and getattr(args, "scan", False):
        sys.stderr.write("--scan runs the sweep unsharded: "
                         "--shard-candidates is ignored\n")
    elif n:
        return launch(run, n, args.device, None, args, *rest)
    return run(None, args, *rest)


def is_lead(mesh: Optional[CandidateMesh]) -> bool:
    """Whether this process prints and writes: rank 0, or no mesh."""
    return mesh is None or mesh.rank == 0


def pad_to_multiple(x: torch.Tensor, multiple: int, dim: int = 0, fill=0):
    """(x padded along ``dim`` to a multiple of ``multiple``, the original
    size), as the JAX package's helper; no copy when nothing is missing."""
    size = x.shape[dim]
    rem = (-size) % multiple
    if rem == 0:
        return x, size
    shape = list(x.shape)
    shape[dim] = rem
    pad = torch.full(shape, fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=dim), size
