"""Ranks, process groups and batch splits — the counterpart of
:mod:`irn_tpu.parallel.mesh` in PyTorch's idiom.

The JAX package shards one global batch over a device mesh inside one
process, or over the devices of several processes after
``jax.distributed.initialize``. The port runs one process per rank under
``torch.distributed`` instead, each on one device (rank r on
``cuda:LOCAL_RANK``, or the CPU): a train stage wraps its model in DDP and
each rank loads its contiguous rows of every global batch
(:func:`local_batch_slice`, the loader's ``local_rows``); the make stages
take a strided share of the images (``pipeline.common.host_shard_range``).

A group's collectives run on its backend, NCCL for CUDA and gloo for the
CPU by default; a ``backend`` argument picks one explicitly (gloo over CUDA
tensors lets two ranks share one card, which NCCL refuses). Beside it
every group keeps a gloo group on the host for the barriers, so a barrier
costs no device collective. Every rendezvous, barrier and collective has a
timeout, so a hung rank fails the run instead of holding it.
"""

from __future__ import annotations

import dataclasses
import datetime
import inspect
import os
import pickle
import socket
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 1800.0

_HOST_GROUP = None  # the gloo group of the barriers


@dataclasses.dataclass(frozen=True)
class RankSpec:
    """The ranks a stage runs on when it starts them itself: one device per
    rank (``devices[r]`` is rank r's), the collectives' backend (None: NCCL
    for CUDA, gloo for the CPU) and every collective's timeout."""

    devices: Tuple[str, ...]
    backend: Optional[str] = None
    timeout_s: float = DEFAULT_TIMEOUT_S

    def __post_init__(self):
        object.__setattr__(self, "devices", tuple(str(d) for d in self.devices))
        if not self.devices:
            raise ValueError("RankSpec: no devices")


def indexed(device) -> torch.device:
    """``device`` with its index: ``cuda`` alone is the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def is_main() -> bool:
    return rank() == 0


def ranks_for_batch(batch_size: int, requested: int, device) -> int:
    """``mesh_for_batch``'s rule: the largest rank count <= ``requested``
    that divides the batch; 0 asks for every visible card (the CPU counts
    as one). More CUDA ranks than visible cards raise, as JAX's
    ``make_mesh`` cannot place them; the CPU takes as many as asked for."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    n = requested or (torch.cuda.device_count() if cuda else 1)
    if cuda and n > torch.cuda.device_count():
        raise ValueError(f"{n} ranks asked for, {torch.cuda.device_count()} "
                         "CUDA device(s) visible")
    if n < 1 or batch_size < 1:
        raise ValueError(f"ranks {n} for batch {batch_size}")
    return max(d for d in range(1, n + 1) if batch_size % d == 0)


def rank_devices(device, n: int) -> Tuple[str, ...]:
    """The devices of n ranks started from one process: cuda:0 .. cuda:n-1,
    or the CPU n times."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return tuple(f"cuda:{i}" for i in range(n))
    return ("cpu",) * n


def local_batch_slice(global_batch: int, rank_: Optional[int] = None,
                      world: Optional[int] = None) -> Tuple[int, int]:
    """The contiguous rows [lo, hi) of every global batch that rank
    ``rank_`` loads (JAX ``mesh.local_batch_slice``): the batch splits into
    ``world`` equal blocks in rank order; a batch that does not split
    raises."""
    r = rank() if rank_ is None else rank_
    w = world_size() if world is None else world
    if global_batch % w:
        raise ValueError(
            f"the batch size ({global_batch}) does not split over {w} "
            "ranks: make it a multiple of the rank count")
    per = global_batch // w
    return r * per, (r + 1) * per


def group_ranks(batch_size: int, requested: int) -> int:
    """Under a process group: the rank count of a train stage, which must
    be the group's world size (every rank holds rows of each batch). The
    largest count <= ``requested`` (0 = the world size) that divides the
    batch; another count than the world size raises, as JAX's
    ``local_batch_slice`` does for a process without rows."""
    w = world_size()
    n = max(d for d in range(1, (requested or w) + 1) if batch_size % d == 0)
    if n != w:
        raise ValueError(
            f"the batch size ({batch_size}) with mesh_data {requested} "
            f"gives {n} data ranks, but the group has {w} processes: every "
            "process must hold rows of each batch (make the batch a "
            "multiple of the process count)")
    return w


def rank_device(device, local_rank: int) -> torch.device:
    """A process rank's device: the CPU as given; ``cuda`` without an index
    is ``cuda:LOCAL_RANK`` (a local rank without a card raises); an
    explicit ``cuda:i`` stays, so several ranks may share one card."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if local_rank >= torch.cuda.device_count():
        raise ValueError(
            f"local rank {local_rank} has no card "
            f"({torch.cuda.device_count()} visible); pass --device cuda:i "
            "to put several ranks on one card")
    return torch.device("cuda", local_rank)


def init_process_group(init_method: Optional[str], world: int, rank_: int,
                       device, backend: Optional[str] = None,
                       timeout_s: float = DEFAULT_TIMEOUT_S,
                       store=None) -> None:
    """Join a process group on ``device`` (the default group of
    ``torch.distributed``), meeting at ``init_method`` or ``store``, and
    make its host group of the barriers."""
    global _HOST_GROUP
    dev = indexed(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or default_backend(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method, store=store,
                            world_size=world, rank=rank_, timeout=timeout)
    _HOST_GROUP = (dist.group.WORLD if backend == "gloo"
                   else dist.new_group(backend="gloo", timeout=timeout))


def destroy_process_group() -> None:
    global _HOST_GROUP
    if is_distributed():
        dist.destroy_process_group()
    _HOST_GROUP = None


def process_barrier(name: str,
                    timeout_s: Optional[float] = None) -> None:
    """Every rank waits here until all have arrived (JAX
    ``process_barrier``): a barrier of the host group, no device
    collective; a rank that does not arrive within the timeout (default:
    the group's) fails every other. No-op outside a process group."""
    if not is_distributed() or world_size() == 1:
        return
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    try:
        dist.monitored_barrier(group=_HOST_GROUP, wait_all_ranks=True, **kw)
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r} failed: {e}") from e


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over the group's ranks, in place (identity outside a
    group); the group's timeout bounds it."""
    if is_distributed() and dist.get_world_size(group) > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_reduce_mean(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` averaged over the group's ranks, in place: the sum over the
    ranks divided by their count."""
    if is_distributed() and dist.get_world_size(group) > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        t.div_(dist.get_world_size(group))
    return t


def fetch_replicated(model: torch.nn.Module) -> torch.nn.Module:
    """The trained model for rank 0's saves (JAX ``fetch_replicated``):
    DDP keeps every rank's parameters equal (the same initial values,
    broadcast from rank 0 at the wrap, and the same all-reduced gradients
    every step), so rank 0's own module holds the state; this unwraps
    DDP."""
    return getattr(model, "module", model)


def _sum_hook(process_group, bucket):
    """DDP comm hook: the bucket's gradients summed over the ranks (DDP's
    own hook divides the sum by the world size)."""
    group = process_group if process_group is not None else dist.group.WORLD
    work = dist.all_reduce(bucket.buffer(), group=group, async_op=True)
    return work.get_future().then(lambda fut: fut.value()[0])


def data_parallel(model: torch.nn.Module, trained: Sequence[torch.Tensor],
                  device, sum_gradients: bool) -> torch.nn.Module:
    """``model`` under DDP over the default group: the parameters outside
    ``trained`` (the optimizer's; the frozen backbone) stop requiring
    gradients, which they never receive, so DDP reduces only the trained
    ones; the buffers (frozen statistics, the displacement mean) are not
    broadcast; ``sum_gradients`` sums the ranks' gradients (a loss that
    already holds the global batch's denominators), else DDP averages them
    (a loss that is a mean over each rank's equal share)."""
    from torch.nn.parallel import DistributedDataParallel as DDP

    keep = {id(p) for p in trained}
    for p in model.parameters():
        if id(p) not in keep:
            p.requires_grad_(False)
    dev = indexed(device)
    # newer torch names broadcast_buffers=False forward_sync_buffers=False
    # (the buffers still meet at the wrap, where they are equal anyway)
    sync = ("forward_sync_buffers"
            if "forward_sync_buffers" in inspect.signature(DDP).parameters
            else "broadcast_buffers")
    ddp = DDP(model, device_ids=[dev.index] if dev.type == "cuda" else None,
              **{sync: False})
    if sum_gradients:
        ddp.register_comm_hook(None, _sum_hook)
    return ddp


def free_port() -> int:
    """A free TCP port on 127.0.0.1, for a coordinator address given to
    several processes of the CLI (``--dist_coordinator``)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(local_rank: int, fn: Callable, args: tuple, spec: RankSpec,
                port: int, out_dir: str, threads: int) -> None:
    """A spawned rank: join the group at the parent's store, run
    ``fn(*args, device)``, pickle its result to ``out_dir``."""
    torch.set_num_threads(threads)
    dev = indexed(spec.devices[local_rank])
    store = dist.TCPStore("127.0.0.1", port, is_master=False,
                          timeout=datetime.timedelta(seconds=spec.timeout_s))
    init_process_group(None, len(spec.devices), local_rank, dev,
                       spec.backend, spec.timeout_s, store=store)
    try:
        result = fn(*args, dev)
    finally:
        destroy_process_group()
    with open(os.path.join(out_dir, f"rank{local_rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_ranks(fn: Callable, args: Sequence[Any], spec: RankSpec,
              deadline_s: Optional[float] = None) -> List[Any]:
    """``fn(*args, device)`` on every rank of ``spec``; returns each rank's
    result in rank order. One rank joins a group of one in this process
    (DDP at world size 1); more ranks are spawned processes
    (``torch.multiprocessing``, start method spawn) meeting at a TCP store
    that this process serves on 127.0.0.1 (its port chosen by the system
    while it binds). A rank that raises ends the others and raises here;
    the group's timeout bounds every collective, and ``deadline_s`` (if
    given) the whole run."""
    if is_distributed():
        raise RuntimeError("run_ranks inside a process group")
    timeout = datetime.timedelta(seconds=spec.timeout_s)
    if len(spec.devices) == 1:
        dev = indexed(spec.devices[0])
        init_process_group(None, 1, 0, dev, spec.backend, spec.timeout_s,
                           store=dist.HashStore())
        try:
            return [fn(*args, dev)]
        finally:
            destroy_process_group()
    import torch.multiprocessing as mp

    server = dist.TCPStore("127.0.0.1", 0, is_master=True, timeout=timeout,
                           wait_for_workers=False)
    with tempfile.TemporaryDirectory(prefix="irn_ranks_") as out_dir:
        ctx = mp.start_processes(
            _rank_entry, nprocs=len(spec.devices), join=False,
            start_method="spawn",
            args=(fn, tuple(args), spec, server.port, out_dir,
                  torch.get_num_threads()))
        t0 = time.monotonic()
        while not ctx.join(timeout=0.5):
            if deadline_s is not None and time.monotonic() - t0 > deadline_s:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                for p in ctx.processes:
                    p.join(10)
                raise TimeoutError(f"{len(spec.devices)} ranks did not end "
                                   f"within {deadline_s} s")
        results = []
        for r in range(len(spec.devices)):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
