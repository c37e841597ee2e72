"""Model initialisation shared by the port's stages — the counterpart of
``irn_tpu.pipeline.common``'s ``load_backbone_variables`` and
``init_model_variables`` — the numerics every model stage pins, and the
make stages' spread over processes (:func:`host_shard_range`) and over the
devices of one process (:class:`DeviceSpreader`)."""

from __future__ import annotations

import contextlib
import threading
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from irn_tpu_torch.models.irn import init_irnet
from irn_tpu_torch.parallel import mesh
from irn_tpu_torch.pipeline.config import Config
from irn_tpu_torch.utils import checkpoint as ckpt
from irn_tpu_torch.utils import weights as W

INIT_SEED = 0

# --model_dtype values the port runs, as torch dtypes
MODEL_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# --rw_matmul_dtype values, as the walk's ``matmul_dtype`` (None: f32
# operands)
RW_MATMUL_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def model_dtype(cfg: Config) -> torch.dtype:
    """The backbone's compute dtype of ``cfg.model_dtype`` (the JAX stages'
    ``jnp.dtype(cfg.model_dtype)``); any other value than the two ported
    raises (ROADMAP queue 1: ``float16`` is refused)."""
    if cfg.model_dtype not in MODEL_DTYPES:
        raise NotImplementedError(
            f"model_dtype={cfg.model_dtype!r}: the port runs "
            f"{' and '.join(map(repr, MODEL_DTYPES))}")
    return MODEL_DTYPES[cfg.model_dtype]


def rw_matmul_dtype(cfg: Config) -> Optional[torch.dtype]:
    """The walk's operand dtype of ``cfg.rw_matmul_dtype`` (the JAX
    ``Config.rw_matmul_jnp_dtype``): None for float32, ``torch.bfloat16``;
    any other value raises."""
    if cfg.rw_matmul_dtype not in RW_MATMUL_DTYPES:
        raise ValueError(
            f"rw_matmul_dtype={cfg.rw_matmul_dtype!r}: "
            f"{' or '.join(map(repr, RW_MATMUL_DTYPES))}")
    return RW_MATMUL_DTYPES[cfg.rw_matmul_dtype]


def pin_numerics() -> None:
    """The reference's convolutions and products accumulate in f32: no TF32
    convolution or matmul, and no cuBLAS reduction in bf16 (a bf16
    backbone's convolutions are cuDNN's bf16 kernels, which accumulate in
    f32)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def load_backbone_variables(cfg: Config) -> Optional[Dict]:
    """Pretrained ResNet-50 variables (``{'params', 'stats'}``, the JAX
    layout) from cfg.pretrained_backbone: a torch ``.pth`` state dict is
    converted, anything else read as a numpy pickle. None when unset."""
    path = cfg.pretrained_backbone
    if not path:
        return None
    if path.endswith(".pth"):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        return W.convert_resnet50(sd)
    return ckpt.load_checkpoint(path)


def init_model_variables(model: torch.nn.Module, cfg: Config,
                         generator: Optional[torch.Generator] = None,
                         backbone_key: str = "resnet50") -> torch.nn.Module:
    """Seeded random init (``generator``, default seed 0), then the
    pretrained backbone grafted in; warns when none is configured."""
    init_irnet(model, generator or torch.Generator().manual_seed(INIT_SEED))
    pretrained = load_backbone_variables(cfg)
    if pretrained is not None:
        sd = W.resnet50_from_jax(pretrained["params"], pretrained["stats"],
                                 prefix=backbone_key + ".")
        result = model.load_state_dict(sd, strict=False)
        missing = [k for k in result.missing_keys
                   if k.startswith(backbone_key + ".")]
        if missing or result.unexpected_keys:
            raise ValueError(f"{cfg.pretrained_backbone}: backbone keys "
                             f"missing {missing[:4]}, unexpected "
                             f"{result.unexpected_keys[:4]}")
    else:
        print(
            "WARNING: no pretrained_backbone configured - the backbone is "
            "randomly initialized; pseudo-label quality will not match the "
            "reference (which always starts from ImageNet weights, "
            "net/resnet50.py:115)."
        )
    return model


def host_shard_range(n: int) -> range:
    """This rank's strided share of range(n) (JAX ``host_shard_range``;
    the reference's ``split_dataset``): range(rank, n, world), all of it
    outside a process group."""
    return range(mesh.rank(), n, mesh.world_size())


def shard_blocks(blocks: Sequence, name: str) -> List:
    """This rank's strided share of a stage's work ``blocks`` (each a
    forward's batch of images), after a barrier: every rank lists the
    work still to do before any rank writes, so all ranks see the same
    list, and each forward's batch is the one-process run's."""
    mesh.process_barrier(f"{name}.listed")
    return [blocks[c] for c in host_shard_range(len(blocks))]


def spread_devices(device, n_devices: int = 0,
                   flag: str = "infer_devices") -> List[torch.device]:
    """The devices of :class:`DeviceSpreader` for ``--infer_devices`` (or
    of the walk's mesh for ``--rw_mesh_model``, the ``flag`` that errors
    name): on the CPU, the CPU (n times when n > 1 is asked for); on CUDA
    outside a process group, the first n visible cards (0: every card, or
    the one ``device`` names); in a group, n cards from the rank's own (0:
    the rank's card alone). More cards than are visible raise."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev] * max(n_devices, 1)
    count = torch.cuda.device_count()
    if n_devices > count:
        raise ValueError(f"{flag} {n_devices}: {count} CUDA "
                         "device(s) visible")
    if mesh.is_distributed():
        base = dev.index if dev.index is not None else 0
        return [torch.device("cuda", (base + j) % count)
                for j in range(max(n_devices, 1))]
    if n_devices:
        return [torch.device("cuda", i) for i in range(n_devices)]
    if dev.index is not None:
        return [dev]
    return [torch.device("cuda", i) for i in range(count)]


class DeviceSpreader:
    """Round-robin placement of a make stage's blocks over devices (JAX
    ``DeviceSpreader``; the reference's one process per GPU): block c goes
    to worker c % n. Each worker has its own device, its own CUDA stream
    and its own copies of the stage's runners and models (:meth:`setup`),
    and runs its blocks on a thread of its own (:meth:`run`), so the
    launches of several workers interleave on one card or spread over
    several. ``devices`` lists the workers' devices (a device may repeat:
    two workers on one card, or on the CPU). A single worker can run
    inline (``inline``), on the calling thread and its current stream.
    ``assigned`` counts the blocks each worker took (keyed by worker
    index; thread-safe)."""

    def __init__(self, devices: Sequence, inline: bool = False):
        self.devices = [mesh.indexed(d) for d in devices]
        if not self.devices:
            raise ValueError("DeviceSpreader: no devices")
        if inline and len(self.devices) > 1:
            raise ValueError("DeviceSpreader: inline needs one worker")
        self.inline = inline
        self.assigned = Counter({w: 0 for w in range(len(self.devices))})
        self.streams = [
            torch.cuda.Stream(d) if d.type == "cuda" and not inline else None
            for d in self.devices]
        self.contexts: List[Any] = []

    def __len__(self) -> int:
        return len(self.devices)

    def __call__(self, c: int) -> int:
        """The worker of block c (counted)."""
        w = c % len(self.devices)
        self.assigned.update([w])  # atomic, unlike a dict read-modify-write
        return w

    def taken(self) -> List[int]:
        """The blocks each worker took, in worker order."""
        return [self.assigned[w] for w in range(len(self.devices))]

    def _scope(self, w: int) -> contextlib.ExitStack:
        """Worker w's device and stream made current."""
        scope = contextlib.ExitStack()
        dev = self.devices[w]
        if dev.type == "cuda":
            scope.enter_context(torch.cuda.device(dev))
            if self.streams[w] is not None:
                scope.enter_context(torch.cuda.stream(self.streams[w]))
        return scope

    def setup(self, make: Callable[[torch.device], Any]) -> List[Any]:
        """Each worker's context, ``make(device)`` under its device and
        stream (its models and runners)."""
        self.contexts = []
        for w, dev in enumerate(self.devices):
            with self._scope(w):
                self.contexts.append(make(dev))
        return self.contexts

    def run(self, blocks: Sequence, work: Callable[[Any, int, Any], None],
            done: Optional[Callable[[Any], None]] = None) -> List[Any]:
        """``work(ctx, c, blocks[c])`` for every block on its worker, then
        ``done(ctx)`` there (finish queued work), each worker on a thread
        of its own under its device and stream, whose work is finished on
        return; returns the contexts. The first worker's exception stops
        the others at their next block and is raised here."""
        n = len(self.devices)
        errors: List[BaseException] = []
        stop = threading.Event()

        def loop(w: int) -> None:
            try:
                with self._scope(w):
                    for c in range(w, len(blocks), n):
                        if stop.is_set():
                            return
                        self(c)
                        work(self.contexts[w], c, blocks[c])
                    if done is not None:
                        done(self.contexts[w])
                    if self.streams[w] is not None:
                        self.streams[w].synchronize()
            except BaseException as exc:  # re-raised by the caller
                errors.append(exc)
                stop.set()

        if self.inline:
            loop(0)
        else:
            threads = [threading.Thread(target=loop, args=(w,), daemon=True,
                                        name=f"spread-{w}")
                       for w in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        if errors:
            raise errors[0]
        return self.contexts


def make_spreader(device, n_devices: int = 0,
                  devices: Optional[Sequence] = None) -> DeviceSpreader:
    """The stage's spreader: over ``devices`` when given (a worker thread
    each), else over :func:`spread_devices`, where a single device runs
    inline."""
    if devices is not None:
        return DeviceSpreader(devices)
    found = spread_devices(device, n_devices)
    return DeviceSpreader(found, inline=len(found) == 1)
