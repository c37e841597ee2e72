"""Pipeline CLI of the port: the flags of ``irn_tpu.pipeline.run`` (one
flag per field of the port's copy of ``Config``, built the same way; the
same artifacts) plus ``--device`` (default ``cuda``).

Usage:
    python -m irn_tpu_torch.pipeline.run --voc12_root <VOC2012> \
        --train_list <ids.txt> --infer_list <ids.txt> --make_cam_pass \
        --eval_cam_pass --cam_to_ir_label_pass --train_irn_pass \
        --make_sem_seg_pass --eval_sem_seg_pass --make_ins_seg_pass \
        --eval_ins_seg_pass --make_cocoann_pass [--device cuda|cpu]

All ten stages are ported (``--train_cam_pass`` too). A flag whose code
path is not ported (``--sem_monolith`` among a few others, and
``--rw_matmul_dtype bfloat16`` on the single-device banded route with
0 < ``--rw_square_times`` < ``--exp_times``, whose application chain has no
bf16 mode yet) raises ``NotImplementedError`` naming the ROADMAP item that
ports it, so nothing is skipped silently. ``--rw_matmul_dtype bfloat16``
runs every other walk route: the default stencil (no product), pure
squaring, ``--exp_times`` = ``--rw_square_times`` on the banded route, the
dense routes and the mesh routes.

``--rw_mesh_model k`` splits each image's random walk in make_sem_seg and
make_ins_seg over k devices of this process (the CPU k times with
``--device cpu``; else the first k visible cards, or k from a rank's own),
one image at a time (``--infer_devices`` is then ignored).

Several processes: one process per rank, each on one card. ``torchrun
--nproc_per_node N -m irn_tpu_torch.pipeline.run --dist_initialize ...``
(``env://``), or N processes given ``--dist_coordinator host:port
--dist_num_processes N --dist_process_id r`` (``tcp://``; rank 0 hosts the
store). ``--device cuda`` is ``cuda:LOCAL_RANK`` in each (``cuda:i``
pins a card). The train stages run data-parallel over the ranks (DDP);
the make stages write a strided share of the images each, and a barrier
ends every stage; eval_cam, eval_sem_seg, eval_ins_seg and make_cocoann
run on rank 0 alone (the JAX package runs them on every process). Rank
r > 0 logs to ``<log_name>.p<r>.log``."""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import os
from typing import Dict, Optional, Sequence

import torch

from irn_tpu_torch.parallel import mesh
from irn_tpu_torch.pipeline.config import Config
from irn_tpu_torch.utils.logging import Logger, Timer

# flag -> (module, function(cfg, device)) of the port
STAGES = [
    ("train_cam_pass", ("irn_tpu_torch.pipeline.stages_cam", "train_cam")),
    ("make_cam_pass", ("irn_tpu_torch.pipeline.stages_cam", "make_cam")),
    ("eval_cam_pass", ("irn_tpu_torch.pipeline.stages_cam", "eval_cam")),
    ("cam_to_ir_label_pass",
     ("irn_tpu_torch.pipeline.stages_cam", "cam_to_ir_label")),
    ("train_irn_pass", ("irn_tpu_torch.pipeline.stages_irn", "train_irn")),
    ("make_ins_seg_pass",
     ("irn_tpu_torch.pipeline.stages_irn", "make_ins_seg_labels")),
    ("eval_ins_seg_pass",
     ("irn_tpu_torch.pipeline.stages_eval", "eval_ins_seg")),
    ("make_sem_seg_pass",
     ("irn_tpu_torch.pipeline.stages_irn", "make_sem_seg_labels")),
    ("eval_sem_seg_pass",
     ("irn_tpu_torch.pipeline.stages_eval", "eval_sem_seg")),
    ("make_cocoann_pass",
     ("irn_tpu_torch.pipeline.stages_eval", "make_cocoann")),
]

# stages that read every rank's outputs: rank 0 alone runs them
RANK0_STAGES = ("eval_cam", "eval_sem_seg", "eval_ins_seg", "make_cocoann")


def _add_flag(parser: argparse.ArgumentParser, name: str, field) -> None:
    """One flag per Config field, typed from its annotation, as
    ``irn_tpu.pipeline.run._add_flag``."""
    t = field.type if isinstance(field.type, str) else getattr(
        field.type, "__name__", "str"
    )
    if t == "bool":
        parser.add_argument(
            f"--{name}", action=argparse.BooleanOptionalAction,
            default=field.default,
        )
    elif name == "cam_scales":
        parser.add_argument(
            f"--{name}", type=float, nargs="+", default=list(field.default)
        )
    else:
        ftype = {"int": int, "float": float}.get(t, str)
        parser.add_argument(f"--{name}", type=ftype, default=field.default)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="irn_tpu_torch pipeline", allow_abbrev=False
    )
    for f in dataclasses.fields(Config):
        _add_flag(parser, f.name, f)
    parser.add_argument("--device", default="cuda",
                        help="torch device for every stage (cuda | cpu)")
    return parser


def parse(argv: Optional[Sequence[str]] = None):
    """(Config, device) from the command line."""
    kw = vars(build_parser().parse_args(argv))
    device = kw.pop("device")
    kw["cam_scales"] = tuple(kw["cam_scales"])
    return Config(**kw).resolve(), device


def maybe_init_distributed(cfg: Config, device: str) -> torch.device:
    """Join the process group when configured (JAX
    ``maybe_init_distributed``) and return this process's device.

    ``--dist_coordinator host:port`` is ``tcp://host:port`` with the world
    size ``--dist_num_processes`` and the rank ``--dist_process_id``
    (either from torchrun's WORLD_SIZE / RANK when unset); else
    ``--dist_initialize`` is ``env://`` (torchrun's variables). The local
    rank is LOCAL_RANK, else the rank. No group is joined otherwise."""
    if not (cfg.dist_initialize or cfg.dist_coordinator):
        return torch.device(device)
    world = cfg.dist_num_processes or int(os.environ.get("WORLD_SIZE", 0))
    rank = (cfg.dist_process_id if cfg.dist_process_id >= 0
            else int(os.environ.get("RANK", -1)))
    if cfg.dist_coordinator:
        init = f"tcp://{cfg.dist_coordinator}"
        if world < 1 or not 0 <= rank < world:
            raise ValueError(
                f"--dist_coordinator needs the world size and this rank "
                f"(--dist_num_processes, --dist_process_id or WORLD_SIZE / "
                f"RANK): got {world} and {rank}")
    else:
        init = "env://"
    local_rank = int(os.environ.get("LOCAL_RANK", max(rank, 0)))
    dev = mesh.rank_device(device, local_rank)
    mesh.init_process_group(init, world if world > 0 else -1, rank, dev)
    print(f"distributed: rank {mesh.rank()}/{mesh.world_size()} on {dev} "
          f"({torch.distributed.get_backend()})", flush=True)
    return dev


def run_pipeline(cfg: Config, device) -> Dict:
    """Create the session and output directories, as
    ``irn_tpu.pipeline.run.run_pipeline`` does, then run the enabled stages
    in the reference's order; returns each stage's result by function
    name. In a process group a barrier ends every stage, and the stages of
    :data:`RANK0_STAGES` run on rank 0 alone (None elsewhere)."""
    os.makedirs(cfg.session_dir, exist_ok=True)
    for d in (cfg.cam_out_dir, cfg.ir_label_out_dir, cfg.sem_seg_out_dir,
              cfg.ins_seg_out_dir):
        os.makedirs(d, exist_ok=True)
    results = {}
    for flag, target in STAGES:
        if not getattr(cfg, flag):
            continue
        module_name, fn_name = target
        fn = getattr(importlib.import_module(module_name), fn_name)
        print(f"step.{fn_name}:", flush=True)
        timer = Timer()
        if fn_name in RANK0_STAGES and not mesh.is_main():
            results[fn_name] = None
        else:
            results[fn_name] = fn(cfg, device)
        mesh.process_barrier(f"step.{fn_name}")
        print(f"step.{fn_name} done in {timer.lapse():.1f}s", flush=True)
    return results


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    cfg, device = parse(argv)
    dev = maybe_init_distributed(cfg, device)
    log_name = cfg.log_name
    if mesh.rank() > 0:  # one log file per process
        log_name = f"{log_name}.p{mesh.rank()}"
    try:
        logger = Logger(log_name + ".log")
        try:
            print(dict(dataclasses.asdict(cfg), device=str(dev)))
            return run_pipeline(cfg, dev if mesh.is_distributed() else device)
        finally:
            logger.close()
    finally:
        mesh.destroy_process_group()


if __name__ == "__main__":
    main()
