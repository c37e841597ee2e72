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
path is not ported (multi-GPU, bf16 models) raises ``NotImplementedError``
naming the ROADMAP item that ports it, so nothing is skipped silently."""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import os
from typing import Dict, Optional, Sequence

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


def run_pipeline(cfg: Config, device: str) -> Dict:
    """Create the session and output directories, as
    ``irn_tpu.pipeline.run.run_pipeline`` does, then run the enabled stages
    in the reference's order; returns each stage's result by function
    name."""
    os.makedirs(cfg.session_dir, exist_ok=True)
    for d in (cfg.cam_out_dir, cfg.ir_label_out_dir, cfg.sem_seg_out_dir,
              cfg.ins_seg_out_dir):
        os.makedirs(d, exist_ok=True)
    if cfg.dist_initialize or cfg.dist_coordinator:
        raise NotImplementedError(
            "multi-process runs are ROADMAP queue 1 item 10 (Multi-GPU)"
        )
    results = {}
    for flag, target in STAGES:
        if not getattr(cfg, flag):
            continue
        module_name, fn_name = target
        fn = getattr(importlib.import_module(module_name), fn_name)
        print(f"step.{fn_name}:", flush=True)
        timer = Timer()
        results[fn_name] = fn(cfg, device)
        print(f"step.{fn_name} done in {timer.lapse():.1f}s", flush=True)
    return results


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    cfg, device = parse(argv)
    logger = Logger(cfg.log_name + ".log")
    try:
        print(dict(dataclasses.asdict(cfg), device=device))
        return run_pipeline(cfg, device)
    finally:
        logger.close()


if __name__ == "__main__":
    main()
