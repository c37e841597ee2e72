"""Measurement tools of the port, the counterparts of the JAX package's
``tools/``: ``bench_banded`` (the banded random-walk sweeps, K8's entry
point) and ``bench_conv`` (the 3x3 conv probe, K9's entry point); and
``bench_chains``, the chains over the band tiles (K3, K7, K8) timed on the
card at the smoke run's shapes, from this tree or another.

``bench_banded`` and ``bench_conv`` take ``--device`` (default ``cuda``).
A missing card raises; nothing falls back to the CPU. On the CPU those two
run the kernels' plain twins and time them on the host clock, which says
nothing about the card; ``bench_chains`` runs on the card only.
"""

from __future__ import annotations

import subprocess
import time

import torch


def resolve_device(name: str) -> torch.device:
    """``torch.device(name)``; a CUDA device without a card raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"--device {name}: cuda or cpu")
    return dev


def device_label(dev: torch.device) -> str:
    """What the numbers were measured on: the card's name and power limit
    as nvidia-smi gives them, or the host for the CPU."""
    if dev.type != "cuda":
        return "cpu: plain twins, host clock, not a device time"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[dev.index or 0]


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_ms(dev: torch.device, fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of ``fn``: CUDA events on the card, the
    host clock on the CPU; ``warmup`` calls first."""
    for _ in range(warmup):
        fn()
    sync(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps
