"""Profiler trace capture inside a stage — the counterpart of
``irn_tpu.utils.profiling.StageProfiler`` on ``torch.profiler``.

A short window of steps [start, stop) is traced into
``<profile_dir>/<stage>`` as a ``*.pt.trace.json`` file (Chrome trace
format: TensorBoard's profiler plugin and Perfetto load it). Enabled by
``Config.profile_dir``; with none set, :meth:`StageProfiler.tick` does
nothing."""

from __future__ import annotations

import os
from typing import Optional

import torch


class StageProfiler:
    """Call :meth:`tick` once per step and :meth:`close` after the loop
    (it ends a window the loop left open). The host's activity is traced,
    and the card's when ``device`` is a CUDA device."""

    def __init__(self, profile_dir: Optional[str], stage: str,
                 start: int = 2, stop: int = 5, device=None):
        self.dir = os.path.join(profile_dir, stage) if profile_dir else None
        self.start = start
        self.stop = stop
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self._count = 0
        self._prof = None

    def tick(self) -> None:
        """Call once per step."""
        if self.dir is None:
            return
        if self._count == self.start and self._prof is None:
            os.makedirs(self.dir, exist_ok=True)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(
                activities=acts,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    self.dir))
            self._prof.start()
        elif self._count == self.stop:
            self.close()
        self._count += 1

    def close(self) -> None:
        """End an open window and write its trace; idempotent."""
        if self._prof is not None:
            prof, self._prof = self._prof, None
            prof.stop()
