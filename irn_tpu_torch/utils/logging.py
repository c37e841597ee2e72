"""Logging, metering and timing for the port's CLI: the port's own copy of
``Logger``, ``AverageMeter`` and ``Timer`` from ``irn_tpu.utils.logging``
(the capabilities of the reference's misc/pyutils.py), and
``DeviceMeter`` over torch scalars. ``Logger`` tees stdout into a file;
``AverageMeter`` keeps windowed means of host numbers; ``DeviceMeter``
keeps device scalars and syncs only when a mean is asked for; ``Timer``
measures a stage's elapsed time and estimates its end."""

from __future__ import annotations

import sys
import time
from typing import Dict


class Logger:
    """Tee stdout into a log file. Install once per process."""

    def __init__(self, outfile: str):
        self.terminal = sys.stdout
        self.log = open(outfile, "w")
        sys.stdout = self

    def write(self, message: str):
        self.terminal.write(message)
        self.log.write(message)

    def flush(self):
        self.terminal.flush()
        self.log.flush()

    def close(self):
        sys.stdout = self.terminal
        self.log.close()


class AverageMeter:
    def __init__(self, *keys: str):
        self._data: Dict[str, list] = {k: [0.0, 0] for k in keys}

    def add(self, values: Dict[str, float]):
        for k, v in values.items():
            acc = self._data.setdefault(k, [0.0, 0])
            acc[0] += float(v)
            acc[1] += 1

    def get(self, key: str) -> float:
        total, count = self._data[key]
        return total / max(count, 1)

    def pop(self, key: str | None = None):
        if key is None:
            for k in self._data:
                self._data[k] = [0.0, 0]
            return None
        v = self.get(key)
        self._data[key] = [0.0, 0]
        return v


class DeviceMeter:
    """AverageMeter over device scalars: the values stay on the device
    until a windowed mean is asked for, so a train loop syncs once per log
    interval, never once per step."""

    def __init__(self):
        self._data: Dict[str, list] = {}

    def add(self, values: Dict):
        for k, v in values.items():
            self._data.setdefault(k, []).append(v)

    def pop(self, key: str) -> float:
        vals = self._data.get(key, [])
        self._data[key] = []
        if not vals:
            return 0.0
        import torch

        return float(torch.stack([torch.as_tensor(v) for v in vals]).mean())


class Timer:
    def __init__(self, starting_msg: str | None = None):
        self.start = time.time()
        self.stage_start = self.start
        self.est_finish = self.start
        if starting_msg:
            print(starting_msg, time.ctime(self.start))

    def update_progress(self, progress: float):
        elapsed = time.time() - self.start
        est_total = elapsed / max(progress, 1e-9)
        self.est_finish = int(self.start + est_total)

    def str_estimated_complete(self) -> str:
        return str(time.ctime(self.est_finish))

    def get_stage_elapsed(self) -> float:
        return time.time() - self.stage_start

    def reset_stage(self):
        self.stage_start = time.time()

    def lapse(self) -> float:
        out = time.time() - self.stage_start
        self.stage_start = time.time()
        return out
