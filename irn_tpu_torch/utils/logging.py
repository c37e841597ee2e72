"""Logging and timing for the port's CLI: the port's own copy of
``Logger`` and ``Timer`` from ``irn_tpu.utils.logging`` (the capabilities
of the reference's misc/pyutils.py). ``Logger`` tees stdout into a file;
``Timer`` measures a stage's elapsed time."""

from __future__ import annotations

import sys
import time


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


class Timer:
    def __init__(self, starting_msg: str | None = None):
        self.start = time.time()
        self.stage_start = self.start
        if starting_msg:
            print(starting_msg, time.ctime(self.start))

    def get_stage_elapsed(self) -> float:
        return time.time() - self.stage_start

    def reset_stage(self):
        self.stage_start = time.time()

    def lapse(self) -> float:
        out = time.time() - self.stage_start
        self.stage_start = time.time()
        return out
