"""Run logging: timestamped stdout + append-to-file, the reference
print_log (main.py:359-366)."""

from __future__ import annotations

import os
import time


class RunLogger:
    """``echo=False`` keeps a rank other than the first of a
    multi-process run quiet."""

    def __init__(self, work_dir: str, *, to_file: bool = True,
                 echo: bool = True):
        self.work_dir = work_dir
        self.to_file = to_file
        self.echo = echo
        os.makedirs(work_dir, exist_ok=True)

    def log(self, msg: str, *, timestamp: bool = True) -> None:
        if not self.echo:
            return
        if timestamp:
            msg = f"[ {time.asctime()} ] {msg}"
        print(msg, flush=True)
        if self.to_file:
            with open(os.path.join(self.work_dir, "log.txt"), "a") as f:
                print(msg, file=f)
