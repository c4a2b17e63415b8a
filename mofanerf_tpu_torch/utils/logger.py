"""Append-only training log with iteration recovery (counterpart of
mofanerf_tpu/utils/logger.py): `Iteration <n>` lines with metrics, `#`
notes, and a resume marker when the log already exists."""
from __future__ import annotations

import os
import re
import time


class TrainLogger:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        if os.path.exists(path):
            with open(path, "a") as f:
                f.write(f"# resumed at {time.strftime('%Y-%m-%d %H:%M:%S')}\n")

    def last_iteration(self) -> int:
        if not os.path.exists(self.path):
            return 0
        last = 0
        with open(self.path) as f:
            for line in f:
                m = re.search(r"Iteration (\d+)", line)
                if m:
                    last = int(m.group(1))
        return last

    def write(self, step: int, **metrics) -> None:
        parts = " ".join(f"{k}: {v}" for k, v in metrics.items())
        with open(self.path, "a") as f:
            f.write(f"Iteration {step} {parts}\n")

    def note(self, msg: str) -> None:
        with open(self.path, "a") as f:
            f.write(f"# {msg}\n")
