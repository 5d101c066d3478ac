"""Text progress bar on stderr (port of `rnnpose_tpu/utils/progress.py`)."""
from __future__ import annotations

import sys
import time

__all__ = ["ProgressBar"]


class ProgressBar:
    def __init__(self, total: int | None = None, width: int = 40):
        self.total = total
        self.width = width
        self.start = time.time()

    def update(self, n: int):
        elapsed = time.time() - self.start
        rate = n / max(elapsed, 1e-9)
        if self.total:
            frac = min(n / self.total, 1.0)
            filled = int(self.width * frac)
            bar = "#" * filled + "-" * (self.width - filled)
            msg = f"\r[{bar}] {n}/{self.total} ({rate:.1f}/s)"
        else:
            msg = f"\r{n} done ({rate:.1f}/s)"
        sys.stderr.write(msg)
        sys.stderr.flush()

    def finish(self):
        sys.stderr.write("\n")
