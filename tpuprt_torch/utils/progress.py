"""Progress reporting with elapsed time and ETA (a copy of
tpuprt/utils/progress.py).

ProgressReporter (core/util.cpp:396-448): a '+' bar updated per unit of
work, with the elapsed seconds and an ETA. The pool counts camera samples
started, the chunked driver chunks.
"""
from __future__ import annotations

import sys
import time


class ProgressReporter:
    def __init__(self, total_work: int, title: str, bar_length: int = 48,
                 out=None):
        self.total = max(1, int(total_work))
        self.title = title
        self.bar_length = bar_length
        self.done_work = 0
        self.start = time.time()
        self.out = out or sys.stderr
        self._draw()

    def update(self, num: int = 1):
        self.done_work += num
        self._draw()

    def _draw(self):
        frac = min(1.0, self.done_work / self.total)
        plusses = int(round(frac * self.bar_length))
        elapsed = time.time() - self.start
        eta = elapsed / frac - elapsed if frac > 0 else 0.0
        bar = "+" * plusses + " " * (self.bar_length - plusses)
        self.out.write(f"\r{self.title}: [{bar}] "
                       f"({elapsed:.1f}s|{eta:.1f}s)  ")
        self.out.flush()

    def done(self):
        self.done_work = self.total
        self._draw()
        self.out.write("\n")
        self.out.flush()
