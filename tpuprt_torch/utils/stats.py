"""Stats registry: (category, name) counters printed as a table (a copy of
tpuprt/utils/stats.py), and the renderer's stage spans.

The reference's statistics (core/pbrt.h:291-321, core/util.cpp:186-285):
counters and ratios merged by (category, name) and printed after the
render with its K/M/B suffixes (core/util.cpp:228-262). The render drivers
add their counts here once a render, after its last pass or chunk.

Spans: `span(name)` marks a stage of the renderer (camera, intersect,
shadow, shade, light, film) and `span("sync")` each place where the host
waits for the device. While `active(stats)` holds a registry (render()
holds the one it is given), each span's self time, its duration less that
of the spans opened inside it, is summed on the host clock; when the block
ends the registry receives, under category "Spans", "<name> ms" and
"<name> calls" of each span ("syncs" for the sync span), so the stages
partition the whole render ("frame"). While a torch profiler runs, each
span is also a `record_function` range "tpuprt/<name>" on the profiler's
clock. With neither, a span is one shared null context.
"""
from __future__ import annotations

import contextlib
import contextvars
import sys
import time
from collections import OrderedDict

import torch


def _suffixed(v: float) -> str:
    """K/M/B formatting as in StatsPrintVal (core/util.cpp:228-246)."""
    if v != int(v):
        return f"{v:.3f}"
    v = int(v)
    if v >= 1_000_000_000:
        return f"{v / 1e9:.3f}B"
    if v >= 1_000_000:
        return f"{v / 1e6:.3f}M"
    if v >= 1_000:
        return f"{v / 1e3:.3f}K"
    return str(v)


class StatsRegistry:
    """Counters and ratios keyed by (category, name), as StatsCounter and
    StatsRatio (core/pbrt.h:291-321)."""

    def __init__(self):
        self._counters: OrderedDict[tuple, float] = OrderedDict()
        self._ratios: OrderedDict[tuple, list] = OrderedDict()

    def add(self, category: str, name: str, amount: float = 1.0):
        key = (category, name)
        self._counters[key] = self._counters.get(key, 0.0) + float(amount)

    def add_ratio(self, category: str, name: str, num: float, denom: float):
        cur = self._ratios.setdefault((category, name), [0.0, 0.0])
        cur[0] += float(num)
        cur[1] += float(denom)

    def merge(self, other: "StatsRegistry"):
        for k, v in other._counters.items():
            self._counters[k] = self._counters.get(k, 0.0) + v
        for k, (n, d) in other._ratios.items():
            self.add_ratio(k[0], k[1], n, d)

    def get(self, category: str, name: str) -> float:
        return self._counters.get((category, name), 0.0)

    def items(self):
        """((category, name), value) of every counter, in the order added."""
        return self._counters.items()

    def format_table(self) -> str:
        """StatsPrint's layout (core/util.cpp:248-285): grouped by
        category, names aligned, values suffixed."""
        by_cat: OrderedDict[str, list] = OrderedDict()
        for (cat, name), v in self._counters.items():
            by_cat.setdefault(cat, []).append((name, _suffixed(v)))
        for (cat, name), (n, d) in self._ratios.items():
            val = f"{_suffixed(n)}:{_suffixed(d)} ({n / d:.2f}x)" if d \
                else "0:0"
            by_cat.setdefault(cat, []).append((name, val))
        lines = ["Statistics:"]
        for cat, items in by_cat.items():
            lines.append(f"    {cat}")
            width = max(len(n) for n, _ in items)
            for name, val in items:
                lines.append(f"        {name:<{width}}  {val}")
        return "\n".join(lines)

    def print(self, file=None):
        print(self.format_table(), file=file or sys.stdout)


# The timing of the registry active in this context, or None.
_ACTIVE = contextvars.ContextVar("tpuprt_torch_stats_active", default=None)
_NULL = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


class _Timing:
    """The spans' sums (name -> [self ns, calls]) for one active registry,
    and the stack of its open spans."""
    __slots__ = ("stats", "sums", "open")

    def __init__(self, stats: StatsRegistry):
        self.stats, self.sums, self.open = stats, {}, []

    def flush(self):
        for name, (ns, calls) in self.sums.items():
            self.stats.add("Spans", f"{name} ms", ns * 1e-6)
            self.stats.add("Spans", "syncs" if name == "sync" else
                           f"{name} calls", calls)


@contextlib.contextmanager
def active(stats: StatsRegistry | None):
    """Make `stats` the registry that spans feed for the block (None: no
    registry); its "Spans" counters are added when the block ends."""
    timing = None if stats is None else _Timing(stats)
    token = _ACTIVE.set(timing)
    try:
        yield
    finally:
        _ACTIVE.reset(token)
        if timing is not None:
            timing.flush()


class _Span:
    __slots__ = ("name", "timing", "range", "t0", "child")

    def __init__(self, name, timing, profiling):
        self.name, self.timing, self.child = name, timing, 0
        self.range = torch.profiler.record_function(f"tpuprt/{name}") \
            if profiling else None

    def __enter__(self):
        if self.range is not None:
            self.range.__enter__()
        if self.timing is not None:
            self.timing.open.append(self)
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        timing = self.timing
        if timing is not None:
            dt = time.perf_counter_ns() - self.t0
            timing.open.pop()
            if timing.open:
                timing.open[-1].child += dt
            acc = timing.sums.setdefault(self.name, [0, 0])
            acc[0] += dt - self.child
            acc[1] += 1
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """A stage span (the module's docstring): times `name` into the active
    registry and/or opens a profiler range; a shared null context when
    there is neither."""
    timing = _ACTIVE.get()
    profiling = _profiling()
    if timing is None and not profiling:
        return _NULL
    return _Span(name, timing, profiling)
