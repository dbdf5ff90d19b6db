"""Stats registry: (category, name) counters printed as a table (a copy of
tpuprt/utils/stats.py).

The reference's statistics (core/pbrt.h:291-321, core/util.cpp:186-285):
counters and ratios merged by (category, name) and printed after the
render with its K/M/B suffixes (core/util.cpp:228-262). The render drivers
add their counts here once a render, after its last pass or chunk.
"""
from __future__ import annotations

import sys
from collections import OrderedDict


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
