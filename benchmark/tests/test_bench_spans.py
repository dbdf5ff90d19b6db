"""The renderer's stage-span metrics on the CPU: a --trace 1 run of each
bench3 cell on a crop of the film prints all nine, finite and in range."""
import math

import pytest

from harness import registry
from test_bench_harness import run_cpu

STAGES = ("camera", "intersect", "shadow", "shade", "light", "film")
NAMES = [f"host_ms.{s}" for s in STAGES] + \
    ["sync_wait_ms", "host_syncs.render", "span_cover.render"]


@pytest.mark.parametrize("cell", ["bench3.pool", "bench3.scan"])
def test_traced_run_prints_the_span_metrics(cell):
    b = registry.benchmark()
    assert {m["name"] for m in registry.metrics_for(b, cell, True)} >= \
        set(NAMES)
    rc, res, _ = run_cpu(cell, trace_on=1)
    assert rc == 0 and res["correct"] is True
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(got) >= set(NAMES)
    assert all(math.isfinite(got[k]) for k in NAMES)
    assert all(got[f"host_ms.{s}"] > 0 for s in STAGES)
    assert got["sync_wait_ms"] >= 0 and got["host_syncs.render"] >= 3
    assert got["host_syncs.render"] == int(got["host_syncs.render"])
    assert 90 <= got["span_cover.render"] <= 100
    # The stages of a frame cannot take longer than the traced window.
    assert sum(got[f"host_ms.{s}"] for s in STAGES) <= \
        1e3 * res["device"]["window_s"]


def test_readers_read_nothing_from_a_program_without_spans():
    """A registry without the "Spans" counters (a program before them)
    gives no value and raises nothing."""
    from tpuprt_torch.utils.stats import StatsRegistry
    st = StatsRegistry()
    st.add("Wavefront", "Passes", 3)
    for name in NAMES:
        reader = registry.reader(name)
        assert reader.read({"stats": st, "n": 1}) is None
        assert reader.read({"stats": None, "n": 1}) is None
