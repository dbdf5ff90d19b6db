"""The renderer's stage spans (utils/stats.span) on the CPU, on the small
scene of test_torch_cli.py in path mode through the pool (fewer lanes than
samples, so lanes regenerate) and the chunked driver, and in
directlighting mode through the pool: under torch.profiler the stages are
`tpuprt/<stage>` ranges that hold the frame's aten ops and one
`tpuprt/sync` range a host sync; with no registry and no profiler no range
is entered and the image is the same; each host conversion, nonzero and
readback is one sync span; the spans' self times sum to the frame's
time."""
import bisect
import time

import numpy as np
import pytest
import torch

from test_torch_cli import POOL_LANES, SCENE
from tpuprt_torch import render as torch_render
from tpuprt_torch.scene.parser import load_scene_string
from tpuprt_torch.utils import stats as stats_mod
from tpuprt_torch.utils.stats import StatsRegistry

torch.set_num_threads(1)

CASES = {"pool-path": ("wavefront", "path"), "scan-path": ("scan", "path"),
         "pool-directlighting": ("wavefront", "directlighting")}
STAGES = ("camera", "intersect", "shadow", "shade", "light", "film")


def options(case):
    driver, integrator = CASES[case]
    scene, opts = load_scene_string(SCENE)
    return scene, opts._replace(chunk_size=POOL_LANES, driver=driver,
                                integrator=integrator, half_readback=True)


@pytest.fixture(scope="module")
def profiled():
    """Each case rendered under torch.profiler with a registry: (rgb,
    alpha, registry, the profiler's raw events)."""
    out = {}
    for case in CASES:
        scene, opts = options(case)
        stats = StatsRegistry()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            rgb, alpha = torch_render.render(scene, opts, device="cpu",
                                             stats=stats)
        out[case] = rgb, alpha, stats, list(
            prof.profiler.kineto_results.events())
    return out


def ranges(events, prefix="tpuprt/"):
    return [(e.start_ns(), e.end_ns(), e.name()[len(prefix):])
            for e in events
            if e.is_user_annotation() and e.name().startswith(prefix)]


@pytest.mark.parametrize("case", list(CASES))
def test_profiler_ranges_hold_the_frames_ops(profiled, case):
    """Every stage shows as a range; at least 95% of the aten ops inside
    the frame's range lie inside a stage's (or a sync's) range; one sync
    range per counted sync; the registry's table ends with "Spans"."""
    _, _, stats, events = profiled[case]
    spans = ranges(events)
    (f0, f1, _), = [r for r in spans if r[2] == "frame"]
    assert {n for _, _, n in spans} >= set(STAGES) | {"frame", "sync"}
    # The outermost spans inside the frame (spans nest, so every other one
    # lies inside one of them), in order of start.
    top = []
    for s, e, n in sorted(spans):
        if n != "frame" and not (top and e <= top[-1][1]):
            top.append((s, e))
    starts = [s for s, _ in top]
    ops = [(e.start_ns(), e.end_ns()) for e in events
           if not e.is_user_annotation() and e.name().startswith("aten::")
           and f0 <= e.start_ns() and e.end_ns() <= f1]
    held = 0
    for a, b in ops:
        k = bisect.bisect_right(starts, a) - 1
        held += k >= 0 and b <= top[k][1]
    assert len(ops) > 1000 and held >= 0.95 * len(ops), (held, len(ops))
    assert sum(n == "sync" for _, _, n in spans) == \
        stats.get("Spans", "syncs") > 0
    cats = [line.strip() for line in stats.format_table().splitlines()
            if line.startswith("    ") and line[4] != " "]
    assert cats[-1] == "Spans"


@pytest.mark.parametrize("case", list(CASES))
def test_self_times_sum_to_the_frame(profiled, case):
    """The stages' self ms plus the frame's own sum to the frame's range
    on the profiler's clock within 1%, and frame's own is under 5%."""
    _, _, stats, events = profiled[case]
    (f0, f1, _), = [r for r in ranges(events) if r[2] == "frame"]
    ms = {n[:-3]: v for (c, n), v in stats.items()
          if c == "Spans" and n.endswith(" ms")}
    assert set(ms) >= set(STAGES) | {"frame", "sync"}
    assert sum(ms.values()) == pytest.approx((f1 - f0) * 1e-6, rel=0.01)
    assert ms["frame"] < 0.05 * sum(ms.values())
    assert stats.get("Spans", "frame calls") == 1


@pytest.mark.parametrize("case", ["pool-path", "scan-path"])
def test_no_registry_no_profiler_enters_no_range(profiled, case,
                                                 monkeypatch):
    """Without a registry or a profiler a span is the shared null context:
    record_function is never entered, and the image is the profiled
    render's."""
    def refuse(*a, **k):
        raise AssertionError("record_function entered")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert stats_mod.span("shade") is stats_mod.span("sync")
    scene, opts = options(case)
    rgb, alpha = torch_render.render(scene, opts, device="cpu")
    np.testing.assert_array_equal(rgb, profiled[case][0])
    np.testing.assert_array_equal(alpha, profiled[case][1])


@pytest.mark.parametrize("case", list(CASES))
def test_each_host_sync_is_one_sync_span(case, monkeypatch):
    """The host conversions, nonzero calls and readback copies a render
    makes (counted by patching, as test_pool_counters_match_tpuprt counts
    conversions) equal the registry's Spans / syncs, and each happens
    inside a sync span. In the pool: a conversion a pass, the two
    counters read after the loop, two readbacks."""
    seen = []

    def counting(real):
        def call(*a, **k):
            timing = stats_mod._ACTIVE.get()
            seen.append(timing.open[-1].name if timing and timing.open
                        else None)
            return real(*a, **k)
        return call
    for owner, name in ((torch.Tensor, "__bool__"),
                        (torch.Tensor, "__float__"),
                        (torch.Tensor, "__int__"), (torch.Tensor, "item"),
                        (torch.Tensor, "tolist"), (torch.Tensor, "cpu"),
                        (torch.Tensor, "nonzero"), (torch, "nonzero")):
        monkeypatch.setattr(owner, name, counting(getattr(owner, name)))
    scene, opts = options(case)
    stats = StatsRegistry()
    t0 = time.perf_counter()
    torch_render.render(scene, opts, device="cpu", stats=stats)
    wall_ms = (time.perf_counter() - t0) * 1e3
    monkeypatch.undo()
    assert seen and set(seen) == {"sync"}, seen
    assert stats.get("Spans", "syncs") == len(seen)
    if CASES[case][0] == "wavefront":
        assert len(seen) == stats.get("Wavefront", "Passes") + 4
    total = sum(v for (c, n), v in stats.items()
                if c == "Spans" and n.endswith(" ms"))
    assert 0 < total <= wall_ms
