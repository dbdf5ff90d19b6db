"""The wavefront pool's replayed passes (integrators/path_wavefront.py):
the rule that decides from the input (device, mode, accelerator, volumes)
whether render() records a pass as a CUDA graph, the kernels' launch
counts across a capture and its replays, and, on a 4x4-pixel crop of
bench3 (path mode, 64 lanes, so lanes regenerate), that a pass run in
place, as a replay runs it, gives the eager render's image and "Wavefront"
counters. Two cases need the card: a replayed frame against an eager one,
and a capture that records no kernel raises."""
import os
import types

import numpy as np
import pytest
import torch

from tpuprt_torch import ops, render as torch_render
from tpuprt_torch.integrators import path_wavefront as pw
from tpuprt_torch.scene.data import BvhAccel, GridAccel, KdTreeAccel
from tpuprt_torch.scene.parser import load_scene
from tpuprt_torch.utils.stats import StatsRegistry

torch.set_num_threads(1)

BENCH3 = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenes", "bench3.pbrt")
LANES = 64
# bench3's 256 x 256 film cut to the 4 x 4 pixels at (128, 128).
CROP = (0.5, 0.515625, 0.5, 0.515625)


def bench3_crop():
    scene, opts = load_scene(BENCH3)
    return scene, opts._replace(crop=CROP, chunk_size=LANES,
                                driver="wavefront")


def wavefront(stats):
    return {n: v for (c, n), v in stats.items() if c == "Wavefront"}


@pytest.fixture(scope="module")
def eager():
    """The crop rendered on the CPU, where every pass is issued from the
    host: (rgb, alpha, "Wavefront" counters)."""
    scene, opts = bench3_crop()
    stats = StatsRegistry()
    rgb, alpha = torch_render.render(scene, opts, device="cpu", stats=stats)
    return rgb, alpha, wavefront(stats)


def stand_in(step, st, cursor):
    """A recorded pass whose replay runs in_place from Python, as the
    graph's replay runs the recorded kernels."""
    g = types.SimpleNamespace(n_active=None, n_shadow=None)

    def replay():
        g.n_active, g.n_shadow = pw.in_place(step, st, cursor)
    g.replay = replay
    return g


def scene_with(volumes=None, accel=None):
    """A stand-in scene: its volume table (None, or `volumes` regions) and
    its main aggregate's accelerator (None: the brute force)."""
    return types.SimpleNamespace(accel=accel, volumes=None if volumes is None
                                 else types.SimpleNamespace(count=volumes))


@pytest.mark.parametrize("device, mode, scene, want", [
    ("cpu", "path", scene_with(), False),
    ("cuda", "path", scene_with(), True),
    ("cuda:0", "directlighting", scene_with(0, BvhAccel()), True),
    ("cuda", "whitted", scene_with(), True),
    ("cuda", "photonmap", scene_with(), False),
])
def test_graph_rule_reads_device_and_mode(device, mode, scene, want):
    """A pass is recorded only on a CUDA device and in a mode shown free of
    host syncs on the card: path, directlighting and whitted, not
    photonmap, whose photon lookups read counts on the host."""
    assert pw.graphed(scene, mode, device) is want


def test_plain_walks_and_volumes_stay_eager():
    """A scene whose walk or volume terms call nonzero (the grid, the
    kd-tree, a BVH over quadrics; a volume region) is never recorded."""
    for scene in (scene_with(1), scene_with(accel=GridAccel()),
                  scene_with(accel=KdTreeAccel()),
                  scene_with(accel=BvhAccel(n_quadrics=2))):
        for mode in pw.GRAPH_MODES:
            assert not pw.graphed(scene, mode, "cuda"), (scene, mode)


def test_launch_counts_follow_the_replays():
    """A capture counts the launches it records and launches nothing: the
    counters are set back and each replay adds that pass's launches."""
    counters = ({"bvh_tiles": 3, "bvh_tiles_any": 1}, {"mt_best": 10,
                                                       "mt_best_any": 4})

    def record():
        counters[0]["bvh_tiles"] += 2
        counters[0]["bvh_tiles_any"] += 1
        counters[1]["mt_best"] += 3
    rose = pw.recorded_launches(counters, record)
    assert rose == [{"bvh_tiles": 2, "bvh_tiles_any": 1},
                    {"mt_best": 3, "mt_best_any": 0}]
    assert counters == ({"bvh_tiles": 3, "bvh_tiles_any": 1},
                        {"mt_best": 10, "mt_best_any": 4})
    for _ in range(5):
        pw.count_launches(counters, rose)
    assert counters == ({"bvh_tiles": 13, "bvh_tiles_any": 6},
                        {"mt_best": 25, "mt_best_any": 4})


def test_passes_run_in_place_give_the_same_frame(eager, monkeypatch):
    """With a stand-in graph (each replay runs in_place on the state the
    first pass left), every pass after the first is a replay, and the
    image and counters are the eager render's bit for bit."""
    monkeypatch.setattr(pw, "graphed", lambda *a: True)
    monkeypatch.setattr(pw, "_PassGraph", stand_in)
    scene, opts = bench3_crop()
    stats = StatsRegistry()
    rgb, alpha = torch_render.render(scene, opts, device="cpu", stats=stats)
    np.testing.assert_array_equal(rgb, eager[0])
    np.testing.assert_array_equal(alpha, eager[1])
    want = dict(eager[2])
    assert "Graph passes" not in want and want["Passes"] > 3
    assert wavefront(stats) == {**want, "Graph passes": want["Passes"] - 1}


@pytest.mark.cuda
def test_replayed_frame_matches_eager_on_the_card(monkeypatch):
    """On the card: a frame whose passes after the first are replayed
    against one with every pass issued from the host, the same image up
    to the order of the splat's atomic adds, the same launches and
    counters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph records kernels")
    scene, opts = load_scene(BENCH3)
    opts = opts._replace(crop=(0.25, 0.75, 0.25, 0.75), chunk_size=1 << 14)
    sc = torch_render.on_device(scene, "cuda")
    out = []
    for record in (False, True):
        monkeypatch.setattr(pw, "graphed", lambda *a, r=record: r)
        ops.reset_launches()
        stats = StatsRegistry()
        rgb, alpha = torch_render.render(sc, opts, device="cuda",
                                         stats=stats)
        out.append((rgb, alpha, ops.launch_counts(), wavefront(stats)))
    (rgb0, a0, l0, w0), (rgb1, a1, l1, w1) = out
    np.testing.assert_allclose(rgb1, rgb0, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(a1, a0, atol=1e-5)
    assert l1 == l0 and l0["mt_best"] > 0
    assert w1.pop("Graph passes") == w1["Passes"] - 1 > 0
    assert w1 == w0


@pytest.mark.cuda
def test_a_capture_of_no_kernel_raises():
    """A pass whose capture records no kernel (its ops went to a stream
    that was not capturing) raises, rather than leaving replays that do
    nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph records kernels")
    st = {"alive": torch.ones(4, dtype=torch.bool, device="cuda")}
    cursor = torch.zeros((), dtype=torch.int64, device="cuda")
    torch.cuda.synchronize()
    # The stand-in pass changes nothing: in_place's copy of the cursor
    # onto itself launches no kernel.
    with pytest.raises(RuntimeError, match="empty graph"):
        pw._PassGraph(lambda st, cur: ({}, cur, 0, 0), st, cursor)
