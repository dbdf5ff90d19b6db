"""The roofline metrics' byte counts on hand-worked frames, and the
reference's ray counts that they read."""
import os

import pytest

from conftest import BENCH, WINDOWS
from harness import frames, registry, roofline
from reference import render as rr, scene as rs

TILES = registry.reader("roofline.bvh_tiles")
MT = registry.reader("roofline.mt_best")


def scene(name):
    return rs.load(os.path.join(BENCH, "configs", f"{name}.pbrt"))


def test_config4_big_frame_by_hand():
    sc = scene("config4_big")
    # 1000 nearest rays of 40 bytes, 2400 any-hit rays of 33, 99,458
    # triangles of 36 bytes, one frame.
    assert roofline.least_bytes(1000, 2400, 1, len(sc.idx)) == \
        1000 * 40 + 2400 * 33 + 99458 * 36
    run = {"trace": {"kernels": {"void bvh_tiles_kernel(float const*)": 6e-5,
                                 "void bvh_tiles_kernel(int)": 4e-5,
                                 "mt_best_kernel": 1.0}},
           "ref_rays": {"nearest": 1000, "any": 2400}, "n": 1,
           "ref_scene": sc}
    want = 100.0 * (1000 * 40 + 2400 * 33 + 99458 * 36) / 3.35e12 / 1e-4
    assert TILES.read(run) == pytest.approx(want)
    assert want == pytest.approx(1.10448, rel=1e-4)


def test_bench3_frames_by_hand():
    sc = scene("bench3")
    # Two traced frames, each (by the checked frames' mean) 500 nearest
    # and 300 any-hit rays; 10 triangles.
    run = {"trace": {"kernels": {"mt_best_kernel(float const*, int)": 2e-6}},
           "ref_rays": {"nearest": 500, "any": 300}, "n": 2,
           "ref_scene": sc}
    b = 2 * 500 * 40 + 2 * 300 * 33 + 2 * 10 * 36
    assert MT.read(run) == pytest.approx(100.0 * b / 3.35e12 / 2e-6)


def test_nothing_to_read_is_no_share():
    sc = scene("bench3")
    assert MT.read({"trace": {}, "n": 1, "ref_scene": sc,
                    "ref_rays": {"nearest": 1, "any": 1}}) is None
    assert MT.read({"trace": {"kernels": {"mt_best_kernel": 1e-3}}, "n": 1,
                    "ref_scene": sc}) is None


WALL = """Film "image" "integer xresolution" [4] "integer yresolution" [4]
LookAt 0 0 -2  0 0 0  0 1 0
Camera "perspective" "float fov" [30]
Sampler "lowdiscrepancy" "integer pixelsamples" [2]
PixelFilter "box" "float xwidth" [0.5] "float ywidth" [0.5]
SurfaceIntegrator "directlighting"
WorldBegin
LightSource "distant" "point from" [0 0 -5] "point to" [0 0 0]
    "color L" [1 1 1]
Material "%s"
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-5 -5 0  5 -5 0  5 5 0  -5 5 0]
WorldEnd
"""


@pytest.mark.parametrize("material,nearest,any_hit", [
    # 16 pixels x 2 samples: each camera ray hits the wall. A matte vertex
    # traces the distant light's shadow ray (a delta light: no BSDF ray);
    # a mirror vertex traces none, and its reflection escapes.
    ("matte", 32, 32), ("mirror", 64, 0)])
def test_the_reference_counts_the_rays_by_hand(material, nearest, any_hit):
    ref = rr.Reference(rs.parse(WALL % material), "cpu")
    ref.frame(3)
    assert ref.rays == {"nearest": nearest, "any": any_hit}


def test_a_frames_rays_reach_the_metric():
    """The check's frames hand their mean count to the run."""
    cfg = registry.config("bench3")
    win = WINDOWS["bench3"]
    _, ref = frames.reference_frames(cfg, [5, 6], "cpu", win)
    one = [frames.reference_frames(cfg, [s], "cpu", win)[1].rays
           for s in (5, 6)]
    assert ref.rays == {k: (one[0][k] + one[1][k]) / 2 for k in one[0]}
    assert ref.rays["nearest"] >= 36 * 32
