"""The refine-only shapes and the rest of instancing in the port, held
against tpuprt on the CPU: the tessellated heightfield, Loop subdivision
surface and NURBS patch; scenes holding them at top level and inside
objects, quadrics folded into their tables under each instance and
emitters inside objects, whose tables equal tpuprt's through the bridge;
and a mirrored instanced lamp against the same lamp written inline, where
tpuprt diverges (tpuprt/lights/lights.py:197-199). The lamps' sampling,
emission, hits and a render per sample are in test_torch_lamps.py.
"""
import os
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from test_torch_bvh import assert_tables_equal, numpy_tables
from tpuprt.lights import lights as jlt
from tpuprt.scene import parser as jparser
from tpuprt.scene.parser import load_scene_string as jax_load
from tpuprt.scene.tessellate import tessellate as jtess
from tpuprt_torch import render as torch_render
from tpuprt_torch.lights import lights as tlt
from tpuprt_torch.scene import parser as tparser
from tpuprt_torch.scene.bridge import from_numpy_tables
from tpuprt_torch.scene.data import AREA_GEOM_INST, AREA_GEOM_TRIS
from tpuprt_torch.scene.parser import load_scene_string
from tpuprt_torch.scene.tessellate import tessellate as ttess

torch.set_num_threads(1)
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from make_scenes import icosphere  # noqa: E402


def _nums(a):
    return " ".join(f"{x:.9g}" for x in np.asarray(a).ravel())


def _ico(seed=0):
    """A jittered icosahedron (12 vertices, 20 faces)."""
    v, f = icosphere(0)
    v = v * np.random.default_rng(seed).uniform(0.8, 1.2, (len(v), 1))
    return v.astype(np.float32), f


def _open_sheet():
    """A 3 x 3 vertex sheet bent in z: a boundary all round."""
    xs, ys = np.meshgrid(np.linspace(0, 1, 3), np.linspace(0, 1, 3))
    P = np.stack([xs, ys, 0.2 * np.sin(3 * xs + ys)], -1).reshape(-1, 3)
    idx = []
    for y in range(2):
        for x in range(2):
            a = y * 3 + x
            idx += [[a, a + 1, a + 4], [a, a + 4, a + 3]]
    return P.astype(np.float32), np.asarray(idx)


def _cases(kind):
    """[(what, params as "type name" -> values)] of a shape kind."""
    rng = np.random.default_rng(7)
    if kind == "heightfield":
        return [("5x4", {"integer nu": [5], "integer nv": [4],
                         "float Pz": rng.uniform(0, 1, 20).tolist()})]
    if kind == "loopsubdiv":
        out = []
        for name, (P, idx) in (("closed", _ico()), ("boundary",
                                                    _open_sheet())):
            for n in (1, 2, 3):
                out.append((f"{name}/{n}", {
                    "integer nlevels": [n], "point P": P.ravel().tolist(),
                    "integer indices": idx.ravel().tolist()}))
        return out
    knots = [0, 0, 0, 0.5, 1, 1, 1]
    P = np.stack(np.meshgrid(np.linspace(0, 1, 4), np.linspace(0, 1, 4)),
                 -1).reshape(-1, 2)
    P = np.concatenate([P, rng.uniform(0, 0.3, (16, 1))], 1)
    w = rng.uniform(0.5, 1.5, (16, 1))
    common = {"integer nu": [4], "integer nv": [4], "integer uorder": [3],
              "integer vorder": [3], "float uknots": knots,
              "float vknots": knots}
    return [("P", dict(common, **{"point P": P.ravel().tolist()})),
            ("Pw", dict(common, **{"float Pw": np.concatenate(
                [P * w, w], 1).ravel().tolist()}))]


def _paramsets(raw):
    j = jparser.ParamSet({k.split()[1]: (k.split()[0], v)
                          for k, v in raw.items()})
    t = tparser.ParamSet({k.split()[1]: (k.split()[0], np.asarray(
        v, np.float64)) for k, v in raw.items()})
    return j, t


@pytest.mark.parametrize("kind", ["heightfield", "loopsubdiv", "nurbs"])
def test_tessellation_equals_tpuprts(kind):
    """P, indices, N and uv equal tpuprt's arrays: the heightfield's grid,
    Loop subdivision of a closed and an open mesh at 1-3 levels (its
    weights, boundary rules and limit projection), the NURBS patch with
    and without weights."""
    for what, raw in _cases(kind):
        j, t = _paramsets(raw)
        for a, b in zip(jtess(kind, j), ttess(kind, t)):
            assert (a is None) == (b is None), what
            if a is not None:
                assert a.dtype == b.dtype and a.shape == b.shape, what
                np.testing.assert_array_equal(a, b, err_msg=what)


def _shape_lines(kind):
    """A Shape statement of `kind` with test_tessellation's first case."""
    raw = _cases(kind)[0][1]
    return f'Shape "{kind}" ' + " ".join(
        f'"{k}" [{_nums(v)}]' for k, v in raw.items()) + "\n"


SHAPES = ('Film "image" "integer xresolution" [16] '
          '"integer yresolution" [16]\n'
          "LookAt 0 2 -5  0 0 0  0 1 0\n"
          'Camera "perspective" "float fov" [50]\n'
          'Accelerator "bvh"\n'
          "WorldBegin\n"
          'LightSource "point" "color I" [9 9 9] "point from" [0 3 -2]\n'
          + "".join(f"AttributeBegin\nTranslate {x} 0 0\n{_shape_lines(k)}"
                    "AttributeEnd\n" for x, k in
                    ((-2, "heightfield"), (0, "loopsubdiv"), (2, "nurbs")))
          + 'ObjectBegin "mix"\n'
          'Material "plastic" "color Kd" [0.3 0.5 0.2]\n'
          + _shape_lines("loopsubdiv") + _shape_lines("nurbs")
          + "Translate 0 0.5 0\n" + _shape_lines("heightfield")
          + 'Shape "sphere" "float radius" [0.3]\n'
          'Shape "cylinder" "float radius" [0.2] "float zmin" [0] '
          '"float zmax" [0.5]\n'
          'ReverseOrientation\nShape "disk" "float radius" [0.4]\n'
          'AttributeBegin\nAreaLightSource "area" "color L" [2 2 2]\n'
          'Shape "sphere" "float radius" [0.1]\nAttributeEnd\n'
          "ObjectEnd\n"
          + "".join(f"AttributeBegin\nTranslate {x} 1 {z}\nRotate {r} 0 1 0\n"
                    f"{s}ObjectInstance \"mix\"\nAttributeEnd\n"
                    for x, z, r, s in ((-1, 1, 20, ""), (1, 2, -40, ""),
                                       (0, 3, 90, "Scale 1 2 1\n"),
                                       (2, 1, 0, "Scale -1 1 1\n")))
          + "WorldEnd\n")


def test_shapes_and_objects_load_as_tpuprt():
    """Top-level heightfield, loopsubdiv and nurbs, and an object holding
    them, three quadrics and an emissive sphere, placed four times (one
    under a non-uniform scale, one mirrored): the mesh kinds instance,
    the quadrics and the sphere lamp fold into rows of their own under
    each instance; every table equals tpuprt's carried across."""
    js, _ = jax_load(SHAPES)
    ts, _ = load_scene_string(SHAPES)
    assert ts.instances.count == 12 and ts.quadrics.count == 16
    assert ts.lights.count == 5
    assert_tables_equal(ts, from_numpy_tables(numpy_tables(js), "cpu"))


def lamp_text(mirror_every=0, inline=False, res=16, spp=4, squash=None):
    """test_instances.py's instanced lamps, three quads over a floor,
    emitting down onto it (each placement its own light), every
    `mirror_every`-th placement mirrored, or the same lamps written inline
    (duplicated); placement `squash` under a non-uniform scale."""
    head = (f'Film "image" "integer xresolution" [{res}] '
            f'"integer yresolution" [{res}]\n'
            "LookAt 0 1.2 -4  0 0 0  0 1 0\n"
            'Camera "perspective" "float fov" [52]\n'
            f'Sampler "lowdiscrepancy" "integer pixelsamples" [{spp}]\n'
            'PixelFilter "box" "float xwidth" [0.5] "float ywidth" [0.5]\n'
            'SurfaceIntegrator "directlighting"\n'
            "WorldBegin\n"
            'Material "matte" "color Kd" [0.7 0.6 0.5]\n'
            'Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]\n'
            '  "point P" [-6 -0.5 -6  6 -0.5 -6  6 -0.5 6  -6 -0.5 6]\n')
    lamp = ('  AreaLightSource "area" "color L" [6 5 4]\n'
            '  Material "matte" "color Kd" [0.2 0.2 0.2]\n'
            '  Shape "trianglemesh" "integer indices" [0 1 2  0 2 3]\n'
            '    "point P" [-0.3 0 -0.3  0.3 0 -0.4  0.35 0 0.3'
            "  -0.3 0 0.3]\n")
    places = [(-1.2, 0.9, 0.0, 35.0), (0.2, 1.1, -0.5, -20.0),
              (1.4, 0.8, 0.6, 80.0)]
    out = head if inline else head + 'ObjectBegin "lamp"\n' + lamp + \
        "ObjectEnd\n"
    for i, (x, y, z, r) in enumerate(places):
        out += (f"AttributeBegin\n  Translate {x} {y} {z}\n"
                f"  Rotate {r} 0 1 0\n")
        if mirror_every and i % mirror_every == 0:
            out += "  Scale -1 1 1\n"
        if i == squash:
            out += "  Scale 1 1 2\n"
        out += (lamp if inline else '  ObjectInstance "lamp"\n') + \
            "AttributeEnd\n"
    return out + "WorldEnd\n"


def test_lamp_tables_match_tpuprt():
    """Each placement of the emissive prototype is a LightTable row
    (AREA_GEOM_INST, its first prototype triangle, the instance's l2w, the
    sign of its determinant) with its own CDF segment; the prototype's
    triangles are tri_emissive and each instance points at its row. A
    placement under a non-uniform scale is duplicated instead: a mesh
    emitter of its own (AREA_GEOM_TRIS), as tpuprt routes it."""
    js, _ = jax_load(lamp_text(squash=1))
    ts, _ = load_scene_string(lamp_text(squash=1))
    assert ts.lights.area_geoms_present == (AREA_GEOM_TRIS, AREA_GEOM_INST)
    assert ts.instances.count == 2 and ts.triangles.count == 4
    assert_tables_equal(ts, from_numpy_tables(numpy_tables(js), "cpu"))
    for mirror in (0, 2):
        js, _ = jax_load(lamp_text(mirror))
        ts, _ = load_scene_string(lamp_text(mirror))
        assert ts.lights.area_geoms_present == (AREA_GEOM_INST,)
        assert ts.instances.inst_area_light.tolist() == [0, 1, 2]
        assert ts.instances.tri_emissive.all()
        assert ts.lights.params[:, 5].tolist() == \
            ([-1.0, 1.0, -1.0] if mirror else [1.0] * 3)
        assert_tables_equal(ts, from_numpy_tables(numpy_tables(js), "cpu"))


def test_mirrored_instanced_lamp_matches_inline():
    """A mirrored instanced lamp lights the floor as the same lamp written
    inline does (the triangle path), by test_instances.py's measures: mean
    |diff| / mean < 0.03 and the brightest pixel within 1% (an instanced
    emitter takes no BSDF-strategy sample in next-event estimation, as in
    tpuprt, so the images are close, not equal). The port's sampled
    normal is the one its hits see: a light sample equals the inline
    lamp's. tpuprt's _sample_area_inst multiplies that normal by
    sign(det l2w) a second time (tpuprt/lights/lights.py:197-199), so its
    mirrored lamps light the other hemisphere: from a floor point under
    the mirrored lamp its light sample finds no radiance where the inline
    lamp's does, and the port's does."""
    text_i, text_d = lamp_text(2), lamp_text(2, inline=True)
    opts = load_scene_string(text_i)[1]._replace(driver="scan")
    rgb_i, a_i = torch_render.render(load_scene_string(text_i)[0], opts,
                                     device="cpu")
    rgb_d, a_d = torch_render.render(load_scene_string(text_d)[0], opts,
                                     device="cpu")
    np.testing.assert_array_equal(a_i, a_d)
    assert np.abs(rgb_i - rgb_d).mean() / rgb_d.mean() < 0.03
    np.testing.assert_allclose(rgb_i.max(), rgb_d.max(), rtol=0.01)
    assert rgb_i.mean() > 0.01

    # Floor points below lamp 0 (mirrored), light 0 sampled from each.
    n = 16
    u = np.random.default_rng(0).uniform(0, 1, (3, n)).astype(np.float32)
    p = np.stack([np.linspace(-1.6, -0.8, n), np.full(n, -0.5),
                  np.linspace(-0.3, 0.3, n)], -1).astype(np.float32)
    nrm = np.tile(np.float32([[0, 1, 0]]), (n, 1))
    lid = np.zeros(n, np.int32)

    def li(mod, scene, arr):
        return np.asarray(mod.sample(scene, arr(lid), arr(p), arr(nrm),
                                     *map(arr, u))["Li"])
    port = li(tlt, load_scene_string(text_i)[0], torch.from_numpy)
    inline = li(tlt, load_scene_string(text_d)[0], torch.from_numpy)
    jax_inst = li(jlt, jax_load(text_i)[0], jnp.asarray)
    jax_inline = li(jlt, jax_load(text_d)[0], jnp.asarray)
    assert (inline > 0).all() and (jax_inline > 0).all()
    np.testing.assert_array_equal(port, inline)
    assert (jax_inst == 0).all()          # tpuprt's divergence
