"""The port's quadrics and quadric area lights held against tpuprt on the
CPU.

Six quadrics, one of each kind, with partial phimax and z ranges, under
rotations, one of them mirrored and one with ReverseOrientation, built by
both packages' SceneBuilder; rays aimed at them from around. Then a disk
and a sphere area light over a floor: lights.sample, pdf,
pdf_area_from_hit and area_emission against tpuprt's.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from test_torch_bvh import assert_tables_equal, numpy_tables
from tpuprt.lights import lights as jlights
from tpuprt.scene.build import SceneBuilder as JaxBuilder
from tpuprt.scene.parser import load_scene_string as jax_load
from tpuprt.shapes import quadrics as jquad
from tpuprt_torch.core import transform as tf
from tpuprt_torch.lights import lights as tlights
from tpuprt_torch.scene.bridge import from_numpy_tables
from tpuprt_torch.scene.build import SceneBuilder
from tpuprt_torch.scene.parser import load_scene_string
from tpuprt_torch.shapes import quadrics as tquad

torch.set_num_threads(1)


def six_quadrics(b):
    """One quadric of each kind on builder `b`, spread along x."""
    m = b.matte()

    def at(x, deg, axis, mirror=False):
        xf = tf.translate((x, 0.2 * x, 0.5)) @ tf.rotate(deg, axis)
        return xf @ tf.scale(-1, 1, 1) if mirror else xf

    b.add_sphere(at(-5, 30, (1, 0, 0)), 1.0, -0.6, 0.8, 300.0, m)
    b.add_cylinder(at(-3, 70, (0, 1, 1)), 0.7, -0.5, 0.9, 250.0, m,
                   reverse_orientation=True)
    b.add_disk(at(-1, 50, (1, 1, 0)), 0.2, 1.0, 0.3, 270.0, m)
    b.add_cone(at(1, 110, (1, 0, 1)), 0.8, 1.2, 320.0, m)
    b.add_paraboloid(at(3, 20, (0, 1, 0), mirror=True), 0.9, 0.1, 1.1,
                     290.0, m)
    b.add_hyperboloid(at(5, 60, (1, 2, 3)), (0.3, 0.0, -0.5),
                      (0.6, 0.4, 0.7), 330.0, m)
    b.add_distant_light(np.eye(4), (1.0, 1.0, 1.0), (0, 1, 0), (0, 0, 0))
    return b.build()


@pytest.fixture(scope="module")
def scenes():
    return six_quadrics(JaxBuilder()), six_quadrics(SceneBuilder())


def rays_at_quadrics(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(3, 6, n) * rng.choice([-1, 1], n)
    tgt = np.stack([rng.integers(-2, 3, n) * 2.0 + 1.0, np.zeros(n),
                    np.full(n, 0.5)], 1)
    tgt[:, 1] = 0.2 * tgt[:, 0]
    tgt += rng.uniform(-1.2, 1.2, (n, 3))
    d = (tgt - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mint = np.full(n, 1e-3, np.float32)
    maxt = np.full(n, 1e30, np.float32)
    maxt[::7] = rng.uniform(2, 8, len(maxt[::7]))
    return o, d, mint, maxt


def test_quadric_tables_equal_tpuprt(scenes):
    jscene, tscene = scenes
    q = tscene.quadrics
    assert q.count == 6 and q.kinds_present == (0, 1, 2, 3, 4, 5)
    assert q.flip_normal.tolist() == [1, -1, 1, 1, -1, 1]
    assert_tables_equal(tscene, from_numpy_tables(numpy_tables(jscene),
                                                  "cpu"))


def test_intersect_and_geometry_match_tpuprt(scenes):
    """All pairs [N, 6]: equal valid masks, t within 1e-5 relative; then
    each ray's nearest quadric's differential geometry. atan2, acos and sin
    come from XLA's and torch's own CPU libraries, which may differ in the
    last bit, so the geometry agrees to rtol 1e-4 (and 1e-5 absolute)."""
    jscene, tscene = scenes
    o, d, mint, maxt = rays_at_quadrics(4096, 1)
    jt, jv = jquad.intersect(jscene.quadrics, *map(jnp.asarray,
                                                   (o, d, mint, maxt)))
    tt, tv = tquad.intersect(tscene.quadrics, *map(torch.from_numpy,
                                                   (o, d, mint, maxt)))
    jv, jt = np.asarray(jv), np.asarray(jt)
    np.testing.assert_array_equal(tv.numpy(), jv)
    assert (jv.sum(0) > 80).all()
    np.testing.assert_allclose(tt.numpy()[jv], jt[jv], rtol=1e-5)

    hit = jv.any(1)
    qid = jt.argmin(1).astype(np.int32)
    tmin = jt.min(1)
    jdg = jquad.differential_geometry(
        jscene.quadrics, jnp.asarray(qid), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(tmin))
    tdg = tquad.differential_geometry(
        tscene.quadrics, torch.from_numpy(qid), torch.from_numpy(o),
        torch.from_numpy(d), torch.from_numpy(tmin))
    assert set(tdg) == set(jdg)
    for k in jdg:
        np.testing.assert_allclose(tdg[k].numpy()[hit],
                                   np.asarray(jdg[k])[hit], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


LIGHTS = """
LookAt 0 1.5 -4  0 0 0  0 1 0
Camera "perspective" "float fov" [50]
Sampler "lowdiscrepancy" "integer pixelsamples" [2]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
PixelFilter "box"
Accelerator "none"
WorldBegin
AttributeBegin
  AreaLightSource "area" "color L" [6 5 4]
  Translate -0.8 2.0 0.3
  Rotate 80 1 0 0
  Shape "disk" "float radius" [0.6] "float innerradius" [0.1]
AttributeEnd
AttributeBegin
  AreaLightSource "area" "color L" [2 3 4]
  Translate 1.2 1.6 -0.4
  Shape "sphere" "float radius" [0.35]
AttributeEnd
AttributeBegin
  Material "plastic" "color Kd" [0.3 0.4 0.5]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-3 0 -3  3 0 -3  3 0 3  -3 0 3]
AttributeEnd
WorldEnd
"""


def test_area_lights_match_tpuprt():
    """Shading points on and above the floor, each lane's light one of the
    two: sample (Li, wi, pdf, the visibility segment), pdf, pdf_area_from_hit
    at the points sampled, area_emission toward the shading points. The
    sphere is sampled from outside and, for a few points, from inside.
    Equal to float rounding (rtol 1e-4; atol 1e-5 on directions)."""
    jscene, _ = jax_load(LIGHTS)
    tscene, _ = load_scene_string(LIGHTS)
    assert tscene.accel is None and tscene.lights.count == 2
    assert_tables_equal(tscene, from_numpy_tables(numpy_tables(jscene),
                                                  "cpu"))
    rng = np.random.default_rng(3)
    n = 2048
    p = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    p[:, 1] = rng.uniform(0, 1.2, n)
    p[-16:] = [1.2, 1.6, -0.4] + rng.uniform(-0.1, 0.1, (16, 3))
    nrm = np.tile(np.float32([0, 1, 0]), (n, 1))
    lid = (np.arange(n) % 2).astype(np.int32)
    u = rng.uniform(0, 1, (3, n)).astype(np.float32)
    j = jlights.sample(jscene, jnp.asarray(lid), jnp.asarray(p),
                       jnp.asarray(nrm), *map(jnp.asarray, u))
    t = tlights.sample(tscene, torch.from_numpy(lid), torch.from_numpy(p),
                       torch.from_numpy(nrm), *map(torch.from_numpy, u))
    lit = np.asarray(j["Li"]).any(1)
    assert 0.3 * n < lit.sum() < n
    for k in ("Li", "pdf", "vis_maxt", "delta"):
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]),
                                   rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(t["wi"].numpy(), np.asarray(j["wi"]),
                               rtol=1e-4, atol=1e-5)

    wi = np.array(j["wi"])
    jp = jlights.pdf(jscene, jnp.asarray(lid), jnp.asarray(p),
                     jnp.asarray(nrm), jnp.asarray(wi))
    tp = tlights.pdf(tscene, torch.from_numpy(lid), torch.from_numpy(p),
                     torch.from_numpy(nrm), torch.from_numpy(wi))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-4)
    assert (np.asarray(jp)[lid == 1] > 0).all()

    hit_p = p + wi * np.asarray(j["vis_maxt"])[:, None] / (1 - 1e-3)
    hit_n = rng.normal(size=(n, 3)).astype(np.float32)
    hit_n /= np.linalg.norm(hit_n, axis=1, keepdims=True)
    jh = jlights.pdf_area_from_hit(jscene, jnp.asarray(lid), jnp.asarray(p),
                                   jnp.asarray(wi), jnp.asarray(hit_p),
                                   jnp.asarray(hit_n))
    th = tlights.pdf_area_from_hit(tscene, torch.from_numpy(lid),
                                   torch.from_numpy(p), torch.from_numpy(wi),
                                   torch.from_numpy(hit_p),
                                   torch.from_numpy(hit_n))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4)

    area_id = np.where(np.arange(n) % 3 == 0, -1, lid).astype(np.int32)
    je = jlights.area_emission(jscene, jnp.asarray(area_id),
                               jnp.asarray(hit_n), jnp.asarray(-wi))
    te = tlights.area_emission(tscene, torch.from_numpy(area_id),
                               torch.from_numpy(hit_n), torch.from_numpy(-wi))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert np.asarray(je).any(1).sum() > n // 4
