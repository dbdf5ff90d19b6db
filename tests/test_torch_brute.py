"""The port's slice without an accelerator held against tpuprt on the CPU:
config2 (a 1280-triangle plastic icosphere, a 2-triangle matte floor and a
one-sided disk area light) with Accelerator "none", at 16x16 x 2 spp.

- The tables equal tpuprt's (through the bridge).
- intersect_ids per camera ray equals tpuprt's, through its default CPU
  route (jnp all pairs) and through its Pallas route (mt_pallas in
  interpret mode, forced as test_pallas_integration forces it), and
  hit_geometry agrees at the hits (quadric and triangle alike).
- occluded() (mt_best's any-hit mode) gives tpuprt's shadow mask.
- The visibility rays of a bounce go to the kernels as tpuprt sends them:
  each segment in its own mode without an accelerator, fused on a BVH.
- The whole render matches tpuprt.render.
- The kernels' launch counters are all read through one registry.
- The accelerator policy, and what the slice does not cover raises.

test_accelerator_policy's cases run in test_torch_brute_policy.py and
test_torch_brute_refusals.py (no file holds more than ten cases).
"""
import os
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from test_torch_bvh import assert_hits_agree, assert_tables_equal, \
    numpy_tables, terrain_scene_text
from tpuprt import render as jax_render
from tpuprt.accel import intersect as jisect
from tpuprt.cameras import cameras as jcam
from tpuprt.samplers import samplers as jsmp
from tpuprt.scene.parser import load_scene_string as jax_load
from tpuprt_torch import ops, render as torch_render
from tpuprt_torch.accel import intersect as tisect
from tpuprt_torch.ops import bvh_cuda, mt_cuda
from tpuprt_torch.scene.bridge import from_numpy_tables
from tpuprt_torch.scene.data import BvhAccel, GridAccel, KdTreeAccel
from tpuprt_torch.scene.parser import load_scene_string

torch.set_num_threads(1)
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, "tools"))
from make_scenes import config2  # noqa: E402

RES, SPP = 16, 2


def config2_none(res=RES, spp=SPP):
    return (config2().replace('Accelerator "grid"', 'Accelerator "none"')
            .replace("[128]", f"[{res}]")
            .replace('"integer pixelsamples" [8]',
                     f'"integer pixelsamples" [{spp}]'))


@pytest.fixture(scope="module")
def scenes():
    text = config2_none()
    jscene, jopts = jax_load(text)
    tscene, topts = load_scene_string(text)
    return jscene, jopts, tscene, topts


def test_tables_equal_tpuprt(scenes):
    jscene, _, tscene, _ = scenes
    assert tscene.accel is None and jscene.accel is None
    assert (tscene.quadrics.count, tscene.triangles.count) == (1, 1282)
    assert tscene.lights.area_geom_kind.tolist() == [0]
    assert_tables_equal(tscene, from_numpy_tables(numpy_tables(jscene),
                                                  "cpu"))


def camera_rays(jscene, jopts):
    """Every (pixel, sample) camera ray of the film, and from the camera
    as many rays aimed at the disk light, as numpy arrays."""
    lin = np.arange(RES * RES * SPP)
    px = (lin // SPP % RES).astype(np.int32)
    py = (lin // SPP // RES).astype(np.int32)
    cs = jsmp.camera_samples(jopts.sampler, jnp.asarray(px), jnp.asarray(py),
                             jnp.asarray((lin % SPP).astype(np.int32)), 0)
    o, d, mint, maxt, _ = jcam.generate_rays(
        jscene.camera, cs["image_x"], cs["image_y"], cs["lens_u"],
        cs["lens_v"], cs["time"], RES, RES)
    o, d, mint, maxt = (np.asarray(x) for x in (o, d, mint, maxt))
    rng = np.random.default_rng(1)
    r = 0.7 * np.sqrt(rng.uniform(0, 1, len(lin)))
    a = rng.uniform(0, 2 * np.pi, len(lin))
    tgt = np.stack([r * np.cos(a), np.full_like(r, 2.4), r * np.sin(a)], 1)
    aim = (tgt - o).astype(np.float32)
    aim /= np.linalg.norm(aim, axis=1, keepdims=True)
    return (np.concatenate([o, o]), np.concatenate([d, aim]),
            np.concatenate([mint, mint]), np.concatenate([maxt, maxt]))


@pytest.mark.parametrize("route", ["jnp", "pallas"])
def test_intersect_ids_match_per_ray(scenes, route, monkeypatch):
    jscene, jopts, tscene, _ = scenes
    o, d, mint, maxt = camera_rays(jscene, jopts)
    if route == "pallas":
        monkeypatch.setattr(jisect, "force_pallas", True)
    jt, jid, jhit = jisect.intersect_ids(jscene, *map(jnp.asarray,
                                                      (o, d, mint, maxt)))
    tt, tid, thit = tisect.intersect_ids(
        tscene, *(torch.from_numpy(x) for x in (o, d, mint, maxt)))
    hit = np.asarray(jhit)
    np.testing.assert_array_equal(thit.numpy(), hit)
    jid = np.asarray(jid)
    assert (jid == 0).sum() > 200 and (jid > 1280).sum() > 50 and \
        ((jid > 0) & (jid <= 1280)).sum() > 100
    # The jnp route keeps the all-pairs t, which XLA computes with FMAs;
    # both other paths recompute the winner's t in separate steps.
    rel = assert_hits_agree(jt, jid, tt, tid, t_rtol=1e-5)
    assert np.mean(rel <= 1e-6) >= 0.99


def test_occluded_matches_tpuprt(scenes, monkeypatch):
    """occluded() sends the triangles through mt_best's any-hit mode and
    gives tpuprt's shadow mask, which is also the nearest pass's; every
    other ray ends short of its hit."""
    jscene, jopts, tscene, _ = scenes
    o, d, mint, maxt = camera_rays(jscene, jopts)
    maxt = np.where(np.arange(len(maxt)) % 2 == 0, maxt, 2.0).astype(
        np.float32)
    modes = []
    real = mt_cuda.mt_best
    monkeypatch.setattr(mt_cuda, "mt_best",
                        lambda rays, tris, any_hit=False:
                        modes.append(any_hit) or
                        real(rays, tris, any_hit=any_hit))
    args = [torch.from_numpy(x) for x in (o, d, mint, maxt)]
    occ = tisect.occluded(tscene, *args)
    assert modes == [True]
    want = np.asarray(jisect.occluded(jscene, *map(jnp.asarray,
                                                   (o, d, mint, maxt))))
    np.testing.assert_array_equal(occ.numpy(), want)
    assert 100 < want.sum() < len(want) - 100
    np.testing.assert_array_equal(
        tisect.intersect_ids(tscene, *args)[2].numpy(), want)



def test_launch_registry_holds_every_wrapper():
    """ops.launch_counters() holds each kernel wrapper's own launch dict,
    so that counts read through it (a frame's, a replayed pass's) see
    every kernel: launch_counts() merges them, reset_launches() zeroes
    them all."""
    counters = ops.launch_counters()
    for wrapper in (bvh_cuda, mt_cuda):
        assert any(c is wrapper.launches for c in counters), wrapper
    saved = [dict(c) for c in counters]
    try:
        ops.reset_launches()
        mt_cuda.launches["mt_best"] += 2
        bvh_cuda.launches["bvh_rows"] += 1
        counts = ops.launch_counts()
        assert set(counts) == set(mt_cuda.launches) | set(bvh_cuda.launches)
        assert {k: v for k, v in counts.items() if v} == {"mt_best": 2,
                                                          "bvh_rows": 1}
        ops.reset_launches()
        assert not any(ops.launch_counts().values())
    finally:
        for c, s in zip(counters, saved):
            c.update(s)


@pytest.mark.parametrize("accel", ["none", "bvh"])
def test_visibility_launches_follow_tpuprt(accel, monkeypatch):
    """One directlighting bounce at 4x4 x 1 spp (every lane ends there).
    Without an accelerator (config2/none) each visibility segment is its
    own launch in its own mode, as tpuprt/integrators/common.py:166-174
    launches them: the area light's shadow rays through mt_best's any-hit
    mode, its BSDF-strategy rays nearest. On a BVH scene (the terrain with
    a distant and an infinite light) the bounce's three segments go to one
    fused any-hit launch."""
    text = config2_none(res=4, spp=1) if accel == "none" else \
        terrain_scene_text(res=4, spp=1)
    scene, opts = load_scene_string(text)
    assert (scene.accel is None) == (accel == "none")
    calls, modes = [], []
    for name in ("intersect_ids", "occluded"):
        def spy(*a, _real=getattr(tisect, name), _name=name):
            calls.append((_name, a[1].shape[0]))
            return _real(*a)
        monkeypatch.setattr(tisect, name, spy)
    real = mt_cuda.mt_best
    monkeypatch.setattr(mt_cuda, "mt_best",
                        lambda rays, tris, any_hit=False:
                        modes.append(any_hit) or
                        real(rays, tris, any_hit=any_hit))
    torch_render.render(scene, opts, device="cpu")
    n = 4 * 4
    if accel == "none":
        assert calls == [("intersect_ids", n), ("occluded", n),
                         ("intersect_ids", n)]
        assert modes == [False, True, False]
    else:
        assert calls == [("intersect_ids", n), ("occluded", 3 * n)]
        assert modes == []


def test_hit_geometry_matches_per_ray(scenes):
    jscene, jopts, tscene, _ = scenes
    o, d, mint, maxt = camera_rays(jscene, jopts)
    jt, jid, jhit = jisect.intersect_ids(jscene, *map(jnp.asarray,
                                                      (o, d, mint, maxt)))
    pid = np.maximum(np.asarray(jid), 0)
    hit = np.asarray(jhit)
    jdg = jisect.hit_geometry(jscene, jnp.asarray(pid), jnp.asarray(o),
                              jnp.asarray(d), jt)
    tdg = tisect.hit_geometry(tscene, torch.from_numpy(pid),
                              torch.from_numpy(o), torch.from_numpy(d),
                              torch.from_numpy(np.asarray(jt)))
    for k in ("p", "nn", "sn", "ss", "ts", "dpdu", "dpdv", "dndu", "dndv",
              "u", "v"):
        np.testing.assert_allclose(tdg[k].numpy()[hit],
                                   np.asarray(jdg[k])[hit], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    for k in ("material", "area_light"):
        np.testing.assert_array_equal(tdg[k].numpy()[hit],
                                      np.asarray(jdg[k])[hit])
    jl = jisect.hit_geometry_light(jscene, jnp.asarray(pid), jnp.asarray(o),
                                   jnp.asarray(d), jt)
    tl = tisect.hit_geometry_light(tscene, torch.from_numpy(pid),
                                   torch.from_numpy(o), torch.from_numpy(d),
                                   torch.from_numpy(np.asarray(jt)))
    for k in ("p", "nn"):
        np.testing.assert_allclose(tl[k].numpy()[hit], np.asarray(jl[k])[hit],
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(tl["area_light"].numpy()[hit],
                                  np.asarray(jl["area_light"])[hit])
    assert (tl["area_light"].numpy()[hit] == 0).sum() > 200


def test_render_matches_tpuprt(scenes, monkeypatch):
    """Every sample uses the same streams; pixels agree to float rounding
    (test_torch_render's rule). The render goes through mt_best on the
    triangles packed once."""
    jscene, jopts, tscene, topts = scenes
    seen = []
    real = mt_cuda.mt_best
    monkeypatch.setattr(mt_cuda, "mt_best",
                        lambda rays, tris, any_hit=False:
                        seen.append(tris.data_ptr()) or
                        real(rays, tris, any_hit=any_hit))
    jrgb, jalpha = jax_render.render(jscene, jopts)
    trgb, talpha = torch_render.render(tscene, topts, device="cpu")
    assert trgb.shape == (RES, RES, 3) and np.isfinite(trgb).all()
    assert len(seen) >= 2 and len(set(seen)) == 1
    np.testing.assert_array_equal(talpha, jalpha)
    close = np.isclose(trgb, jrgb, atol=1e-4, rtol=1e-4).all(-1)
    assert close.mean() >= 0.995, close.mean()
    assert trgb.max() > 1.0     # the light is seen


MESH = ('Shape "trianglemesh" "integer indices" [0 1 2]\n'
        '  "point P" [0 0 0  1 0 0  0 1 0]\n')
BASE = """Film "image" "integer xresolution" [4] "integer yresolution" [4]
Sampler "lowdiscrepancy" "integer pixelsamples" [1]
PixelFilter "box"
{accel}
WorldBegin
LightSource "distant" "point from" [0 1 0] "point to" [0 0 0]
{body}
WorldEnd
"""


def grid_mesh(n):
    """A mesh of 2 n^2 triangles."""
    v = np.stack(np.meshgrid(np.arange(n + 1), np.arange(n + 1)), -1)
    v = np.concatenate([v.reshape(-1, 2), np.zeros(((n + 1) ** 2, 1))], 1)
    i = np.arange(n * n)
    a = i // n * (n + 1) + i % n
    f = np.stack([a, a + 1, a + n + 1, a + 1, a + n + 2, a + n + 1], 1)
    nums = lambda x: " ".join(str(int(y)) for y in np.ravel(x))
    return (f'Shape "trianglemesh" "integer indices" [{nums(f)}]\n'
            f'  "point P" [{nums(v)}]\n')


# test_accelerator_policy's cases, split across test_torch_brute_policy.py
# (which accelerator a file gets) and test_torch_brute_refusals.py (area
# lights and objects) so no file holds more than ten cases.
POLICY_CASES = [
    ("", MESH, None),                                 # auto, <= 64 prims
    ('Accelerator "none"', grid_mesh(30), None),
    ('Accelerator "anything"', MESH, None),
    ('Accelerator "bvh"', MESH, "bvh"),
    ("", grid_mesh(46), "bvh"),                       # auto, > 4096 prims
    ("", grid_mesh(6), "grid"),                       # auto, 72 prims
    ('Accelerator "grid"', MESH, "grid"),
    ('Accelerator "kdtree"', MESH, "kdtree"),
    ('Accelerator "bvh"', 'Shape "sphere"\n' + MESH, "bvh"),
]
AREA_CASES = [
    # A mesh emitter parses (brute force); the case keeps its original id.
    pytest.param("", 'AreaLightSource "area"\n' + MESH, None,
                 id='-AreaLightSource "area"\n' + MESH +
                 '-area lights on shape'),
    # An area light on a cone loads as tpuprt's (the cone emits nothing),
    # any AreaLightSource name reads as "area", and an emissive object
    # alone (never instanced) loads with an empty main aggregate, whose
    # render raises as tpuprt's does (test_torch_operability.py); the
    # cases keep their ids from when the port refused them.
    pytest.param("", 'AreaLightSource "area"\nShape "cone"\n', None,
                 id='-AreaLightSource "area"\nShape "cone"\n'
                 '-area lights on shape'),
    pytest.param("", 'AreaLightSource "goniometric"\n' + MESH, None,
                 id='-AreaLightSource "goniometric"\n' + MESH +
                 '-not ported'),
    pytest.param("", 'AreaLightSource "area"\nObjectBegin "o"\n' + MESH +
                 'ObjectEnd\n', None,
                 id='-AreaLightSource "area"\nObjectBegin "o"\n' + MESH +
                 'ObjectEnd\n-instanced area emitters'),
]


def check_policy(accel, body, result):
    """BASE with `accel` and `body` builds the accelerator named by
    `result` (None: none), or raises NotImplementedError matching it."""
    text = BASE.format(accel=accel, body=body)
    built = {None: type(None), "bvh": BvhAccel, "grid": GridAccel,
             "kdtree": KdTreeAccel}
    if result in built:
        scene, _ = load_scene_string(text)
        assert type(scene.accel) is built[result]
        return
    with pytest.raises(NotImplementedError, match=result):
        load_scene_string(text)
