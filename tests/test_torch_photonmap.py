"""Photon mapping in the port held against tpuprt on the CPU: config6 (the
Cornell box with a disk light, matte walls and a mirror sphere;
SurfaceIntegrator "photonmap").

- The parser reads config6, bench6 and bench6ng into tpuprt's tables and
  PhotonParams.
- sample_emission per lane on config6's disk light, and on a scene with a
  point, a distant and a constant infinite light.
- shoot_batch per (depth, path): deposits and their classes, positions,
  directions and power.
- build_maps with small targets: the photons each map keeps and its
  n_paths (the path that filled it).
- build_photon_grid from the same numpy photons, a bucket over the cap
  (thinned): equal tables.
- lphoton at random points, on matte (the diffuse shortcut) and on plastic
  (the per-photon glossy branch).
- The pool's mode "photonmap" at 16x16 x 2 spp with tpuprt's maps carried
  across, with the final gather (2 samples) and without.

The parsed tables, the emission and the grid build are in
test_torch_photonmap_parts.py (no file holds more than ten cases).
"""
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from test_torch_bvh import numpy_tables
from test_torch_path import unit
from tpuprt.bsdf import bsdf as jB
from tpuprt.integrators import path_wavefront as jax_pool
from tpuprt.integrators import photonmap as jpm
from tpuprt.materials import factory as jF
from tpuprt.scene.parser import load_scene_string as jax_load
from tpuprt_torch import render as torch_render
from tpuprt_torch.bsdf import bsdf as tB
from tpuprt_torch.integrators import photonmap as tpm
from tpuprt_torch.materials import factory as tF
from tpuprt_torch.scene.bridge import photon_maps_from_numpy
from tpuprt_torch.scene.parser import load_scene_string

torch.set_num_threads(1)
_SCENES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenes")
N = 4096
RES, SPP = 16, 2
# build_maps at a test size: targets the mirror's caustics fill within
# max_shot, in 4096-path batches.
SMALL = dict(caustic=500, direct=4000, indirect=4000, batch=4096,
             max_shot=32768)
LIGHTS = ('LightSource "point" "point from" [0.3 0.5 -0.2] '
          '"color I" [0.8 0.7 0.6]\n'
          'LightSource "distant" "point from" [1 3 -2] "point to" [0 0 0] '
          '"color L" [1.5 1.4 1.2]\n'
          'LightSource "infinite" "color L" [0.3 0.4 0.5]\n')


def scene_text(name="config6", res=None, spp=None):
    with open(os.path.join(_SCENES, f"{name}.pbrt")) as f:
        text = f.read()
    if res:
        text = text.replace('"integer xresolution" [64] "integer '
                            'yresolution" [64]', f'"integer xresolution" '
                            f'[{res}] "integer yresolution" [{res}]')
    if spp:
        text = text.replace('"integer pixelsamples" [4]',
                            f'"integer pixelsamples" [{spp}]')
    return text


def lights_text():
    """config6 lit by a point, a distant and an infinite light in place of
    its disk."""
    text = scene_text()
    start = text.index("AttributeBegin\n  AreaLightSource")
    end = text.index("AttributeEnd\n", start) + len("AttributeEnd\n")
    return text[:start] + LIGHTS + text[end:]


@pytest.fixture(scope="module")
def config6():
    text = scene_text(res=RES, spp=SPP)
    return jax_load(text) + load_scene_string(text)


@pytest.fixture(scope="module")
def jax_maps(config6):
    """tpuprt's maps with SMALL's targets, and the photons and n_paths each
    map was built from (recorded at build_photon_grid)."""
    jscene, jopts = config6[:2]
    return _recorded_build(jpm, lambda: jpm.build_maps(
        jscene, jopts.photon._replace(**SMALL), 0))


def _recorded_build(module, build):
    built = []
    real = module.build_photon_grid

    def spy(p, wi, alpha, radius, n_paths, *a):
        built.append((np.array(p), np.array(alpha), n_paths))
        return real(p, wi, alpha, radius, n_paths, *a)
    module.build_photon_grid = spy
    try:
        return build(), built
    finally:
        module.build_photon_grid = real


def test_shoot_batch_matches_tpuprt(config6):
    """Per (depth, path): deposits and classes equal on all but at most
    0.1% of the paths (a tie or a graze sends a path elsewhere). Positions,
    directions and power: all within 1e-3 and 99.9% within 1e-4. The mirror
    sphere's normal rounds differently under XLA's contracted multiply-adds,
    and each bounce after a mirror hit carries that difference on: a few
    deposits past depth 4 differ by about 1.0e-4."""
    jscene, _, tscene, _ = config6
    jout = [np.asarray(x) for x in jpm.shoot_batch(jscene, 0, N, 8, 0)]
    tout = [x.numpy() for x in tpm.shoot_batch(tscene, 0, N, 8, 0)]
    same = (jout[4] == tout[4]) & (jout[3] == tout[3])
    assert np.mean(~same.all(0)) <= 1e-3
    valid = jout[4] & same.all(0)
    assert valid.sum() > 8000 and (jout[3][valid] == 1).sum() > 50
    err = np.concatenate([np.abs(t[valid] - j[valid]).max(-1) /
                          np.maximum(1.0, np.abs(j[valid]).max(-1))
                          for j, t in zip(jout[:3], tout[:3])])
    assert err.max() <= 1e-3 and np.mean(err <= 1e-4) >= 0.999, err.max()


def test_build_maps_matches_tpuprt(config6, jax_maps):
    """Every map keeps the same photons (counts, positions) and the same
    n_paths: the two packages' shooting loops stop at the same batch."""
    tscene, topts = config6[2:]
    stats = {}
    _, built = _recorded_build(tpm, lambda: tpm.build_maps(
        tscene, topts.photon._replace(**SMALL), 0, stats=stats))
    for (jp, ja, jn), (tp, ta, tn), k in zip(jax_maps[1], built,
                                             ("direct", "caustic",
                                              "indirect")):
        assert len(tp) == len(jp) == stats[k]["photons"] == SMALL[k], k
        assert tn == jn == stats[k]["n_paths"], k
        np.testing.assert_allclose(tp, jp, atol=1e-3, err_msg=k)
        np.testing.assert_allclose(ta, ja, rtol=1e-4, err_msg=k)
    # The caustics (the mirror's) fill last.
    assert stats["caustic"]["filled_at_batch"] == stats["batches"] > \
        stats["direct"]["filled_at_batch"]


@pytest.mark.parametrize("material", ["matte", "plastic"])
def test_lphoton_matches_tpuprt(config6, jax_maps, material):
    """Random points near the walls (where the photons are), shading
    normals and wo per lane, a tenth inactive; matte on each of the three
    maps, plastic on the caustic map (its per-photon f runs for every
    (point, cell, slot), seconds a map on one CPU thread)."""
    text = scene_text().replace(
        'Material "matte" "color Kd" [0.73 0.73 0.73]',
        'Material "plastic" "color Kd" [0.4 0.4 0.4] "color Ks" '
        '[0.5 0.5 0.5] "float roughness" [0.05]') \
        if material == "plastic" else scene_text()
    tscene = load_scene_string(text)[0]
    jm, tm = jax_load(text)[0].materials, tscene.materials
    wall = tm.kind.tolist().index(tF.MAT_PLASTIC if material == "plastic"
                                  else tF.MAT_MATTE)
    rng = np.random.default_rng(6)
    mat = np.full(N, wall, np.int32)
    tex = rng.uniform(0.05, 1.0, (tscene.textures.fparams.shape[0], N, 3)
                      ).astype(np.float32)
    axis = rng.integers(0, 3, N)
    p = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    p[np.arange(N), axis] = np.where(rng.uniform(size=N) < 0.5, -1.0, 1.0)
    p += rng.normal(0, 0.02, (N, 3)).astype(np.float32)
    ng = np.zeros((N, 3), np.float32)
    ng[np.arange(N), axis] = -np.sign(p[np.arange(N), axis])
    nn = ng + rng.normal(0, 0.1, (N, 3)).astype(np.float32)
    nn /= np.linalg.norm(nn, axis=1, keepdims=True)
    dpdu, wo = unit(rng, N), unit(rng, N)
    wo = np.where((wo * ng).sum(1, keepdims=True) < 0, -wo, wo)
    active = rng.uniform(size=N) < 0.9
    jb = jB.BsdfBatch(*jB.make_frame(*map(jnp.asarray, (nn, dpdu, ng))),
                      lobes=jF.make_lobes(jm, jnp.asarray(mat),
                                          jnp.asarray(tex)))
    tb = tB.BsdfBatch(*tB.make_frame(*map(torch.from_numpy,
                                           (nn, dpdu, ng))),
                      lobes=tF.make_lobes(tm, torch.from_numpy(mat),
                                          torch.from_numpy(tex)))
    glossy = material == "plastic"
    assert (tB.BX_MICROFACET in tm.lobe_kinds) == glossy
    maps = photon_maps_from_numpy(numpy_tables(jax_maps[0]), "cpu")
    for k in ("caustic",) if glossy else ("direct", "caustic", "indirect"):
        jl = np.asarray(jpm.lphoton(getattr(jax_maps[0], k), jb,
                                    jnp.asarray(wo), jnp.asarray(p),
                                    jnp.asarray(active), glossy))
        tl = tpm.lphoton(getattr(maps, k), tb, torch.from_numpy(wo),
                         torch.from_numpy(p), torch.from_numpy(active),
                         glossy).numpy()
        assert (jl.max(-1) > 0).sum() > N // 4, k
        np.testing.assert_allclose(tl, jl, rtol=1e-5,
                                   atol=1e-5 * jl.max(), err_msg=k)


@pytest.mark.parametrize("final_gather", [True, False])
def test_pool_matches_tpuprt(config6, jax_maps, final_gather):
    """test_torch_render's rule: 99.5% of pixels within atol = rtol =
    1e-4, alpha equal; tpuprt's maps carried across."""
    jscene, jopts, tscene, topts = config6
    prm = jopts.photon._replace(final_gather=final_gather, gather_samples=2)
    jrgb, jalpha = jax_pool.render(jscene, jopts._replace(photon=prm),
                                   aux=jax_maps[0])
    maps = photon_maps_from_numpy(numpy_tables(jax_maps[0]), "cpu")
    trgb, talpha = torch_render.render(
        tscene, topts._replace(photon=tpm.PhotonParams(**prm._asdict())),
        device="cpu", maps=maps)
    assert trgb.shape == (RES, RES, 3) and np.isfinite(trgb).all()
    np.testing.assert_array_equal(talpha, jalpha)
    close = np.isclose(trgb, jrgb, atol=1e-4, rtol=1e-4).all(-1)
    assert close.mean() >= 0.995, close.mean()
    assert trgb.max() > 1.0     # the light is seen


def test_maps_bridge_keeps_tables(jax_maps):
    maps = photon_maps_from_numpy(numpy_tables(jax_maps[0]), "cpu")
    for k in ("direct", "caustic", "indirect"):
        j, t = getattr(jax_maps[0], k), getattr(maps, k)
        assert (t.radius, t.n_buckets, t.bucket_cap, t.count) == \
            (j.radius, j.n_buckets, j.bucket_cap, j.count)
        assert float(t.n_paths) == float(j.n_paths)
        np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed))
