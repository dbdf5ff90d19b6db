"""Every light kind of the port held against tpuprt on the CPU with the same
seeded inputs: spot, projection and goniometric lights with their maps, a
mapped infinite light, an infinitesample light, and an area light on a
triangle mesh (with a zero-area triangle, so its area CDF has a flat
step). The maps are a few texels a side (tpuprt's trace of the pool
unrolls a bilinear tap per MIP level per lookup).

- The scene's tables, parsed by both packages from one file whose maps
  are named relative to it, are equal (images, importance tables, area
  CDF, the light roster).
- lights.sample and lights.pdf per lane at random points, with the mesh
  emitter's pick uniform set onto its CDF's values on some lanes (the
  search's tie rule).
- lights.power and emission.sample_emission per lane.
- An emissive sphere whose quadric index is at or above the triangle
  count, alone and beside a mesh emitter: lights.sample and
  sample_emission per lane (the mesh emitter's triangle pick must not
  index past the triangles on the sphere's lanes).
- tests/test_envlight.py's three properties on the port.
- A 16x16 x 2 spp directlighting render of the scene with every light and
  the textured, bump-mapped ground through both packages' pools.

Per-lane tolerance, unless a test says otherwise, tests/test_torch_path.py's
rtol 2e-4, atol 1e-6.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from test_torch_bvh import assert_tables_equal, numpy_tables
from test_torch_textures import textures_scene
from tpuprt.integrators import path_wavefront as jax_pool
from tpuprt.lights import emission as jem, lights as jlt
from tpuprt.scene.parser import load_scene as jax_load_file
from tpuprt.scene.parser import load_scene_string as jax_load_string
from tpuprt_torch import render as torch_render
from tpuprt_torch.io.mipmap_build import build_pyramid
from tpuprt_torch.lights import emission as tem, lights as tlt
from tpuprt_torch.scene import data as D
from tpuprt_torch.scene.bridge import from_numpy_tables
from tpuprt_torch.scene.build import SceneBuilder
from tpuprt_torch.scene.parser import load_scene, load_scene_string

torch.set_num_threads(1)
N = 4096
RTOL, ATOL = 2e-4, 1e-6


def close(t, j, what, rtol=RTOL, atol=ATOL, mask=None):
    t, j = t.numpy(), np.asarray(j)
    if mask is not None:
        t, j = t[mask], j[mask]
    np.testing.assert_allclose(t, j, rtol=rtol, atol=atol, err_msg=what)


def fan(n=10, r=0.6, y=2.5, seed=0):
    """A downward-facing fan of n triangles in the plane y with uneven
    angular steps, one of them zero (a zero-area triangle)."""
    rng = np.random.default_rng(seed)
    steps = rng.uniform(0.5, 1.5, n)
    steps[n // 2] = 0.0
    th = np.concatenate([[0.0], np.cumsum(steps)]) * 2 * np.pi / steps.sum()
    P = [[0, y, 0]] + [[r * np.cos(a), y, r * np.sin(a)] for a in th]
    idx = [[0, i + 1, i + 2] for i in range(n)]
    return (f'"integer indices" [{" ".join(str(i) for t in idx for i in t)}]'
            f' "point P" [{" ".join(f"{x:.6g}" for p in P for x in p)}]')


LIGHTS = f'''
LightSource "spot" "point from" [2 5 -2] "point to" [0 0 0]
    "float coneangle" [25] "float conedeltaangle" [8] "color I" [30 30 30]
AttributeBegin
Translate -1 4 -1
Rotate 75 1 0 0
LightSource "projection" "string mapname" "maps/slide.exr" "float fov" [40]
    "color I" [20 20 20]
AttributeEnd
AttributeBegin
Translate 0.5 3 1
Rotate 90 1 0 0
LightSource "goniometric" "string mapname" "maps/gonio.exr" "color I" [8 8 8]
AttributeEnd
AttributeBegin
Rotate -90 1 0 0
LightSource "infinitesample" "string mapname" "maps/sky.exr"
    "color L" [0.5 0.5 0.5]
LightSource "infinite" "string mapname" "maps/sky.exr" "color L" [0.3 0.3 0.3]
AttributeEnd
AttributeBegin
AreaLightSource "area" "color L" [4 3.5 3]
Shape "trianglemesh" {fan()}
AttributeEnd
'''
# A few cheap textures: the ground's Kd a mix of an EWA imagemap and a
# colour by a bilinear amount, its bump a scale of that amount (tpuprt's
# pool compiles every node three times over with bump).
TEXTURES = """
Texture "img" "color" "imagemap" "string filename" "maps/tex.exr"
Texture "amt" "float" "bilerp" "float v00" [0.1] "float v01" [0.9]
    "float v10" [0.6] "float v11" [0.3]
Texture "kd" "color" "mix" "texture tex1" "img" "color tex2" [0.3 0.5 0.2]
    "texture amount" "amt"
Texture "scl" "float" "constant" "float value" [0.08]
Texture "bumpy" "float" "scale" "texture tex1" "amt" "texture tex2" "scl"
"""
SHAPES = """
AttributeBegin
Material "matte" "texture Kd" "kd" "texture bumpmap" "bumpy"
Shape "trianglemesh" {ground}
AttributeEnd
"""
KINDS = [D.LIGHT_SPOT, D.LIGHT_PROJECTION,
         D.LIGHT_GONIOMETRIC, D.LIGHT_INFINITE, D.LIGHT_INFINITE,
         D.LIGHT_AREA]


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    path = textures_scene(str(tmp_path_factory.mktemp("lights")), LIGHTS,
                          textures=TEXTURES, shapes=SHAPES, k=8)
    jscene, jopts = jax_load_file(path)
    tscene, topts = load_scene(path)
    return jscene, tscene, jopts, topts


def lanes(tscene, seed):
    """Random points above the ground, normals, light ids over every light
    and four uniforms; on every 8th lane the mesh emitter's pick uniform
    is one of its CDF's values."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    p = rng.uniform([-2, 0, -2], [2, 2, 2], (N, 3)).astype(f32)
    n = rng.normal(size=(N, 3)).astype(f32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    lid = rng.integers(0, tscene.lights.count, N).astype(np.int32)
    u = rng.uniform(0, 1, (5, N)).astype(f32)
    lt = tscene.lights
    mesh = lt.kinds_list.index(D.LIGHT_AREA)
    off, cnt = int(lt.cdf_offset[mesh]), int(lt.area_count[mesh])
    cdf = lt.area_cdf.numpy()[off:off + cnt + 1]
    u[2, ::8] = rng.choice(cdf[:-1], N // 8 + (N % 8 > 0))
    u[4, ::8] = u[2, ::8]
    return p, n, lid, u


def test_tables_equal_tpuprts(scenes, tmp_path):
    """The tables equal tpuprt's; and a scene holding every light and every
    texture class with a bumpmap, its maps named relative to it, renders
    on the CPU in the port (8x8 x 1 spp, finite and lit)."""
    full = textures_scene(str(tmp_path), LIGHTS, res=8, spp=1, k=8)
    rgb, _ = torch_render.render(*load_scene(full), device="cpu")
    assert np.isfinite(rgb).all() and rgb.mean() > 0.05
    jscene, tscene, _, _ = scenes
    lt = tscene.lights
    assert list(lt.kinds_list) == KINDS
    # tex.exr, slide.exr, gonio.exr, sky.exr shared by both infinite
    # lights.
    assert len(tscene.env_importance) == 1 and tscene.images.count == 4
    assert [m[2] for m in lt.infinite_meta] == [0, -1]
    assert all(m[1] >= 0 for m in lt.infinite_meta)
    assert len(lt.dir_map_meta) == 2
    mesh = KINDS.index(D.LIGHT_AREA)
    assert int(lt.area_geom_kind[mesh]) == D.AREA_GEOM_TRIS
    off, cnt = int(lt.cdf_offset[mesh]), int(lt.area_count[mesh])
    cdf = lt.area_cdf.numpy()[off:off + cnt + 1]
    assert cnt == 10 and (np.diff(cdf) == 0).sum() == 1
    assert (tscene.triangles.area_light.numpy() == mesh).sum() == 10
    assert_tables_equal(tscene, from_numpy_tables(numpy_tables(jscene),
                                                  "cpu"))


def test_sample_and_pdf_match_tpuprt(scenes):
    jscene, tscene, _, _ = scenes
    p, n, lid, u = lanes(tscene, 1)
    js = jlt.sample(jscene, *map(jnp.asarray, (lid, p, n, *u[:3])))
    ts = tlt.sample(tscene, *map(torch.from_numpy, (lid, p, n, *u[:3])))
    for k in ("delta",):
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
    for k in ("Li", "wi", "pdf", "vis_maxt"):
        close(ts[k], js[k], k)
    kinds = np.asarray(KINDS)[lid]
    li = ts["Li"].numpy()
    for k in set(KINDS):
        lit = (li[kinds == k] > 0).any(-1)
        assert lit.sum() > N // 40, k      # every kind gives light
    # The spot's cone and the projection's window cut some lanes to 0.
    for k in (D.LIGHT_SPOT, D.LIGHT_PROJECTION):
        assert not (li[kinds == k] > 0).any(-1).all(), k
    # pdf toward random directions, and toward the sampled ones. The map's
    # pdf divides by sin(theta) of theta = acos(z): a difference of 4 ulp
    # (2.4e-7) in the light-space z moves sin(theta) by 2.4e-7 /
    # sin(theta)^2 relative, which near the map's poles passes rtol 2e-4;
    # each lane's rtol is 2e-4 plus that.
    wi = np.random.default_rng(2).normal(size=(N, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    w2l = tscene.lights.w2l.numpy()[lid, :3, :3]
    for w, what in ((wi, "random"), (np.asarray(js["wi"]).copy(),
                                     "sampled")):
        tp = tlt.pdf(tscene, *map(torch.from_numpy, (lid, p, n, w))).numpy()
        jp = np.asarray(jlt.pdf(jscene, *map(jnp.asarray, (lid, p, n, w))))
        zl = np.einsum("nij,nj->ni", w2l, w)[:, 2]
        rtol = RTOL + 2.4e-7 / np.maximum(1.0 - zl * zl, 1e-12)
        bad = np.abs(tp - jp) > ATOL + rtol * np.abs(jp)
        assert not bad.any(), (what, tp[bad], jp[bad], zl[bad])


def test_power_and_emission_match_tpuprt(scenes):
    jscene, tscene, _, _ = scenes
    close(tlt.power(tscene), jlt.power(jscene), "power")
    _, _, lid, u = lanes(tscene, 3)
    je = jem.sample_emission(jscene, jnp.asarray(lid), *map(jnp.asarray, u))
    te = tem.sample_emission(tscene, torch.from_numpy(lid),
                             *map(torch.from_numpy, u))
    for k in ("o", "d", "pdf", "Le"):
        close(te[k], je[k], k, rtol=1e-5 if k != "Le" else RTOL, atol=1e-5)
    kinds = np.asarray(KINDS)[lid]
    # A mesh emitter's photons leave its triangles, downward.
    mesh = kinds == D.LIGHT_AREA
    assert np.allclose(te["o"].numpy()[mesh, 1], 2.5)
    assert (te["d"].numpy()[mesh, 1] < 0).all()
    assert (te["Le"].numpy()[kinds == D.LIGHT_GONIOMETRIC] > 0).all()


# A 2-triangle floor and five quadrics, the fifth an emitting sphere: its
# quadric index, 4, passes the triangle count, and equals it with MESH, a
# 2-triangle emissive quad, added.
SPHERES = """LookAt 0 3 -6  0 0 0  0 1 0
Camera "perspective" "float fov" [50]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
PixelFilter "box"
SurfaceIntegrator "directlighting"
WorldBegin
LightSource "point" "point from" [0 4 0] "color I" [5 5 5]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-3 0 -3  3 0 -3  3 0 3  -3 0 3]
AttributeBegin
Translate -1 0.5 0
Shape "sphere" "float radius" [0.4]
AttributeEnd
AttributeBegin
Translate 1 0.5 0
Shape "disk" "float radius" [0.4]
AttributeEnd
AttributeBegin
Translate 0 0.5 -1
Shape "sphere" "float radius" [0.3]
Shape "disk" "float radius" [0.3]
AttributeEnd
AttributeBegin
Translate 0 2 1
AreaLightSource "area" "color L" [3 3 3]
Shape "sphere" "float radius" [0.3]
AttributeEnd
{mesh}WorldEnd
"""
MESH = """AttributeBegin
AreaLightSource "area" "color L" [2 2 2]
Shape "trianglemesh" "integer indices" [0 2 1 0 3 2]
    "point P" [-0.5 2.5 -0.5  0.5 2.5 -0.5  0.5 2.5 0.5  -0.5 2.5 0.5]
AttributeEnd
"""


@pytest.mark.parametrize("mesh", ["", MESH], ids=["sphere", "sphere+mesh"])
def test_sphere_emitter_past_triangle_count(mesh):
    text = SPHERES.format(mesh=mesh)
    jscene, _ = jax_load_string(text)
    tscene, _ = load_scene_string(text)
    area = [i for i, k in enumerate(tscene.lights.kinds_list)
            if k == D.LIGHT_AREA]
    sphere = area[0]
    assert int(tscene.lights.area_geom_kind[sphere]) == D.AREA_GEOM_QUADRIC
    assert int(tscene.lights.area_first[sphere]) >= \
        tscene.triangles.count == 2 + 2 * bool(mesh)
    n = 1024
    rng = np.random.default_rng(5)
    f32 = np.float32
    p = rng.uniform([-2, 0.05, -2], [2, 1.5, 2], (n, 3)).astype(f32)
    nrm = np.tile(np.array([[0, 1, 0]], f32), (n, 1))
    lid = rng.choice(np.asarray(area, np.int32), n).astype(np.int32)
    u = rng.uniform(0, 1, (5, n)).astype(f32)
    js = jlt.sample(jscene, *map(jnp.asarray, (lid, p, nrm, *u[:3])))
    ts = tlt.sample(tscene, *map(torch.from_numpy, (lid, p, nrm, *u[:3])))
    for k in ("Li", "wi", "pdf", "vis_maxt"):
        close(ts[k], js[k], k)
    assert (ts["Li"].numpy()[lid == sphere] > 0).any()
    je = jem.sample_emission(jscene, jnp.asarray(lid), *map(jnp.asarray, u))
    te = tem.sample_emission(tscene, torch.from_numpy(lid),
                             *map(torch.from_numpy, u))
    for k in ("o", "d", "pdf", "Le"):
        close(te[k], je[k], k, rtol=1e-5 if k != "Le" else RTOL, atol=1e-5)
    # The sphere's photons leave its surface.
    r = np.linalg.norm(te["o"].numpy()[lid == sphere] - [0, 2, 1], axis=1)
    np.testing.assert_allclose(r, 0.3, atol=1e-5)


def _env_scene(importance):
    """tests/test_envlight.py's scene in the port: a 32x16 map, a small
    bright spot on a dim background."""
    img = np.full((16, 32, 3), 0.01, np.float32)
    img[4:6, 10:13] = 50.0
    b = SceneBuilder()
    iid = b.add_image(build_pyramid(img), wrap=0)
    b.add_infinite_light(np.eye(4, dtype=np.float32), L=(1.0,) * 3,
                         image=iid, importance=importance)
    b.add_trianglemesh(np.eye(4), [[0, 1, 2]], np.asarray(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32))
    return b.build()


def test_env_importance_properties():
    """tests/test_envlight.py's three properties: the pdf integrates to 1
    over the sphere (quadrature, within 2e-2); importance sampling's
    estimate of the map's cosine integral matches quadrature within 5%
    (cosine sampling's within 50%) at under 5% of cosine sampling's
    variance; pdf() at the sampled directions matches sample()'s pdf
    (rtol 5e-3)."""
    nt, np_ = 256, 512
    theta = (np.arange(nt) + 0.5) * np.pi / nt
    phi = (np.arange(np_) + 0.5) * 2 * np.pi / np_
    T, P = np.meshgrid(theta, phi, indexing="ij")
    d = np.stack([np.sin(T) * np.cos(P), np.sin(T) * np.sin(P), np.cos(T)],
                 -1).reshape(-1, 3).astype(np.float32)
    w = (np.sin(T) * (np.pi / nt) * (2 * np.pi / np_)).reshape(-1)
    axis = np.asarray([0.0, 0.0, 1.0], np.float32)
    scene = _env_scene(True)

    def const(x, n):
        return torch.from_numpy(np.broadcast_to(x, (n,) + np.shape(x)).copy())
    B = d.shape[0]
    lid0 = torch.zeros(B, dtype=torch.int32)
    pdfs = tlt.pdf(scene, lid0, const(np.zeros(3, np.float32), B),
                   const(axis, B), torch.from_numpy(d)).numpy()
    assert abs(float((pdfs * w).sum()) - 1.0) < 2e-2
    Lq = tlt.env_radiance(scene, lid0, torch.from_numpy(d)).numpy()[:, 0]
    truth = float((Lq * np.abs(d @ axis) * w).sum())

    rng = np.random.default_rng(7)
    n = 4096
    u = [torch.from_numpy(rng.random(n, np.float32)) for _ in range(3)]
    p0, nrm = const(np.zeros(3, np.float32), n), const(axis, n)
    lid = torch.zeros(n, dtype=torch.int32)
    est, var = {}, {}
    for name, sc in (("is", scene), ("cos", _env_scene(False))):
        sm = tlt.sample(sc, lid, p0, nrm, *u)
        pdf = sm["pdf"].numpy()
        c = np.where(pdf > 0, sm["Li"].numpy()[:, 0] * np.abs(
            sm["wi"].numpy() @ axis) / np.maximum(pdf, 1e-20), 0.0)
        est[name], var[name] = c.mean(), c.var()
        if name == "is":
            ok = pdf > 0
            np.testing.assert_allclose(
                tlt.pdf(sc, lid, p0, nrm, sm["wi"]).numpy()[ok], pdf[ok],
                rtol=5e-3)
    assert abs(est["is"] - truth) < 0.05 * truth, (est, truth)
    assert abs(est["cos"] - truth) < 0.5 * truth, (est, truth)
    assert var["is"] < 0.05 * var["cos"], var


def test_directlighting_render_matches_tpuprt(scenes):
    """Every light and the textured, bump-mapped ground through both
    packages' pools (directlighting, strategy "all"), 16x16 x 2 spp: every
    sample uses the same streams, so pixels agree to float rounding, as in
    tests/test_torch_path.py (99.5% of pixels within atol = rtol = 1e-4,
    alpha equal). A pixel may differ more where a grazing ray's hit, an
    fbm octave count or a MIP level sits at a rounding boundary."""
    jscene, tscene, jopts, topts = scenes
    assert topts.integrator == jopts.integrator == "directlighting"
    assert (topts.xres, topts.sampler.pixelsamples) == (16, 2)
    jrgb, jalpha = jax_pool.render(jscene, jopts)
    trgb, talpha = torch_render.render(tscene, topts, device="cpu")
    assert trgb.shape == (16, 16, 3) and np.isfinite(trgb).all()
    np.testing.assert_array_equal(talpha, jalpha)
    close_px = np.isclose(trgb, jrgb, atol=1e-4, rtol=1e-4).all(-1)
    assert close_px.mean() >= 0.995, close_px.mean()
    assert trgb.mean() > 0.05
