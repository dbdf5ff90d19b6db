"""The texture graph, the MIPMap and bump mapping in the port, held against
tpuprt on the CPU with the same seeded inputs.

- build_pyramid equals tpuprt's bit for bit (powers of two, a resampled
  non-power-of-two image, a one-row image).
- mipmap_lookup_tri and mipmap_lookup_ewa in every wrap mode, per lane.
- eval_graph on random differential geometry over a scene holding every
  texture class and every mapping (parsed by both packages from the same
  file, its imagemaps named relative to it), per node and lane.
- Material::Bump's shading normal and perturbed dpdu, dpdv.
- Analogues of tests/test_differentials.py: the MIP level follows the
  footprint; the supersampled checkerboard lies between point sampling
  and the closed form.
- The new modules import no JAX and nothing of tpuprt.

Tolerance, unless a test says otherwise, the per-lane one of
tests/test_torch_path.py: rtol 2e-4, atol 1e-6 (XLA:CPU contracts
multiply-adds and rounds log2, atan2, acos, sin differently from torch).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from test_torch_bvh import assert_tables_equal, numpy_tables
from tpuprt.integrators import common as jC
from tpuprt.io import mipmap_build as jmip
from tpuprt.scene.parser import load_scene as jax_load_file
from tpuprt.textures import graph as jG
from tpuprt_torch.integrators import common as tC
from tpuprt_torch.io import mipmap_build as tmip
from tpuprt_torch.io.exr import write_exr
from tpuprt_torch.scene.bridge import from_numpy_tables
from tpuprt_torch.scene.build import pack_images
from tpuprt_torch.scene.parser import load_scene
from tpuprt_torch.textures import graph as tG

torch.set_num_threads(1)
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 2048
RTOL, ATOL = 2e-4, 1e-6


def close(t, j, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol,
                               atol=atol, err_msg=what)


def write_maps(d, seed=0, k=1):
    """The image maps of the test scenes, made from `seed` and written as
    half EXRs into directory `d`: a 24x40 texture (not a power of two), a
    32x16 sky with a small bright sun, a 16x16 slide, a 32x16
    goniometric map; each side divided by k."""
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    h, w = 16 // k, 32 // k
    sky = np.full((h, w, 3), 0.2, np.float32)
    sky[:h // 2] += np.linspace(0.6, 0.0, h // 2,
                                dtype=np.float32)[:, None, None]
    sky[3 * h // 16:max(5 * h // 16, 3 * h // 16 + 1),
        5 * w // 8:max(11 * w // 16, 5 * w // 8 + 1)] = 40.0
    maps = {"tex.exr": rng.uniform(0.05, 1.0, (24 // k, 40 // k, 3)),
            "sky.exr": sky,
            "slide.exr": rng.uniform(0.0, 1.0, (16 // k, 16 // k, 3)),
            "gonio.exr": rng.uniform(0.2, 1.0, (16 // k, 32 // k, 3))}
    for name, img in maps.items():
        write_exr(os.path.join(d, name), np.asarray(img, np.float32))
    return d


def grid_mesh(n=6, size=4.0, y=0.0):
    """An n x n quad grid in the plane y, uv over [0, 2]^2, as
    trianglemesh parameters."""
    t = np.linspace(-size / 2, size / 2, n + 1)
    xs, zs = np.meshgrid(t, t)
    P = np.stack([xs, np.full_like(xs, y), zs], -1).reshape(-1, 3)
    uv = np.stack(np.meshgrid(np.linspace(0, 2, n + 1),
                              np.linspace(0, 2, n + 1)), -1).reshape(-1, 2)
    idx = []
    for i in range(n):
        for j in range(n):
            a = i * (n + 1) + j
            idx += [a, a + n + 1, a + 1, a + 1, a + n + 1, a + n + 2]

    def fmt(a):
        return " ".join(f"{x:.6g}" for x in np.ravel(a))
    return (f'"integer indices" [{fmt(idx)}] "point P" [{fmt(P)}] '
            f'"float uv" [{fmt(uv)}]')


TEXTURES = '''
Texture "img" "color" "imagemap" "string filename" "maps/tex.exr"
    "float uscale" [1.5] "float vscale" [2.5]
Texture "imgtri" "color" "imagemap" "string filename" "maps/tex.exr"
    "bool trilinear" "true" "string wrap" "clamp"
Texture "imgblack" "float" "imagemap" "string filename" "maps/tex.exr"
    "string wrap" "black" "string mapping" "spherical"
Texture "imgcyl" "color" "imagemap" "string filename" "maps/slide.exr"
    "string mapping" "cylindrical" "bool trilinear" "true"
Texture "imgplanar" "color" "imagemap" "string filename" "maps/slide.exr"
    "string mapping" "planar" "vector v1" [0.5 0 0.2] "vector v2" [0 0.3 0.4]
    "float udelta" [0.1] "float vdelta" [0.3]
Texture "noise" "float" "fbm" "integer octaves" [6] "float roughness" [0.6]
Texture "wr" "float" "wrinkled" "float roughness" [0.4]
Texture "amp" "float" "constant" "float value" [0.05]
Texture "bumpy" "float" "scale" "texture tex1" "wr" "texture tex2" "amp"
Texture "kd" "color" "mix" "texture tex1" "img" "color tex2" [0.3 0.5 0.2]
    "texture amount" "noise"
Texture "cb" "color" "checkerboard" "float uscale" [4] "float vscale" [4]
    "color tex1" [0.9 0.1 0.1] "color tex2" [0.1 0.1 0.9]
Texture "cbss" "color" "checkerboard" "float uscale" [3] "float vscale" [5]
    "string aamode" "supersample"
Texture "cbnone" "color" "checkerboard" "string aamode" "none"
    "string mapping" "spherical"
Texture "cb3" "color" "checkerboard" "integer dimension" [3]
    "texture tex1" "img" "texture tex2" "cb"
Texture "dots" "color" "dots" "float uscale" [5] "float vscale" [5]
    "color inside" [1 0.8 0.2]
Texture "windy" "float" "windy"
TransformBegin
Scale 3 3 3
Texture "marble" "color" "marble" "float scale" [2] "float variation" [0.5]
TransformEnd
Texture "bil" "color" "bilerp" "color v00" [1 0 0] "color v11" [0 0 1]
Texture "uvt" "color" "uv" "string mapping" "cylindrical"
Texture "sc" "color" "scale" "texture tex1" "dots" "texture tex2" "marble"
Texture "odd" "color" "cloud"
'''


SHAPES = """
AttributeBegin
Material "matte" "texture Kd" "kd" "texture bumpmap" "bumpy"
Shape "trianglemesh" {ground}
AttributeEnd
AttributeBegin
Translate 0 1 0
Material "plastic" "texture Kd" "cb3" "texture bumpmap" "noise"
Shape "sphere" "float radius" [0.8]
AttributeEnd
AttributeBegin
Translate 1.5 0.4 -1
Material "matte" "texture Kd" "sc"
Shape "sphere" "float radius" [0.4]
AttributeEnd
"""


POINT = 'LightSource "point" "point from" [1 4 -2] "color I" [12 12 12]'


def textures_scene(d, extra_world=POINT, integrator="directlighting",
                   res=16, spp=2, textures=TEXTURES, shapes=SHAPES, k=1):
    """A scene file in `d` (its maps in d/maps, their sides divided by k):
    by default every texture class and mapping, the ground matte with Kd
    "kd" and bumpmap "bumpy", lit by a point light."""
    write_maps(os.path.join(d, "maps"), k=k)
    text = f'''LookAt 0 3 -6  0 0 0  0 1 0
Camera "perspective" "float fov" [50]
Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}]
Sampler "lowdiscrepancy" "integer pixelsamples" [{spp}]
PixelFilter "box"
SurfaceIntegrator "{integrator}"
WorldBegin
{textures}
{extra_world}
{shapes.format(ground=grid_mesh())}
WorldEnd
'''
    path = os.path.join(d, "scene.pbrt")
    with open(path, "w") as f:
        f.write(text + "\n")
    return path


def random_dg(seed, n=N):
    """Differential geometry over the scenes' extent: p, u, v, dp/dx,y,
    du,v/dx,y (a spread of footprints, some 0), dpdu, dpdv, dndu, dndv,
    normals."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    nn = rng.normal(size=(n, 3)).astype(f32)
    nn /= np.linalg.norm(nn, axis=1, keepdims=True)
    foot = 10.0 ** rng.uniform(-4, 0.5, (n, 1))
    foot[rng.uniform(size=n) < 0.1] = 0.0
    dg = dict(p=rng.uniform(-2.5, 2.5, (n, 3)), u=rng.uniform(-0.5, 2.5, n),
              v=rng.uniform(-0.5, 2.5, n),
              dpdx=rng.normal(size=(n, 3)) * foot,
              dpdy=rng.normal(size=(n, 3)) * foot,
              dudx=rng.normal(size=n) * foot[:, 0],
              dvdx=rng.normal(size=n) * foot[:, 0],
              dudy=rng.normal(size=n) * foot[:, 0],
              dvdy=rng.normal(size=n) * foot[:, 0],
              dpdu=rng.normal(size=(n, 3)), dpdv=rng.normal(size=(n, 3)),
              dndu=rng.normal(size=(n, 3)) * 0.2,
              dndv=rng.normal(size=(n, 3)) * 0.2, nn=nn, sn=nn)
    return {k: np.asarray(v, f32) for k, v in dg.items()}


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The textures scene in both packages (tpuprt's and the port's
    parsers reading the same file), and the port's from tpuprt's tables."""
    path = textures_scene(str(tmp_path_factory.mktemp("textures")))
    jscene = jax_load_file(path)[0]
    tscene = load_scene(path)[0]
    return jscene, tscene


def test_build_pyramid_equals_tpuprts():
    rng = np.random.default_rng(1)
    for shape in ((16, 16, 3), (24, 40, 3), (1, 9, 3), (5, 1, 3)):
        img = rng.uniform(0, 4, shape).astype(np.float32)
        jl, tl = jmip.build_pyramid(img), tmip.build_pyramid(img)
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    x = np.linspace(-1.5, 1.5, 301)
    np.testing.assert_array_equal(tmip.lanczos_np(x), jG.lanczos_np(x))


def test_mipmap_lookups_match_tpuprt_every_wrap():
    """Trilinear and EWA lookups of a resampled 24x40 pyramid in wrap
    modes repeat, black and clamp, with (s, t) past [0, 1] and footprints
    from sub-texel to wider than the image. Per lane rtol 2e-4, atol 1e-6
    except where the level's log2 lies within 1e-5 of an integer: there
    XLA's and torch's log2 may pick neighbouring levels (none of these
    lanes sit closer than that, checked here)."""
    rng = np.random.default_rng(2)
    levels = jmip.build_pyramid(rng.uniform(0, 1, (24, 40, 3)).astype(
        np.float32))
    s = rng.uniform(-0.7, 1.7, N).astype(np.float32)
    t = rng.uniform(-0.7, 1.7, N).astype(np.float32)
    d = (rng.normal(size=(4, N)) * 10.0 ** rng.uniform(-4, 0.3, N)).astype(
        np.float32)
    width = np.abs(d[0]) * 2
    level_f = len(levels) - 1 + np.log2(np.maximum(width, 1e-8))
    assert np.abs(level_f - np.round(level_f)).min() > 1e-5
    for wrap in (0, 1, 2):
        images = pack_images([(levels, wrap)])
        jlv = tuple(jnp.asarray(x) for x in levels)
        jt = jG.mipmap_lookup_tri(jlv, jnp.asarray(s), jnp.asarray(t),
                                  jnp.asarray(width), wrap)
        tt = tG.mipmap_lookup_tri(images, 0, *map(torch.from_numpy,
                                                  (s, t, width)))
        close(tt, jt, f"tri wrap {wrap}")
        je = jG.mipmap_lookup_ewa(jlv, jnp.asarray(s), jnp.asarray(t),
                                  *map(jnp.asarray, d), wrap)
        te = tG.mipmap_lookup_ewa(images, 0, torch.from_numpy(s),
                                  torch.from_numpy(t),
                                  *map(torch.from_numpy, d))
        close(te, je, f"ewa wrap {wrap}")
        if wrap == 1:
            out = (s < 0) | (s > 1) | (t < 0) | (t > 1)
            assert (tt.numpy()[out] == 0).all() and out.sum() > N // 4


def test_eval_graph_matches_tpuprt(scenes):
    """Every node of the scene's graph (every class, the uv, spherical,
    cylindrical, planar and 3D mappings, the three checkerboard AA modes,
    trilinear and EWA imagemaps, a float imagemap, the unknown class's
    gray) per lane. The tables match tpuprt's exactly first."""
    jscene, tscene = scenes
    assert_tables_equal(tscene, from_numpy_tables(numpy_tables(jscene),
                                                  "cpu"))
    kinds = {m.kind for m in tscene.textures.nodes}
    assert kinds == set(tG.KINDS), set(tG.KINDS) - kinds
    maps = {m.mapping for m in tscene.textures.nodes}
    assert {"uv", "spherical", "cylindrical", "planar", "3d"} <= maps
    assert {m.aamode for m in tscene.textures.nodes
            if m.kind == "checkerboard2d"} == set(tG.AAMODES)
    dg = random_dg(3)
    jv = np.asarray(jG.eval_graph(jscene.textures, jscene.images,
                                  {k: jnp.asarray(v) for k, v in dg.items()}))
    tv = tG.eval_graph(tscene.textures, tscene.images,
                       {k: torch.from_numpy(v) for k, v in dg.items()})
    assert tv.shape == jv.shape
    for i, meta in enumerate(tscene.textures.nodes):
        # fbm's octave count and the EWA's level floor log2 of the
        # footprint: lanes within 1e-5 of an integer level may step.
        close(tv[i], jv[i], f"node {i} {meta.kind} {meta.mapping}",
              atol=2e-5 if meta.kind in ("marble", "windy") else ATOL)


def test_bump_matches_tpuprt(scenes):
    """_bump's shading normal and perturbed dpdu, dpdv on the ground's and
    the sphere's materials (both with a bump texture) and on a material
    without one (passed through), the analogue of
    tests/test_fixes.py:70."""
    jscene, tscene = scenes
    dg = random_dg(4)
    mats = np.random.default_rng(5).integers(
        0, tscene.materials.count, N).astype(np.int32)
    assert (tscene.materials.bump.numpy() < 0).any()
    assert tscene.materials.has_bump
    dg["material"] = mats
    jdg = {k: jnp.asarray(v) for k, v in dg.items()}
    tdg = {k: torch.from_numpy(v) for k, v in dg.items()}
    jtv = jG.eval_graph(jscene.textures, jscene.images, jdg)
    ttv = tG.eval_graph(tscene.textures, tscene.images, tdg)
    jb = jC._bump(jscene, jdg, jtv)
    tb = tC._bump(tscene, tdg, ttv)
    has = tscene.materials.bump.numpy()[mats] >= 0
    assert has.sum() > N // 3 and (~has).sum() > N // 10
    for k in ("sn", "dpdu", "dpdv"):
        close(tb[k], jb[k], k, rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(tb["sn"].numpy()[~has], dg["sn"][~has])
    assert np.abs(tb["sn"].numpy()[has] - dg["sn"][has]).max() > 1e-2


def test_mip_level_and_checker_aa_like_tpuprt(scenes):
    """tests/test_differentials.py's properties on the port: a one-texel
    checker image reads its exact 0/1 texels under a sub-texel footprint
    and its mean under a footprint as wide as the image; the closed-form
    checkerboard averages toward 0.5 where point sampling keeps the cell's
    colour; the supersampled one lies near the closed form and below
    point sampling at 1.5 cells, and near 0.5 at 16."""
    from tpuprt_torch.scene.build import SceneBuilder
    img = np.repeat((np.indices((64, 64)).sum(0) % 2)[..., None], 3,
                    -1).astype(np.float32)
    b = SceneBuilder()
    iid = b.add_image(tmip.build_pyramid(img), wrap=0)
    v = np.zeros(16, np.float32)
    v[8] = v[9] = 1.0
    nodes = {"img": b.add_texture(tG.TexNodeMeta(
        kind="imagemap", image=iid, trilinear=True), fparams=v)}
    t1, t2 = b.constant_texture((1.0,) * 3), b.constant_texture((0.0,) * 3)
    for mode in tG.AAMODES:
        nodes[mode] = b.add_texture(tG.TexNodeMeta(
            kind="checkerboard2d", children=(t1, t2), aamode=mode),
            fparams=v)
    b.add_material("matte", [nodes["img"], b.constant_texture(0.0)])
    b.add_trianglemesh(np.eye(4), [[0, 1, 2]], np.asarray(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32))
    b.add_point_light(np.eye(4))
    scene = b.build()

    def ev(node, u, v_, foot):
        u = torch.as_tensor(np.atleast_1d(u), dtype=torch.float32)
        z = torch.zeros_like(u)
        dg = dict(p=torch.zeros(u.shape + (3,)), u=u, v=z + v_,
                  dudx=z + foot, dvdx=z, dudy=z, dvdy=z + foot)
        return tG.eval_graph(scene.textures, scene.images, dg)[node][:, 0]
    u = (np.arange(8) + 0.5) / 64.0
    np.testing.assert_allclose(ev(nodes["img"], u, 0.5 / 64, 1e-6).numpy(),
                               np.arange(8) % 2, atol=1e-5)
    np.testing.assert_allclose(ev(nodes["img"], u, 0.5, 0.5).numpy(), 0.5,
                               atol=0.02)
    for mode, wide in (("closedform", 0.5), ("none", 1.0)):
        assert abs(float(ev(nodes[mode], 0.25, 0.25, 1e-6)) - 1.0) < 1e-5
        assert abs(float(ev(nodes[mode], 0.25, 0.25, 8.0)) - wide) < 0.05
    ss, cf = (float(ev(nodes[m], 0.25, 0.25, 1.5)) for m in
              ("supersample", "closedform"))
    assert abs(float(ev(nodes["supersample"], 0.25, 0.25, 1e-6)) - 1) < 1e-5
    assert ss < 0.98 and abs(ss - cf) < 0.15, (ss, cf)
    assert abs(float(ev(nodes["supersample"], 0.25, 0.25, 16.0)) - 0.5) < 0.1


def test_image_paths_relative_to_the_scene_file(tmp_path):
    """An imagemap's filename and a light's mapname are read from the
    scene file's directory, not the working directory; load_scene_string
    takes that directory as basedir."""
    from tpuprt_torch.scene.parser import load_scene_string
    d = tmp_path / "deep" / "scene"
    write_maps(str(d / "maps"))
    text = ('PixelFilter "box"\n'
            'Texture "t" "color" "imagemap" "string filename" '
            '"maps/tex.exr"\nMaterial "matte" "texture Kd" "t"\n'
            'LightSource "infinitesample" "string mapname" "maps/sky.exr"\n'
            f'Shape "trianglemesh" {grid_mesh(2)}\n')
    path = d / "s.pbrt"
    path.write_text(text)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        scene = load_scene(str(path.relative_to(tmp_path)))[0]
        with pytest.raises(FileNotFoundError):
            load_scene_string(text)
    finally:
        os.chdir(cwd)
    assert scene.images.count == 2 and scene.images.nlevels == (7, 6)
    assert len(scene.env_importance) == 1
    assert load_scene_string(text, str(d))[0].images.texels.shape == \
        scene.images.texels.shape


def test_new_modules_import_no_jax():
    """Every module of the port, imported in a fresh interpreter, brings
    in neither jax nor tpuprt."""
    code = ("import sys, pkgutil, importlib, tpuprt_torch\n"
            "mods = [m.name for m in pkgutil.walk_packages("
            "tpuprt_torch.__path__, 'tpuprt_torch.')]\n"
            "for m in mods: importlib.import_module(m)\n"
            "assert 'tpuprt_torch.io.mipmap_build' in mods\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'tpuprt')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=_ROOT, check=True,
                   timeout=120)
