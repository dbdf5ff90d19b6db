"""The port's other materials held against tpuprt on the CPU: shinymetal,
substrate, translucent, uber and the six measured BRDFs.

- The lobe tables, per lane: both packages' build_templates + make_lobes
  over one material table from the same texture values (random per lane;
  substrate's two roughnesses differ, uber's opacity 0.6): kind, flags,
  the BRDFToBTDF flip, R, eta, k, p, aux0, aux1, and rho_approx.
- f, pdf and sample_f per lane under three masks, translucent's flipped
  transmission lobes included; the sampled lobe (its flags, wi) the same.
- The parser: a file with all fourteen material names and a bump map
  builds tpuprt's MaterialTable (through the bridge).
- The slice as a whole: bench3's Cornell box with every wall and sphere in
  a new material (chip_smoke.materials_text, Mitchell by default) at
  16x16 x 4 spp in path mode, through both packages' pools.
"""
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import chip_smoke
from test_torch_bvh import assert_tables_equal, numpy_tables
from tpuprt.bsdf import bsdf as jB
from tpuprt.integrators import path_wavefront as jax_pool
from tpuprt.materials import factory as jF
from tpuprt.scene.parser import load_scene_string as jax_load
from tpuprt_torch import render as torch_render
from tpuprt_torch.bsdf import bsdf as tB
from tpuprt_torch.materials import factory as tF
from tpuprt_torch.scene.bridge import from_numpy_tables
from tpuprt_torch.scene.parser import load_scene_string

torch.set_num_threads(1)
_SCENES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenes")
N = 8192
RES, SPP = 16, 4
MEASURED = ("bluepaint", "brushedmetal", "clay", "felt", "primer", "skin")
NEW = ('"shinymetal"', '"substrate" "float uroughness" [0.05] '
       '"float vroughness" [0.4]', '"translucent"',
       '"uber" "color opacity" [0.6 0.6 0.6]') + tuple(
           f'"{m}"' for m in MEASURED)
OLD = ('"matte"', '"plastic"', '"glass"', '"mirror"')


def material_scene(materials, bump=False):
    """One triangle per Material line, under a point light; with `bump`,
    every material takes a wrinkled bump map."""
    tri = ('Shape "trianglemesh" "integer indices" [0 1 2] "point P" '
           '[{x} 0 0  {y} 0 0  {x} 1 0]\n')
    world = ['LightSource "point" "point from" [0 2 -2] '
             '"color I" [3 3 3]\n']
    if bump:
        world.append('Texture "bumps" "float" "wrinkled" '
                     '"float scale" [0.02]\n')
    for i, m in enumerate(materials):
        world.append(f'Material {m}' + (' "texture bumpmap" "bumps"'
                                        if bump else '') + '\n')
        world.append(tri.format(x=i, y=i + 0.9))
    return ('Film "image" "integer xresolution" [8] "integer yresolution" '
            '[8]\nLookAt 0 0.5 -3  0 0.5 0  0 1 0\nCamera "perspective"\n'
            'WorldBegin\n' + "".join(world) + 'WorldEnd\n')


def unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def close(t, j, what, rtol=2e-4, atol=1e-6):
    """Float rounding of eager torch against XLA (pow, sqrt, division, the
    dot products' order): rtol 2e-4, atol 1e-6 unless a test says more."""
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.fixture(scope="module")
def batches():
    """The same BSDF wavefront over the ten new materials in both
    packages: (jax batch, port batch, wo, wi, u f32[3,N], material ids,
    material kinds)."""
    text = material_scene(NEW)
    jm = jax_load(text)[0].materials
    tscene = load_scene_string(text)[0]
    tm = tscene.materials
    kinds = tm.kind.numpy()
    assert kinds.tolist() == [tF.MAT_SHINYMETAL, tF.MAT_SUBSTRATE,
                                  tF.MAT_TRANSLUCENT, tF.MAT_UBER] + list(
        range(tF.MAT_MEASURED_BASE, tF.MAT_MEASURED_BASE + 6))
    rng = np.random.default_rng(14)
    ntex = tscene.textures.fparams.shape[0]
    tex = rng.uniform(0.01, 1.0, (ntex, N, 3)).astype(np.float32)
    uber = int(np.flatnonzero(kinds == tF.MAT_UBER)[0])
    tex[int(tm.tex[uber, 4])] = 0.6                  # uber's opacity
    mat = rng.integers(0, tm.count, N).astype(np.int32)
    ng = unit(rng, N)
    nn = np.where(rng.uniform(size=(N, 1)) < 0.8, ng, unit(rng, N))
    dpdu = unit(rng, N)
    wo, wi = unit(rng, N), unit(rng, N)
    u = rng.uniform(0, 1, (3, N)).astype(np.float32)
    jl = jF.make_lobes(jm, jnp.asarray(mat), jnp.asarray(tex))
    jb = jB.BsdfBatch(*jB.make_frame(*map(jnp.asarray, (nn, dpdu, ng))),
                      lobes=jl)
    tl = tF.make_lobes(tm, torch.from_numpy(mat), torch.from_numpy(tex))
    tb = tB.BsdfBatch(*tB.make_frame(*map(torch.from_numpy,
                                           (nn, dpdu, ng))), lobes=tl)
    return jb, tb, wo, wi, u, mat, kinds[mat]


def test_new_material_lobes_match_tpuprt(batches):
    """Every column of the lobe table per lane (p: tpuprt's first two of
    four), the static kind sets, and rho_approx; tolerance: close()'s."""
    jb, tb, *_, mk = batches
    jl, tl = jb.lobes, tb.lobes
    for k in ("kind", "flags", "flip", "aux0", "aux1"):
        np.testing.assert_array_equal(getattr(tl, k).numpy(),
                                      np.asarray(getattr(jl, k)), err_msg=k)
    for k in ("R", "eta", "k"):
        close(getattr(tl, k), getattr(jl, k), k)
    close(tl.p, np.asarray(jl.p)[..., :2], "p")
    assert tl.kinds_present == tuple(jl.kinds_present) == (
        tB.BX_LAMBERTIAN, tB.BX_SPECREFL, tB.BX_SPECTRANS, tB.BX_MICROFACET,
        tB.BX_FRESNELBLEND, tB.BX_LAFORTUNE)
    assert tl.dist_kinds == tuple(jl.dist_kinds) == (tB.DIST_BLINN,
                                                     tB.DIST_ANISO)
    for mask in (jB.ALL & ~jB.SPECULAR, jB.ALL):
        close(tB.rho_approx(tb, mask), jB.rho_approx(jb, mask), "rho")
    # Coverage: translucent's two flipped lobes, the approximate
    # conductor's eta, substrate's anisotropic exponents, uber's
    # pass-through transmission at 1 - opacity, every measured fit.
    kind, flip = tl.kind.numpy(), tl.flip.numpy()
    assert flip[mk == tF.MAT_TRANSLUCENT][:, [1, 3]].all()
    assert not flip[mk != tF.MAT_TRANSLUCENT].any()
    metal = mk == tF.MAT_SHINYMETAL
    assert (tl.eta.numpy()[metal][:, :2] > 1.0).all()
    sub = tl.p.numpy()[mk == tF.MAT_SUBSTRATE][:, 0]
    assert (np.abs(sub[:, 0] - sub[:, 1]) > 1.0).mean() > 0.5
    np.testing.assert_allclose(tl.R.numpy()[mk == tF.MAT_UBER][:, 0], 0.4,
                               rtol=1e-6)
    laf = kind == tB.BX_LAFORTUNE
    assert set(tl.aux0.numpy()[laf].tolist()) == {0, 2, 3, 4, 5}
    # brushedmetal's diffuse row is black, so tpuprt's black-lobe rule
    # kills its Lafortune lobe too (pbrt-v1 keeps it): the port does the
    # same.
    assert (kind[mk == tF.MAT_MEASURED_BASE + 1] == tB.BX_NONE).all()


@pytest.mark.parametrize("mask", [jB.ALL, jB.ALL & ~jB.SPECULAR,
                                  jB.TRANSMISSION | jB.ALL_TYPES])
def test_f_pdf_sample_match_tpuprt(batches, mask):
    """f, pdf and sample_f per lane: close()'s tolerance for f and pdf,
    rtol 1e-3 / atol 1e-5 for the sampled f and pdf (a Lafortune
    exponent up to 196 and the specular 1/|cos| amplify rounding), wi
    within atol 1e-5; valid, flags and specular equal."""
    jb, tb, wo, wi, u, mat, mk = batches
    two, twi = torch.from_numpy(wo), torch.from_numpy(wi)
    close(tB.f(tb, two, twi, mask), jB.f(jb, jnp.asarray(wo),
                                          jnp.asarray(wi), mask), "f",
          rtol=1e-3, atol=1e-5)
    close(tB.pdf(tb, two, twi, mask), jB.pdf(jb, jnp.asarray(wo),
                                              jnp.asarray(wi), mask), "pdf",
          rtol=1e-3, atol=1e-5)
    js = jB.sample_f(jb, jnp.asarray(wo), *map(jnp.asarray, u), mask)
    ts = tB.sample_f(tb, two, *map(torch.from_numpy, u), mask)
    for k in ("valid", "flags", "specular"):
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]),
                                      err_msg=k)
    close(ts["wi"], js["wi"], "wi", atol=1e-5)
    close(ts["f"], js["f"], "sample f", rtol=1e-3, atol=1e-5)
    close(ts["pdf"], js["pdf"], "sample pdf", rtol=1e-3, atol=1e-5)
    close(ts["eta"], js["eta"], "eta")
    # Coverage: translucent's transmitted lobes sampled (a flipped wi on
    # the far side of the surface, a nonzero f), FresnelBlend both ways.
    valid = ts["valid"].numpy()
    flags = ts["flags"].numpy()
    trans = valid & ((flags & tB.TRANSMISSION) > 0) & \
        (mk == tF.MAT_TRANSLUCENT)
    assert trans.sum() > 100
    ng = tb.ng.numpy()
    side = (ts["wi"].numpy() * ng).sum(-1) * (wo * ng).sum(-1)
    assert (side[trans] < 0).mean() > 0.9
    assert (np.abs(ts["f"].numpy()[trans]).sum(-1) > 0).mean() > 0.5
    if not mask & jB.REFLECTION:
        return
    sub = valid & (mk == tF.MAT_SUBSTRATE)
    assert sub.sum() > 100 and (u[0][sub] < 0.5).any() and \
        (u[0][sub] >= 0.5).any()
    if mask & jB.SPECULAR:
        assert (ts["specular"].numpy() & valid &
                (mk == tF.MAT_SHINYMETAL)).sum() > 100


def test_parser_builds_tpuprts_material_table():
    """All fourteen material names, each with a bump map: the port's
    MaterialTable equals tpuprt's through the bridge (every column,
    t_flip and the new op codes included)."""
    text = material_scene(OLD + NEW, bump=True)
    jscene = jax_load(text)[0]
    tscene = load_scene_string(text)[0]
    names = sorted(tF.MATERIAL_KINDS, key=tF.MATERIAL_KINDS.get)
    assert tscene.materials.kind.tolist() == list(range(14))
    assert len(names) == 14 and tscene.materials.has_bump
    bump = tscene.materials.bump.tolist()
    assert bump == bump[:1] * 14 and bump[0] >= 0
    assert_tables_equal(tscene.materials, from_numpy_tables(
        numpy_tables(jscene), "cpu").materials, "materials")
    t_rop = tscene.materials.t_rop.numpy()
    for op in (tF.R_ONE, tF.R_PROD, tF.R_ONE_MINUS, tF.R_MEASURED):
        assert (t_rop == op).any(), op
    t_eop = tscene.materials.t_eop.numpy()
    for op in (tF.E_APPROX, tF.E_KS, tF.E_PASS):
        assert (t_eop == op).any(), op
    assert (tscene.materials.t_pop.numpy() == tF.P_INV_AB).any()
    # The port renders the file (directlighting, its 8x8 film).
    rgb, alpha = torch_render.render(tscene, load_scene_string(text)[1],
                                     device="cpu")
    assert np.isfinite(rgb).all() and rgb.mean() > 0


def test_materials_scene_pool_matches_tpuprt():
    """bench3 with every wall and sphere a new material, Mitchell 2x2 by
    default, 16x16 x 4 spp, path mode, through both pools (one JAX
    compile). The same streams every sample: 99.5% of pixels within atol
    = rtol = 1e-4 (test_torch_render's rule), alpha equal."""
    with open(os.path.join(_SCENES, "bench3.pbrt")) as f:
        text = chip_smoke.materials_text(f.read(), RES, SPP)
    jscene, jopts = jax_load(text)
    tscene, topts = load_scene_string(text)
    assert (topts.filter_kind, topts.filter_xwidth, topts.integrator) == \
        ("mitchell", 2.0, "path")
    assert tscene.materials.lobe_kinds == tuple(range(7))
    assert_tables_equal(tscene, from_numpy_tables(numpy_tables(jscene),
                                                  "cpu"))
    jrgb, jalpha = jax_pool.render(jscene, jopts)
    trgb, talpha = torch_render.render(tscene, topts, device="cpu")
    assert trgb.shape == (RES, RES, 3) and np.isfinite(trgb).all()
    np.testing.assert_array_equal(talpha, np.asarray(jalpha))
    close_px = np.isclose(trgb, np.asarray(jrgb), atol=1e-4,
                          rtol=1e-4).all(-1)
    assert close_px.mean() >= 0.995, close_px.mean()
    assert trgb.mean() > 0.05
