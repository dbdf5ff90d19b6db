"""bench3's path in the port held against tpuprt on the CPU: the specular
lobes, the glass and mirror materials, one-light MIS with the light chosen
per lane, and the pool's path mode.

- The parser reads bench3 (SurfaceIntegrator "path", glass, mirror) into
  tpuprt's tables (through the bridge).
- f, pdf and sample_f over config3's material table (three matte, a glass
  and a mirror), with random slot values per lane (the glass's index
  between 1.1 and 2.4, above the [0, 1] clamp of colour slots): lanes
  entering and leaving the glass, some past its critical angle.
- uniform_sample_one_light at random points inside config3's box with a
  disk area light, a distant light and a constant infinite light: the
  light's kind read per lane, no BSDF-strategy ray for a delta light, the
  infinite light's escape radiance on a ray resolved as "nearest".
- 16x16 x 4 spp path renders of config3, and of config3 with an infinite
  and a distant light, through both packages' pools.
"""
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from test_torch_bvh import assert_tables_equal, numpy_tables
from tpuprt.bsdf import bsdf as jB
from tpuprt.integrators import common as jC
from tpuprt.integrators import path_wavefront as jax_pool
from tpuprt.materials import factory as jF
from tpuprt.scene.parser import load_scene_string as jax_load
from tpuprt_torch import render as torch_render
from tpuprt_torch.accel import intersect as tisect
from tpuprt_torch.bsdf import bsdf as tB
from tpuprt_torch.integrators import common as tC
from tpuprt_torch.materials import factory as tF
from tpuprt_torch.scene.bridge import from_numpy_tables
from tpuprt_torch.scene.data import LIGHT_DISTANT, LIGHT_INFINITE
from tpuprt_torch.scene.parser import load_scene_string

torch.set_num_threads(1)
_SCENES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenes")
N = 4096
RES, SPP = 16, 4
EXTRA_LIGHTS = ('LightSource "infinite" "color L" [0.3 0.4 0.5]\n'
                'LightSource "distant" "point from" [1 3 -2] '
                '"point to" [0 0 0] "color L" [1.5 1.4 1.2]\n')


def scene_text(name="config3", lights=False, res=RES, spp=SPP):
    with open(os.path.join(_SCENES, f"{name}.pbrt")) as f:
        text = f.read()
    text = text.replace('"integer xresolution" [96] "integer yresolution" '
                        '[96]', f'"integer xresolution" [{res}] '
                        f'"integer yresolution" [{res}]').replace(
        '"integer pixelsamples" [32]', f'"integer pixelsamples" [{spp}]')
    return text.replace("WorldBegin\n", "WorldBegin\n" + EXTRA_LIGHTS) \
        if lights else text


def unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def test_bench3_parses_into_tpuprts_tables():
    with open(os.path.join(_SCENES, "bench3.pbrt")) as f:
        text = f.read()
    jscene, jopts = jax_load(text)
    tscene, topts = load_scene_string(text)
    assert (topts.integrator, topts.max_depth) == ("path", 5)
    assert (topts.xres, topts.yres, topts.sampler.pixelsamples) == \
        (256, 256, 32)
    assert tscene.accel is None
    assert (tscene.triangles.count, tscene.quadrics.count) == (10, 3)
    # The disk light's default matte, three matte walls, glass, mirror.
    assert tscene.materials.kind.tolist() == [tF.MAT_MATTE] * 4 + [
        tF.MAT_GLASS, tF.MAT_MIRROR]
    assert tscene.materials.lobe_kinds == (tB.BX_ORENNAYAR, tB.BX_SPECREFL,
                                           tB.BX_SPECTRANS)
    assert_tables_equal(tscene, from_numpy_tables(numpy_tables(jscene),
                                                  "cpu"))


@pytest.fixture(scope="module")
def batches():
    """The same BSDF wavefront over config3's materials in both packages:
    (jax batch, port batch, wo, wi, u f32[3,N], material ids)."""
    text = scene_text()
    jm = jax_load(text)[0].materials
    tscene = load_scene_string(text)[0]
    tm = tscene.materials
    glass = tm.kind.tolist().index(tF.MAT_GLASS)
    rng = np.random.default_rng(3)
    ntex = tscene.textures.fparams.shape[0]
    tex = rng.uniform(0.01, 1.0, (ntex, N, 3)).astype(np.float32)
    index_tex = int(tm.tex[glass, 2])
    tex[index_tex] = rng.uniform(1.1, 2.4, (N, 1))
    # Half the lanes glass, the rest the other materials.
    mat = np.where(rng.uniform(size=N) < 0.5, glass,
                   rng.integers(0, tm.count, N)).astype(np.int32)
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
    return jb, tb, wo, wi, u, mat


def close(t, j, what, rtol=2e-4, atol=1e-6):
    """Float rounding of eager torch against XLA (sqrt, division and the
    dot products' order; a specular f divides by |cos|): rtol 2e-4, atol
    1e-6."""
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol,
                               atol=atol, err_msg=what)


def test_glass_and_mirror_lobes_match_tpuprt(batches):
    """The lobe tables, the glass's eta (1, index) read unclamped."""
    jb, tb, *_, mat = batches
    jl, tl = jb.lobes, tb.lobes
    for k in ("kind", "flags", "aux0", "aux1"):
        np.testing.assert_array_equal(getattr(tl, k).numpy(),
                                      np.asarray(getattr(jl, k)), err_msg=k)
    for k in ("R", "eta", "k"):
        close(getattr(tl, k), getattr(jl, k), k)
    trans = tl.kind.numpy() == tB.BX_SPECTRANS
    assert trans.sum() > N // 4
    assert (tl.eta.numpy()[..., 1][trans] > 1.1).all()
    assert (tl.kind.numpy() == tB.BX_SPECREFL).sum() > N // 3


@pytest.mark.parametrize("mask", [jB.ALL, jB.ALL & ~jB.SPECULAR,
                                  jB.SPECULAR | jB.REFLECTION |
                                  jB.TRANSMISSION])
def test_f_pdf_sample_match_tpuprt(batches, mask):
    jb, tb, wo, wi, u, mat = batches
    two, twi = torch.from_numpy(wo), torch.from_numpy(wi)
    close(tB.f(tb, two, twi, mask), jB.f(jb, jnp.asarray(wo),
                                          jnp.asarray(wi), mask), "f")
    close(tB.pdf(tb, two, twi, mask), jB.pdf(jb, jnp.asarray(wo),
                                              jnp.asarray(wi), mask), "pdf")
    js = jB.sample_f(jb, jnp.asarray(wo), *map(jnp.asarray, u), mask)
    ts = tB.sample_f(tb, two, *map(torch.from_numpy, u), mask)
    for k in ("valid", "flags", "specular"):
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]),
                                      err_msg=k)
    close(ts["wi"], js["wi"], "wi", atol=1e-5)
    close(ts["f"], js["f"], "sample f", rtol=1e-3, atol=1e-5)
    close(ts["pdf"], js["pdf"], "sample pdf", rtol=1e-3, atol=1e-5)
    if not mask & jB.SPECULAR:
        assert not ts["specular"].any()
        return
    # Coverage: transmission sampled entering and leaving the glass, and
    # past the critical angle (pdf 0, so not valid).
    glass = tb.lobes.kind.numpy()[:, 1] == tB.BX_SPECTRANS
    trans = (ts["flags"].numpy() & tB.TRANSMISSION) > 0
    wo_z = tB.world_to_local(tb, two)[:, 2].numpy()
    eta = tb.lobes.eta.numpy()[:, 1, 1]
    tir = (wo_z < 0) & ((1 - wo_z ** 2) * eta ** 2 >= 1)
    valid = ts["valid"].numpy()
    assert (glass & trans & (wo_z > 0) & valid).sum() > 100
    assert (glass & trans & (wo_z < 0) & valid).sum() > 100
    assert (glass & trans & tir).sum() > 50
    assert not valid[glass & trans & tir].any()
    refl = (ts["flags"].numpy() & tB.REFLECTION) > 0
    assert (ts["specular"].numpy() & refl & valid).sum() > 500


def test_uniform_sample_one_light_matches_tpuprt(batches, monkeypatch):
    """Random points inside the box, each lane's light chosen by u_num
    among the area disk, the infinite and the distant light."""
    jb, tb, wo, _wi, _u, _mat = batches
    text = scene_text(lights=True)
    jscene = jax_load(text)[0]
    tscene = load_scene_string(text)[0]
    kinds = tscene.lights.kind.tolist()
    rng = np.random.default_rng(8)
    p = rng.uniform(-0.9, 0.9, (N, 3)).astype(np.float32)
    n = np.array(jb.nn)
    u = rng.uniform(0, 1, (7, N)).astype(np.float32)
    active = rng.uniform(size=N) < 0.9
    jld = jC.uniform_sample_one_light(jscene, jnp.asarray(p), jnp.asarray(n),
                                      jnp.asarray(wo), jb,
                                      *map(jnp.asarray, u),
                                      jnp.asarray(active))
    calls = []
    real = {k: getattr(tisect, k) for k in ("intersect_ids", "occluded")}

    def spy(name):
        def fn(scene, o, d, mint, maxt):
            out = real[name](scene, o, d, mint, maxt)
            calls.append((name, maxt, out))
            return out
        return fn
    for name in real:
        monkeypatch.setattr(tisect, name, spy(name))
    tld = tC.uniform_sample_one_light(tscene, torch.from_numpy(p),
                                      torch.from_numpy(n),
                                      torch.from_numpy(wo), tb,
                                      *map(torch.from_numpy, u),
                                      torch.from_numpy(active))
    close(tld, jld, "Ld", rtol=1e-3, atol=1e-5)
    # Lit lanes: matte ones (glass and mirror have no f toward a light).
    assert (np.asarray(jld) > 0).any(1).sum() > N // 20
    # One shadow launch (any hit) and one BSDF-strategy launch resolved as
    # "nearest": the scene has an area light.
    assert [c[0] for c in calls] == ["occluded", "intersect_ids"]
    lid = np.minimum((u[0] * len(kinds)).astype(np.int32), len(kinds) - 1)
    kind = np.asarray(kinds)[lid]
    for k in set(kinds):
        assert (kind == k).sum() > N // 5
    go = calls[1][1].numpy() > 0.0
    hit = calls[1][2][2].numpy()
    # A delta light's lanes trace no BSDF-strategy ray; an infinite light's
    # lanes escape through the open front of the box and take its radiance.
    assert not go[kind == LIGHT_DISTANT].any()
    assert (go & ~hit & (kind == LIGHT_INFINITE)).sum() > 20


@pytest.fixture(scope="module", params=["config3", "config3+lights"])
def renders(request):
    """One render of the scene through each package's pool (one JAX
    compile per scene)."""
    text = scene_text(lights=request.param.endswith("+lights"))
    jscene, jopts = jax_load(text)
    tscene, topts = load_scene_string(text)
    assert topts.integrator == jopts.integrator == "path"
    jrgb, jalpha = jax_pool.render(jscene, jopts)
    trgb, talpha = torch_render.render(tscene, topts, device="cpu")
    return jrgb, jalpha, trgb, talpha


def test_path_render_matches_tpuprt(renders):
    """Every sample uses the same streams, so pixels agree to float
    rounding (test_torch_render's rule: 99.5% of pixels within atol = rtol
    = 1e-4, alpha equal). A pixel may differ more where a camera ray
    grazes the glass sphere's silhouette and the quadratic's rounding
    moves the hit."""
    jrgb, jalpha, trgb, talpha = renders
    assert trgb.shape == (RES, RES, 3) and np.isfinite(trgb).all()
    np.testing.assert_array_equal(talpha, jalpha)
    close_px = np.isclose(trgb, jrgb, atol=1e-4, rtol=1e-4).all(-1)
    assert close_px.mean() >= 0.995, close_px.mean()
    assert trgb.mean() > 0.1
