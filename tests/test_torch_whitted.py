"""Whitted, the point light and the samplers held against tpuprt on the CPU.

- The samplers' camera samples and integrator streams: stratified (with
  and without jitter, no power-of-two rounding), random and best candidate
  (the port's copy of tpuprt's table), bit for bit.
- The point light: lights.sample (I / d^2, wi, pdf, the segment to the
  light) among a distant light and a sphere area light, and Light::Power.
- sample_f's eta and specular_ray_differentials.
- 16x16 x 4 spp renders through both pools in mode "whitted": config1 as
  its file asks (stratified 2x2, a point light, one matte sphere), and
  config3's glass and mirror box with a point and an infinite light added
  and the random sampler (specular chains carrying their differentials,
  escape radiance on every miss).

The whole renders are in test_torch_whitted_render.py (no file holds more
than ten cases).
"""
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from test_torch_bvh import assert_tables_equal, numpy_tables
from test_torch_path import batches, close, scene_text  # noqa: F401
from tpuprt.bsdf import bsdf as jB
from tpuprt.integrators import common as jC
from tpuprt.integrators import path_wavefront as jax_pool
from tpuprt.lights import lights as jlights
from tpuprt.samplers import bc_gen
from tpuprt.samplers import samplers as jsmp
from tpuprt.scene.build import SceneBuilder as JaxBuilder
from tpuprt.scene.parser import load_scene_string as jax_load
from tpuprt_torch import render as torch_render
from tpuprt_torch.bsdf import bsdf as tB
from tpuprt_torch.core import transform as tf
from tpuprt_torch.integrators import common as tC
from tpuprt_torch.lights import lights as tlights
from tpuprt_torch.samplers import bc_gen as tbc
from tpuprt_torch.samplers import samplers as tsmp
from tpuprt_torch.scene.bridge import from_numpy_tables
from tpuprt_torch.scene.build import SceneBuilder
from tpuprt_torch.scene.data import LIGHT_POINT
from tpuprt_torch.scene.parser import load_scene_string

torch.set_num_threads(1)
_SCENES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenes")
RES = 16
N = 4096


def test_bc_table_is_tpuprts():
    np.testing.assert_array_equal(tbc.load_table(), bc_gen.load_table())


@pytest.mark.parametrize("cfg", [
    tsmp.SamplerConfig(kind="stratified", xsamples=2, ysamples=2),
    tsmp.SamplerConfig(kind="stratified", xsamples=3, ysamples=2,
                       jitter=False),
    tsmp.SamplerConfig(kind="random", pixelsamples=3),
    tsmp.SamplerConfig(kind="bestcandidate", pixelsamples=4),
    tsmp.SamplerConfig(kind="bestcandidate", pixelsamples=5),
], ids=["stratified", "stratified-nojitter", "random", "bestcandidate4",
        "bestcandidate5"])
def test_sampler_streams_match_tpuprt(cfg):
    """Every (pixel, sample) of a 70x40 film (the best-candidate tiles
    wrap), for camera samples and integrator dimensions."""
    jcfg = jsmp.SamplerConfig(*cfg)
    spp = tsmp.samples_per_pixel(cfg)
    assert spp == jsmp.samples_per_pixel(jcfg)
    lin = np.arange(70 * 40 * spp)
    px = (lin // spp % 70).astype(np.int32)
    py = (lin // spp // 70).astype(np.int32)
    s = (lin % spp).astype(np.int32)
    jargs = [jnp.asarray(x) for x in (px, py, s)]
    targs = [torch.from_numpy(x) for x in (px, py, s)]
    jcs = jsmp.camera_samples(jcfg, *jargs, 3)
    tcs = tsmp.camera_samples(cfg, *targs, 3)
    for k in ("image_x", "image_y"):
        np.testing.assert_array_equal(tcs[k].numpy(), np.asarray(jcs[k]),
                                      err_msg=k)
    fx = tcs["image_x"].numpy() - px
    assert ((fx >= 0) & (fx < 1)).all()
    if cfg.kind == "bestcandidate":
        # Both table entries and (0,2)-sequence fallbacks are drawn.
        fall = tsmp.bc_tables(spp, "cpu")[2].numpy()
        assert fall.any() and not fall.all()
    bounce = torch.from_numpy((lin % 3).astype(np.int32))
    for purpose in (10, 101):
        np.testing.assert_array_equal(
            tsmp.integrator_1d(cfg, *targs, bounce, purpose, 3).numpy(),
            np.asarray(jsmp.integrator_1d(jcfg, *jargs,
                                          jnp.asarray(bounce.numpy()),
                                          purpose, 3)))
        for tv, jv in zip(
                tsmp.integrator_2d(cfg, *targs, bounce, purpose, 3),
                jsmp.integrator_2d(jcfg, *jargs, jnp.asarray(bounce.numpy()),
                                   purpose, 3)):
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def lights_scene(b):
    """Two point lights (one under a rotated, scaled CTM), a distant light
    and a sphere area light over a floor."""
    m = b.matte()
    b.add_trianglemesh(np.eye(4), [0, 1, 2, 0, 2, 3],
                       [-4, -1, -4, 4, -1, -4, 4, -1, 4, -4, -1, 4],
                       material=m)
    b.add_point_light(tf.translate((1.0, 2.5, -0.5)), (30.0, 25.0, 20.0))
    b.add_point_light(tf.rotate(35, (1, 1, 0)) @ tf.scale(2, 2, 2) @
                      tf.translate((-0.5, 1.0, 0.5)), (5.0, 6.0, 7.0))
    b.add_distant_light(np.eye(4), (1.5, 1.4, 1.2), (1, 3, -2), (0, 0, 0))
    q = b.add_sphere(tf.translate((0.0, 3.0, 1.0)), 0.4, material=m)
    b.add_area_light_sphere(q, (4.0, 4.0, 4.0))
    return b.build()


def test_point_light_matches_tpuprt():
    jscene, tscene = lights_scene(JaxBuilder()), lights_scene(SceneBuilder())
    assert tscene.lights.kind.tolist()[:2] == [LIGHT_POINT] * 2
    assert_tables_equal(tscene, from_numpy_tables(numpy_tables(jscene),
                                                  "cpu"))
    rng = np.random.default_rng(4)
    p = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    p[:, 1] = -1.0
    n = np.tile(np.float32([0, 1, 0]), (N, 1))
    lid = rng.integers(0, 4, N).astype(np.int32)
    u = rng.uniform(0, 1, (3, N)).astype(np.float32)
    js = jlights.sample(jscene, jnp.asarray(lid), jnp.asarray(p),
                        jnp.asarray(n), *map(jnp.asarray, u))
    ts = tlights.sample(tscene, torch.from_numpy(lid), torch.from_numpy(p),
                        torch.from_numpy(n), *map(torch.from_numpy, u))
    np.testing.assert_array_equal(ts["delta"].numpy(), np.asarray(js["delta"]))
    # test_torch_quadrics' tolerance for the sphere light's samples.
    for k in ("Li", "wi", "pdf", "vis_maxt"):
        close(ts[k], js[k], k, rtol=1e-4, atol=1e-5)
    for k in ("Li", "wi", "vis_maxt"):
        close(ts[k][lid < 2], js[k][lid < 2], k, rtol=1e-6, atol=1e-7)
    point = lid < 2
    assert ts["delta"].numpy()[point].all()
    np.testing.assert_array_equal(ts["pdf"].numpy()[point], 1.0)
    # A delta light has pdf 0 for any other direction.
    np.testing.assert_array_equal(tlights.pdf(
        tscene, torch.from_numpy(lid), torch.from_numpy(p),
        torch.from_numpy(n), ts["wi"]).numpy()[point], 0.0)
    close(tlights.power(tscene), jlights.power(jscene), "power", rtol=1e-6)


def test_sample_f_eta_matches_tpuprt(batches):  # noqa: F811
    """etat / etai on a sampled specular transmission lobe, 1 on any other
    (config3's glass, entering and leaving)."""
    jb, tb, wo, _wi, u, _mat = batches
    mask = jB.SPECULAR | jB.REFLECTION | jB.TRANSMISSION
    js = jB.sample_f(jb, jnp.asarray(wo), *map(jnp.asarray, u), mask)
    ts = tB.sample_f(tb, torch.from_numpy(wo), *map(torch.from_numpy, u),
                     mask)
    close(ts["eta"], js["eta"], "eta", rtol=1e-6)
    trans = (ts["flags"].numpy() & tB.TRANSMISSION) > 0
    eta = ts["eta"].numpy()
    assert trans.sum() > N // 8 and (eta[trans] > 1.1).all()
    np.testing.assert_array_equal(eta[~trans], 1.0)


def test_specular_ray_differentials_match_tpuprt():
    rng = np.random.default_rng(12)

    def vec(scale=1.0):
        return (rng.normal(size=(N, 3)) * scale).astype(np.float32)

    def unit():
        v = vec()
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    dg = dict(p=vec(), dpdx=vec(0.01), dpdy=vec(0.01), dndu=vec(0.3),
              dndv=vec(0.3))
    for k in ("dudx", "dvdx", "dudy", "dvdy"):
        dg[k] = (rng.normal(size=N) * 0.05).astype(np.float32)
    ns, wo, wi = unit(), unit(), unit()
    rx_d, ry_d = unit(), unit()
    eta = rng.uniform(1.0, 2.4, N).astype(np.float32)
    eta[::3] = 1.0
    is_trans = rng.uniform(size=N) < 0.5
    args = (ns, wo, wi, rx_d, ry_d, eta, is_trans)
    jout = jC.specular_ray_differentials(
        {k: jnp.asarray(v) for k, v in dg.items()}, *map(jnp.asarray, args))
    tout = tC.specular_ray_differentials(
        {k: torch.from_numpy(v) for k, v in dg.items()},
        *map(torch.from_numpy, args))
    for name, t, j in zip(("rx_o", "rx_d", "ry_o", "ry_d"), tout, jout):
        close(t, j, name, rtol=1e-4, atol=1e-4)


def whitted_config3_text():
    """config3 rendered by Whitted with the random sampler, a point light
    and an infinite light added."""
    text = scene_text().replace('SurfaceIntegrator "path"',
                                'SurfaceIntegrator "whitted"')
    text = text.replace('Sampler "lowdiscrepancy" "integer pixelsamples" [4]',
                        'Sampler "random" "integer pixelsamples" [4]')
    return text.replace("WorldBegin\n", (
        'WorldBegin\nLightSource "point" "point from" [0.3 0.6 -0.4] '
        '"color I" [2 2 2]\nLightSource "infinite" "color L" '
        '[0.3 0.4 0.5]\n'))


def config1_text():
    with open(os.path.join(_SCENES, "config1.pbrt")) as f:
        return f.read().replace("[128]", f"[{RES}]")


@pytest.fixture(scope="module", params=["config1", "config3/whitted"])
def renders(request):
    text = config1_text() if request.param == "config1" \
        else whitted_config3_text()
    jscene, jopts = jax_load(text)
    tscene, topts = load_scene_string(text)
    assert topts.integrator == jopts.integrator == "whitted"
    assert topts.sampler == tuple(jopts.sampler)
    assert tsmp.samples_per_pixel(topts.sampler) == 4
    assert LIGHT_POINT in tscene.lights.kinds_present
    assert_tables_equal(tscene, from_numpy_tables(numpy_tables(jscene),
                                                  "cpu"))
    jrgb, jalpha = jax_pool.render(jscene, jopts)
    trgb, talpha = torch_render.render(tscene, topts, device="cpu")
    return jrgb, jalpha, trgb, talpha
