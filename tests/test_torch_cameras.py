"""The port's cameras, camera samples and pixel filters held against tpuprt
on the CPU.

- Rays per lane: camera_samples of every sampler (stratified with and
  without jitter, random, lowdiscrepancy, bestcandidate), their image,
  lens and time samples, and generate_rays of the perspective camera with
  and without a thin lens, the orthographic camera with and without one
  and the environment camera: o, d, mint, maxt and time.
- The film splat: add_samples with each of the five filters at its
  default width and a box of width 1.5, samples within a filter's width
  of the film's border included.
- The parser: Camera "orthographic" and "environment", lensradius,
  focaldistance, the shutter times, every PixelFilter name and a file
  with none build tpuprt's CameraData (through the bridge) and
  RenderOptions.
- The whole path: a thin lens and the default Mitchell filter, 16x16 x 4
  spp directlighting through both packages' render().
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import chip_smoke
from test_torch_bvh import assert_tables_equal, numpy_tables, \
    terrain_scene_text
from tpuprt import render as jax_render
from tpuprt.cameras import cameras as jcam
from tpuprt.film import film as jfilm
from tpuprt.samplers import samplers as jsmp
from tpuprt.scene.parser import load_scene_string as jax_load
from tpuprt_torch import render as torch_render
from tpuprt_torch.cameras import cameras as tcam
from tpuprt_torch.film import film as tfilm
from tpuprt_torch.filters import filters as tftr
from tpuprt_torch.samplers import samplers as tsmp
from tpuprt_torch.scene import data as D
from tpuprt_torch.scene.bridge import from_numpy_tables
from tpuprt_torch.scene.parser import load_scene_string

torch.set_num_threads(1)
W, H = 24, 16
SAMPLERS = {
    "stratified": tsmp.SamplerConfig("stratified", 2, 3, True),
    "stratified/nojitter": tsmp.SamplerConfig("stratified", 3, 2, False),
    "random": tsmp.SamplerConfig("random", pixelsamples=5),
    "lowdiscrepancy": tsmp.SamplerConfig("lowdiscrepancy", pixelsamples=8),
    "bestcandidate": tsmp.SamplerConfig("bestcandidate", pixelsamples=8),
}
LENS = '"float lensradius" [0.2] "float focaldistance" [2.5] '
SHUTTER = '"float shutteropen" [0.25] "float shutterclose" [0.75]'
CAMERAS = {
    "perspective": f'"perspective" "float fov" [50] {SHUTTER}',
    "perspective/lens": f'"perspective" "float fov" [50] {LENS}{SHUTTER}',
    "orthographic": f'"orthographic" {SHUTTER}',
    "orthographic/lens": f'"orthographic" "float screenwindow" '
                         f'[-2 2 -1 1] {LENS}{SHUTTER}',
    "environment": f'"environment" "float hither" [0.01] {SHUTTER}',
}


def scene_text(camera, pfilter=None):
    """A triangle under a point light through `camera` on a W x H film,
    with `pfilter` (a PixelFilter line's rest) or none."""
    return (f'Film "image" "integer xresolution" [{W}] "integer '
            f'yresolution" [{H}]\nLookAt 0.3 1 -3  0 0 0  0 1 0\n'
            f'Camera {camera}\n' +
            (f'PixelFilter {pfilter}\n' if pfilter else '') +
            'WorldBegin\nLightSource "point" "point from" [0 2 -2] '
            '"color I" [3 3 3]\nShape "trianglemesh" "integer indices" '
            '[0 1 2] "point P" [-1 0 -1  1 0 -1  0 0 1]\nWorldEnd\n')


def lanes(cfg, n=W * H * 4):
    """The first n (pixel, sample index) lanes in pixel order, every
    sample index of each pixel: one lane count for every sampler, so
    tpuprt's eager ops compile once for all of them."""
    spp = tsmp.samples_per_pixel(cfg)
    lin = np.arange(n)
    return tuple(a.astype(np.int32) for a in (lin // spp % W,
                                              lin // spp // W, lin % spp))


@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_camera_samples_and_rays_match_tpuprt(sampler):
    """The five camera-sample dimensions bit for bit (counter-based
    hashes and the same f32 arithmetic); o, d, mint, time within atol =
    rtol = 1e-5 and maxt within rtol 1e-5 (the lens's extra divisions and
    the normalize's order)."""
    cfg = SAMPLERS[sampler]
    jcfg = jsmp.SamplerConfig(*cfg)
    px, py, s = lanes(cfg)
    jcs = jsmp.camera_samples(jcfg, *map(jnp.asarray, (px, py, s)), 3)
    tcs = tsmp.camera_samples(cfg, *map(torch.from_numpy, (px, py, s)), 3)
    keys = ("image_x", "image_y", "lens_u", "lens_v", "time")
    for k in keys:
        np.testing.assert_array_equal(tcs[k].numpy(), np.asarray(jcs[k]),
                                      err_msg=k)
        assert ((tcs[k].numpy() >= 0) & (tcs[k].numpy() < max(W, 1))).all()
    for k in keys[2:]:
        v = tcs[k].numpy()
        assert (v >= 0).all() and (v <= 1).all() and v.std() > 0.2, k
    for name, camera in CAMERAS.items():
        text = scene_text(camera)
        jscene = jax_load(text)[0]
        tscene = load_scene_string(text)[0]
        jr = jcam.generate_rays(jscene.camera, *(jcs[k] for k in keys), W, H)
        tr = tcam.generate_rays(tscene.camera, *(tcs[k] for k in keys), W, H)
        for what, t, j in zip(("o", "d", "mint", "maxt", "time"), tr, jr):
            if what == "maxt":
                np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                           rtol=1e-5, err_msg=name)
            else:
                np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                           rtol=1e-5, atol=1e-5,
                                           err_msg=f"{name} {what}")
        o = tr[0].numpy()
        time = tr[4].numpy()
        assert (time >= 0.25).all() and (time <= 0.75).all()
        if name.endswith("/lens"):       # origins spread over the lens
            assert o.std(0).max() > 0.05, name
        np.testing.assert_allclose(np.linalg.norm(tr[1].numpy(), axis=1),
                                   1.0, rtol=1e-5)


def test_film_splat_matches_tpuprt():
    """add_samples with every filter at its default width and a box of
    width 1.5; a fifth of the samples within 0.6 pixels of a border.
    Tolerance: atol 1e-5, rtol 1e-5 (the scatters' summation order)."""
    rng = np.random.default_rng(21)
    n = 4096
    ix = rng.uniform(0, W, n).astype(np.float32)
    iy = rng.uniform(0, H, n).astype(np.float32)
    edge = rng.uniform(size=n) < 0.2
    ix[edge] = np.where(rng.uniform(size=edge.sum()) < 0.5,
                        rng.uniform(0, 0.6, edge.sum()),
                        rng.uniform(W - 0.6, W, edge.sum())).astype(
                            np.float32)
    L = rng.uniform(0, 2, (n, 3)).astype(np.float32)
    alpha = (rng.uniform(size=n) < 0.8).astype(np.float32)
    cases = [(k, *w) for k, w in tftr.DEFAULT_WIDTHS.items()] + [
        ("box", 1.5, 1.5)]
    for kind, xw, yw in cases:
        jf = jfilm.add_samples(jfilm.make_film(W, H), jnp.asarray(ix),
                               jnp.asarray(iy), jnp.asarray(L),
                               jnp.asarray(alpha), kind, xw, yw)
        tf = tfilm.add_samples(tfilm.make_film(W, H, device="cpu"),
                               *map(torch.from_numpy, (ix, iy, L, alpha)),
                               kind, xw, yw)
        np.testing.assert_allclose(tf.data.numpy(), np.asarray(jf.data),
                                   rtol=1e-5, atol=1e-5, err_msg=kind)
        rgb, _ = tfilm.develop(tf)
        jrgb, _ = jfilm.develop(jf)
        np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb),
                                   rtol=1e-4, atol=1e-5, err_msg=kind)
        # Every pixel, border pixels included, took some weight (gaussian,
        # mitchell and sinc weigh some samples negative: |w| is held).
        assert (np.abs(tf.data.numpy()[..., 4]) > 0).all(), kind


def test_parser_builds_tpuprts_cameras_and_filters():
    """Every camera with and without a lens and the shutter times: the
    port's CameraData equals tpuprt's through the bridge; every filter
    name and no PixelFilter line (Mitchell 2x2): the same RenderOptions
    filter fields. The port renders each file (W x H, directlighting)."""
    kinds = {"perspective": D.CAMERA_PERSPECTIVE,
             "orthographic": D.CAMERA_ORTHOGRAPHIC,
             "environment": D.CAMERA_ENVIRONMENT}
    for name, camera in CAMERAS.items():
        text = scene_text(camera)
        jscene, jopts = jax_load(text)
        tscene, topts = load_scene_string(text)
        assert tscene.camera.kind == kinds[name.split("/")[0]]
        assert_tables_equal(tscene.camera, from_numpy_tables(
            numpy_tables(jscene), "cpu").camera, name)
        assert float(tscene.camera.shutter_open) == 0.25
        if name.endswith("/lens"):
            assert float(tscene.camera.lens_radius) == np.float32(0.2)
            assert float(tscene.camera.focal_distance) == 2.5
        rgb = torch_render.render(tscene, topts, device="cpu")[0]
        assert np.isfinite(rgb).all() and rgb.max() > 0, name
    filters = [None, '"box"', '"box" "float xwidth" [1.5] "float ywidth" '
               '[1]', '"triangle"', '"gaussian" "float alpha" [3]',
               '"mitchell" "float B" [0.5]', '"sinc" "float xwidth" [3]']
    for pf in filters:
        text = scene_text(CAMERAS["perspective"], pf)
        jopts = jax_load(text)[1]
        tscene, topts = load_scene_string(text)
        rgb = torch_render.render(tscene, topts, device="cpu")[0]
        assert np.isfinite(rgb).all() and rgb.max() > 0, pf
        got = (topts.filter_kind, topts.filter_xwidth, topts.filter_ywidth)
        assert got == (jopts.filter_kind, jopts.filter_xwidth,
                       jopts.filter_ywidth), pf
        if pf is None:
            assert got == ("mitchell", 2.0, 2.0)


def test_thin_lens_mitchell_render_matches_tpuprt():
    """The terrain(50) scene through a thin lens and the default Mitchell
    filter, 16x16 x 4 spp directlighting, through both render()s: the
    same streams every sample, so 99.5% of pixels within atol = rtol =
    1e-4 (test_torch_render's rule), alpha equal."""
    text = chip_smoke.cameras_text(terrain_scene_text(spp=4), "mitchell")
    text = text.replace('Camera "perspective" "float fov" [55]',
                        chip_smoke.CAMERAS_4["thinlens"][0])
    jscene, jopts = jax_load(text)
    tscene, topts = load_scene_string(text)
    assert topts.filter_kind == "mitchell"
    assert float(tscene.camera.lens_radius) > 0
    jrgb, jalpha = jax_render.render(jscene, jopts)
    trgb, talpha = torch_render.render(tscene, topts, device="cpu")
    assert trgb.shape == (16, 16, 3) and np.isfinite(trgb).all()
    np.testing.assert_array_equal(talpha, np.asarray(jalpha))
    close = np.isclose(trgb, np.asarray(jrgb), atol=1e-4,
                       rtol=1e-4).all(-1)
    assert close.mean() >= 0.995, close.mean()
    assert trgb.mean() > 0.1
