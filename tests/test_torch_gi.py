"""The GI integrators of the chunked driver in the port held against tpuprt
on the CPU: bidirectional (config10) and igi (config8), each the Cornell
box of bench6 (10 triangles, a disk light or a point light, a mirror or a
matte sphere) at 16x16; the irradiance cache (config9) is in
test_torch_irradiance.py, exphotonmap (config7) in
test_torch_exphotonmap.py, which use this file's helpers.

- The parser reads configs 7-10 into tpuprt's tables and options.
- igi's virtual lights per (set, vertex, path).
- Each integrator's Li per camera sample, from the preprocess state of
  tpuprt carried across by the bridge; the driver's whole image.
"""
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from test_torch_bvh import assert_tables_equal, numpy_tables
from tpuprt import render as jax_render
from tpuprt.cameras import cameras as jcam
from tpuprt.integrators import igi as jigi
from tpuprt.samplers import samplers as jsmp
from tpuprt.scene.parser import load_scene_string as jax_load
from tpuprt_torch import render as torch_render
from tpuprt_torch.integrators import bidirectional as tbd
from tpuprt_torch.integrators import exphotonmap as tex
from tpuprt_torch.integrators import igi as tigi
from tpuprt_torch.integrators import irradiancecache as tic
from tpuprt_torch.scene.bridge import (from_numpy_tables,
                                       virtual_lights_from_numpy)
from tpuprt_torch.scene.parser import load_scene_string
from tpuprt_torch.utils.stats import StatsRegistry

torch.set_num_threads(1)
_SCENES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenes")
RES = 16
# igi at a test size: 4 sets of 64 paths (config8 asks for 64 sets).
IGI_SETS = 4
# The irradiance estimate at a test size: 32 samples a probe.
IC_SAMPLES = 32


def scene_text(name, res=RES, spp=None):
    with open(os.path.join(_SCENES, f"{name}.pbrt")) as f:
        text = f.read()
    text = text.replace('"integer xresolution" [64] "integer yresolution" '
                        '[64]', f'"integer xresolution" [{res}] '
                        f'"integer yresolution" [{res}]')
    if spp:
        text = text.replace('"integer pixelsamples" [4]',
                            f'"integer pixelsamples" [{spp}]').replace(
            '"integer pixelsamples" [8]', f'"integer pixelsamples" [{spp}]')
    return text


def both(name, spp=2):
    text = scene_text(name, spp=spp)
    jscene, jopts = jax_load(text)
    tscene, topts = load_scene_string(text)
    if name == "config8":
        jopts = jopts._replace(igi=jopts.igi._replace(nsets=IGI_SETS))
        topts = topts._replace(igi=topts.igi._replace(nsets=IGI_SETS))
    if name == "config9":
        jopts = jopts._replace(irrad=jopts.irrad._replace(
            nsamples=IC_SAMPLES))
        topts = topts._replace(irrad=topts.irrad._replace(
            nsamples=IC_SAMPLES))
    return jscene, jopts, tscene, topts


def camera_chunk(jscene, jopts):
    """Every camera sample of the film as tpuprt's render_chunk makes it
    (ids, rays and the +x/+y differential rays), as numpy."""
    spp = jsmp.samples_per_pixel(jopts.sampler)
    lin = np.arange(jopts.xres * jopts.yres * spp)
    px = (lin // spp % jopts.xres).astype(np.int32)
    py = (lin // spp // jopts.xres).astype(np.int32)
    s_idx = (lin % spp).astype(np.int32)
    cs = jsmp.camera_samples(jopts.sampler, jnp.asarray(px), jnp.asarray(py),
                             jnp.asarray(s_idx), jopts.seed)

    def rays(dx, dy):
        return jcam.generate_rays(
            jscene.camera, cs["image_x"] + dx, cs["image_y"] + dy,
            cs["lens_u"], cs["lens_v"], cs["time"], jopts.xres, jopts.yres)
    o, d, mint, maxt, _ = rays(0.0, 0.0)
    rx, ry = rays(1.0, 0.0)[:2], rays(0.0, 1.0)[:2]
    return dict(px=px, py=py, s_idx=s_idx,
                **{k: np.array(v) for k, v in (("o", o), ("d", d),
                                               ("mint", mint),
                                               ("maxt", maxt))},
                rx=tuple(map(np.array, rx)), ry=tuple(map(np.array, ry)))


def tpuprt_chunk(jscene, jopts, aux=None):
    """tpuprt's render_chunk (its scan driver's step, run eagerly: the
    jitted render compiles for tens of seconds) over every camera sample of
    the film in one chunk, then develop: its image (rgb, alpha) and the
    per-sample (L, alpha, t_first) its Li gave, as numpy."""
    from tpuprt.film import film as jfilm
    spp = jsmp.samples_per_pixel(jopts.sampler)
    lin = np.arange(jopts.xres * jopts.yres * spp)
    got = []
    real = jax_render._li_dispatch

    def spy(*a, **k):
        out = real(*a, **k)
        got.append([np.asarray(x) for x in out])
        return out
    jax_render._li_dispatch = spy
    try:
        film = jax_render.render_chunk(
            jscene, jopts, jfilm.make_film(jopts.xres, jopts.yres),
            jnp.asarray((lin // spp % jopts.xres).astype(np.int32)),
            jnp.asarray((lin // spp // jopts.xres).astype(np.int32)),
            jnp.asarray((lin % spp).astype(np.int32)),
            jnp.ones(lin.shape, bool), aux)
    finally:
        jax_render._li_dispatch = real
    rgb, alpha = jfilm.develop(film)
    return np.asarray(rgb), np.asarray(alpha), got[0]


def port_li(tli, tstate, cam, tprm, opts):
    """The port's Li on tpuprt's camera samples: numpy (L, alpha,
    t_first)."""
    t = [torch.from_numpy(cam[k]) for k in ("o", "d", "mint", "maxt")]
    ids = [torch.from_numpy(cam[k]) for k in ("px", "py", "s_idx")]
    st = () if tstate is None else (tstate,)
    prm = () if tprm is None else (tprm,)
    out = tli(*(st + tuple(t)), opts.sampler, *ids, opts.max_depth,
              opts.seed, *prm, rx=tuple(map(torch.from_numpy, cam["rx"])),
              ry=tuple(map(torch.from_numpy, cam["ry"])))
    return [x.numpy() for x in out]


def per_sample_close(jout, tout, share=0.999):
    """L, alpha and t_first per camera sample: all within 1e-3 and `share`
    of the samples within 1e-4 (atol = rtol). Returns the samples outside
    1e-4."""
    ok = np.ones(len(jout[1]), bool)
    for j, t in zip(jout, tout):
        j = j.reshape(len(ok), -1)
        t = t.reshape(len(ok), -1)
        assert np.isclose(t, j, atol=1e-3, rtol=1e-3).all(), \
            np.abs(t - j).max()
        ok &= np.isclose(t, j, atol=1e-4, rtol=1e-4).all(1)
    assert ok.mean() >= share, (ok.mean(), np.nonzero(~ok)[0])
    return np.nonzero(~ok)[0]


def image_close(jrgb, jalpha, trgb, talpha, res=RES):
    """test_torch_render's rule: alpha equal, 99.5% of pixels within atol =
    rtol = 1e-4."""
    assert trgb.shape == (res, res, 3) and np.isfinite(trgb).all()
    np.testing.assert_array_equal(talpha, jalpha)
    close = np.isclose(trgb, jrgb, atol=1e-4, rtol=1e-4).all(-1)
    assert close.mean() >= 0.995, close.mean()


@pytest.mark.parametrize("name", ["config7", "config8", "config9",
                                  "config10"])
def test_parses_into_tpuprts_tables_and_options(name):
    text = scene_text(name, res=64)
    jscene, jopts = jax_load(text)
    tscene, topts = load_scene_string(text)
    want = {"config7": "exphotonmap", "config8": "igi",
            "config9": "irradiancecache", "config10": "bidirectional"}[name]
    assert topts.integrator == jopts.integrator == want
    assert tuple(topts.photon) == tuple(jopts.photon)
    assert tuple(topts.igi) == tuple(jopts.igi)
    assert tuple(topts.irrad) == tuple(jopts.irrad)
    assert (topts.max_depth, topts.sampler) == (jopts.max_depth,
                                                jopts.sampler)
    if name == "config7":
        assert topts.photon == tex.ExPhotonParams(
            max_dist=0.25, gather_samples=8, final_gather=True)
    if name == "config8":
        assert topts.igi == tigi.IgiParams(nlights=64, nsets=64)
    if name == "config9":
        assert topts.irrad == tic.IrradParams(maxerror=0.1, nsamples=2048)
    assert tscene.accel is None
    assert_tables_equal(tscene, from_numpy_tables(numpy_tables(jscene),
                                                  "cpu"))


@pytest.fixture(scope="module")
def config8():
    """config8 with 4 sets: tpuprt's virtual lights, and its render_chunk
    from them."""
    jscene, jopts, tscene, topts = both("config8")
    vls = jigi.build_virtual_lights(jscene, jopts.igi, 0)
    return (jscene, jopts, tscene, topts, vls,
            tpuprt_chunk(jscene, jopts, vls))


@pytest.fixture(scope="module")
def config10():
    jscene, jopts, tscene, topts = both("config10")
    return jscene, jopts, tscene, topts, None, tpuprt_chunk(jscene, jopts)


def test_virtual_lights_match_tpuprt(config8):
    """Per (set, vertex, path): valid masks equal; p, n and Le within
    1e-4."""
    _, _, tscene, topts, j, _ = config8
    t = tigi.build_virtual_lights(tscene, topts.igi, 0)
    assert (t.nsets, t.max_vl) == (j.nsets, j.max_vl) == (IGI_SETS, 64 * 8)
    assert float(t.n_paths) == float(j.n_paths) == 64.0
    valid = np.asarray(j.valid)
    np.testing.assert_array_equal(t.valid.numpy(), valid)
    # Lights at most first vertices (some paths leave through the open
    # front), fewer after the roulette.
    assert valid[:, :64].mean() > 0.7 and valid[:, 64 * 4:].mean() < 0.4
    for k in ("p", "n", "Le"):
        np.testing.assert_allclose(getattr(t, k).numpy()[valid],
                                   np.asarray(getattr(j, k))[valid],
                                   atol=1e-4, rtol=1e-4, err_msg=k)


def test_bidirectional_li_matches_tpuprt(config10):
    """config10 (a point light, matte walls and sphere), 16x16 x 2 spp."""
    jscene, jopts, tscene, _, _, (_, _, jout) = config10
    tout = port_li(lambda *a, **k: tbd.li(tscene, *a, **k), None,
                   camera_chunk(jscene, jopts), None, jopts)
    assert jout[0].max() > 0.1 and (jout[1] == 1).all()
    per_sample_close(jout, tout)


def test_igi_li_matches_tpuprt(config8):
    """config8 with 4 sets, from tpuprt's virtual lights."""
    jscene, jopts, tscene, topts, vls, (_, _, jout) = config8
    tout = port_li(lambda *a, **k: tigi.li(tscene, *a, **k),
                   virtual_lights_from_numpy(numpy_tables(vls), "cpu"),
                   camera_chunk(jscene, jopts), topts.igi, jopts)
    assert jout[0].max() > 1.0
    per_sample_close(jout, tout)


@pytest.mark.parametrize("name", ["config10", "config8"])
def test_driver_image_matches_tpuprt(name, request):
    """The port's render() (its chunked driver; igi from tpuprt's virtual
    lights) against tpuprt's render_chunk and develop, and the port's image
    with chunks of 100 lanes equal to its one-chunk image."""
    _, _, tscene, topts, jaux, (jrgb, jalpha, _) = \
        request.getfixturevalue(name)
    aux = None if jaux is None else \
        virtual_lights_from_numpy(numpy_tables(jaux), "cpu")
    stats = StatsRegistry()
    trgb, talpha = torch_render.render(tscene, topts, device="cpu", aux=aux,
                                       stats=stats)
    assert stats.get("Film", "Wavefront chunks") == 1
    image_close(jrgb, jalpha, trgb, talpha)
    real = torch_render.chunk_lanes
    torch_render.chunk_lanes = lambda device, total: 100
    try:
        crgb, calpha = torch_render.render(tscene, topts, device="cpu",
                                           aux=aux)
    finally:
        torch_render.chunk_lanes = real
    np.testing.assert_array_equal(calpha, talpha)
    np.testing.assert_allclose(crgb, trgb, rtol=1e-6, atol=1e-7)
