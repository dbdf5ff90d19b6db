"""The scan integrators and the chunked driver's options in the port held
against tpuprt on the CPU, on config3 (the Cornell box: a disk light, a
glass and a mirror sphere, no accelerator) with a point, a distant and an
infinite light added, at 16x16 x 2 spp.

- The scan Li of whitted, directlighting (strategies "all", "one" and
  "weighted"), path, debug (every channel) and photonmap, per camera
  sample, against tpuprt's `_li_dispatch` on the same numpy rays and ids.
  tpuprt's Li runs under jax.disable_jit: op by op its arithmetic matches
  the port's (no FMA contraction), and it costs a fraction of the scan's
  compile. Photonmap's maps are built by tpuprt's build_photon_grid from
  photons placed on the scene's surfaces (no shooting) and carried across
  by the bridge.
- The port's pool against its own scan for "one" and "weighted" (the
  analogue of tests/test_wavefront.py:166-179).
- RenderOptions.driver routes as tpuprt's (tpuprt/render.py:226-234); the
  parser reads the debug integrator and the film's writefrequency.
- A checkpointed and resumed render equals the straight one, and the
  partial image is written (the analogue of tests/test_operability.py:87).

The debug Li is in test_torch_scan_debug.py, the driver's routing in
test_torch_scan_routes.py (no file holds more than ten cases).
"""
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from test_torch_bvh import numpy_tables
from test_torch_gi import camera_chunk
from test_torch_path import EXTRA_LIGHTS, scene_text
from tpuprt import render as jax_render
from tpuprt.accel import photon_grid as jgrid
from tpuprt.integrators import photonmap as jpm
from tpuprt.scene.parser import load_scene_string as jax_load
from tpuprt_torch import render as torch_render
from tpuprt_torch.film import film as tfilm
from tpuprt_torch.integrators import photonmap as tpm
from tpuprt_torch.scene.bridge import photon_maps_from_numpy
from tpuprt_torch.scene.data import to_device
from tpuprt_torch.scene.parser import load_scene_string
from tpuprt_torch.utils.stats import StatsRegistry

torch.set_num_threads(1)
RES, SPP = 16, 2
POINT = ('LightSource "point" "point from" [0.3 0.6 -0.4] '
         '"color I" [2 2 2]\n')
# Depths: 2 for the specular-only scans (a glass or mirror bounce and one
# more), 1 for photonmap (a final gather at both vertices), 4 for path
# (Russian roulette acts from bounce 3 on).
DEPTH = {"whitted": 2, "directlighting": 2, "photonmap": 1, "path": 4}
# Per sample (the existing files' rule, tests/test_torch_path.py): L
# within atol = rtol = 2e-4, alpha equal, t_first within rtol 2e-4.
L_TOL, T_RTOL = 2e-4, 2e-4


def text():
    return scene_text(spp=SPP).replace(
        "WorldBegin\n", "WorldBegin\n" + POINT + EXTRA_LIGHTS)


@pytest.fixture(scope="module")
def scenes():
    jscene, jopts = jax_load(text())
    tscene, topts = load_scene_string(text())
    assert tscene.lights.count == jscene.lights.count == 4
    return jscene, jopts, tscene, topts, camera_chunk(jscene, jopts)


def tpuprt_li(jscene, jopts, cam, aux=None):
    """tpuprt's _li_dispatch on the chunk, op by op: numpy (L, alpha,
    t_first)."""
    a = [jnp.asarray(cam[k]) for k in ("o", "d", "mint", "maxt", "px", "py",
                                       "s_idx")]
    with jax.disable_jit():
        out = jax_render._li_dispatch(
            jscene, jopts, *a, rx=tuple(map(jnp.asarray, cam["rx"])),
            ry=tuple(map(jnp.asarray, cam["ry"])), aux=aux)
    return [np.asarray(x) for x in out]


def port_li(tscene, topts, cam, aux=None):
    t = [torch.from_numpy(cam[k]) for k in ("o", "d", "mint", "maxt", "px",
                                            "py", "s_idx")]
    out = torch_render.li(tscene, topts, aux, *t,
                          rx=tuple(map(torch.from_numpy, cam["rx"])),
                          ry=tuple(map(torch.from_numpy, cam["ry"])))
    return [x.numpy() for x in out]


def per_sample_close(jout, tout):
    (jL, ja, jt), (tL, ta, tt) = jout, tout
    assert tL.shape == jL.shape and np.isfinite(tL).all()
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_allclose(tt, jt, rtol=T_RTOL)
    np.testing.assert_allclose(tL, jL, atol=L_TOL, rtol=L_TOL)


@pytest.mark.parametrize("integrator,strategy", [
    ("whitted", "all"), ("directlighting", "all"),
    ("directlighting", "one"), ("directlighting", "weighted"),
    ("path", "all")])
def test_scan_li_matches_tpuprt(scenes, integrator, strategy):
    jscene, jopts, tscene, topts, cam = scenes
    kw = dict(integrator=integrator, direct_strategy=strategy,
              max_depth=DEPTH[integrator])
    jout = tpuprt_li(jscene, jopts._replace(**kw), cam)
    tout = port_li(tscene, topts._replace(**kw), cam)
    per_sample_close(jout, tout)
    assert jout[0].max() > 0.5        # lit, and the light is seen


def surface_photons(tscene, n, seed):
    """n photons on the scene's surfaces: the hits of rays from inside
    the box, random incoming directions and powers."""
    from tpuprt_torch.accel import intersect as tisect
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t, _, hit = tisect.intersect_ids(
        tscene, torch.from_numpy(o), torch.from_numpy(d),
        torch.full((n,), 1e-3), torch.full((n,), 1e30))
    hit = hit.numpy()
    p = (o + t.numpy()[:, None] * d)[hit]
    wi = rng.normal(size=p.shape).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    return p, wi, rng.uniform(0.01, 0.1, p.shape).astype(np.float32)


def test_photonmap_scan_li_matches_tpuprt(scenes):
    """photonmap.li (tpuprt/integrators/photonmap.py:469-528) with a final
    gather of 1 sample (tpuprt's eager gather compiles its ops anew for
    each gather width), on maps tpuprt's grid builder makes from the same
    photons."""
    jscene, jopts, tscene, topts, cam = scenes
    prm = jpm.PhotonParams(max_dist=0.15, final_gather=True,
                           gather_samples=1)
    grids = {}
    # Few photons a bucket: tpuprt's lookup loops over the fullest
    # bucket's count, op by op.
    for k, (n, seed) in {"caustic": (300, 1), "direct": (600, 2),
                         "indirect": (600, 3)}.items():
        p, wi, alpha = surface_photons(tscene, n, seed)
        grids[k] = jgrid.build_photon_grid(p, wi, alpha, prm.max_dist,
                                           float(n))
    jmaps = jpm.PhotonMaps(**grids)
    kw = dict(integrator="photonmap", max_depth=DEPTH["photonmap"])
    jout = tpuprt_li(jscene, jopts._replace(photon=prm, **kw), cam, jmaps)
    tout = port_li(tscene, topts._replace(
        photon=tpm.PhotonParams(**prm._asdict()), **kw), cam,
        photon_maps_from_numpy(numpy_tables(jmaps), "cpu"))
    per_sample_close(jout, tout)
    assert jout[0].max() > 0.5


CORNELL_LIGHTS = """
Film "image" "integer xresolution" [24] "integer yresolution" [24]
Camera "perspective" "float fov" [55]
Sampler "lowdiscrepancy" "integer pixelsamples" [2]
PixelFilter "box" "float xwidth" [0.5] "float ywidth" [0.5]
SurfaceIntegrator "directlighting"
WorldBegin
LightSource "point" "point from" [-1 1 1] "color I" [20 20 20]
LightSource "distant" "point from" [3 6 -4] "point to" [0 0 0]
    "color L" [0.5 0.5 0.5]
AttributeBegin
  AreaLightSource "area" "color L" [8 8 8]
  Translate 0 1.9 3
  Shape "sphere" "float radius" [0.3]
AttributeEnd
Material "matte" "color Kd" [0.7 0.7 0.7]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-3 -1.2 0  3 -1.2 0  3 -1.2 6  -3 -1.2 6]
Translate 0 0 3
AttributeBegin
  Material "matte" "color Kd" [0.2 0.6 0.3]
  Translate 0 -0.5 0
  Shape "sphere" "float radius" [0.7]
AttributeEnd
AttributeBegin
  Material "mirror"
  Translate 1.2 -0.3 -0.5
  Shape "sphere" "float radius" [0.45]
AttributeEnd
WorldEnd
"""


@pytest.mark.parametrize("strategy", ["one", "weighted"])
def test_pool_matches_scan(strategy):
    """The pool renders directlighting's "one" and "weighted" and matches
    the scan driver (tests/test_wavefront.py:166-179's tolerance)."""
    scene, opts = load_scene_string(CORNELL_LIGHTS)
    opts = opts._replace(chunk_size=256, direct_strategy=strategy)
    rgb_scan, alpha_scan = torch_render.render(
        scene, opts._replace(driver="scan"), device="cpu")
    rgb_wf, alpha_wf = torch_render.render(
        scene, opts._replace(driver="wavefront"), device="cpu")
    assert np.isfinite(rgb_wf).all() and rgb_wf.max() > 0.1
    np.testing.assert_allclose(rgb_wf, rgb_scan, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(alpha_wf, alpha_scan, atol=1e-5)


OPERABILITY = """
Film "image" "integer xresolution" [32] "integer yresolution" [24]
    "string filename" ["out.exr"] "integer writefrequency" [256]
Camera "perspective" "float fov" [60]
Sampler "lowdiscrepancy" "integer pixelsamples" [1]
PixelFilter "box" "float xwidth" [0.5] "float ywidth" [0.5]
SurfaceIntegrator "whitted"
WorldBegin
LightSource "point" "point from" [0 0 0] "color I" [10 10 10]
AttributeBegin
  Translate 0 0 3
  Shape "sphere" "float radius" [1]
AttributeEnd
WorldEnd
"""


def test_parser_reads_debug_and_writefrequency():
    scene, opts = load_scene_string(OPERABILITY.replace(
        '"whitted"', '"debug"'))
    assert opts.integrator == "debug" and opts.writefrequency == 256
    assert opts.driver == "auto" and opts.debug_channels == ("u", "v", "hit")
    rgb, alpha = torch_render.render(scene, opts, device="cpu")
    assert alpha.max() == 1.0 and alpha.min() == 0.0
    assert ((rgb[..., 2] == 1.0) == (alpha == 1.0)).all()   # "hit"


def test_checkpoint_resume_matches_straight_render(tmp_path):
    scene, opts = load_scene_string(OPERABILITY)
    opts = opts._replace(chunk_size=256,
                         filename=str(tmp_path / "partial.exr"))
    stats = StatsRegistry()
    rgb_ref, alpha_ref = torch_render.render(scene, opts, device="cpu",
                                             stats=stats)
    assert os.path.exists(opts.filename)       # writefrequency's image
    total = 32 * 24
    assert stats.get("Film", "Wavefront chunks") == total // 256 and \
        stats.get("Film", "Chunk lanes") == 256
    assert rgb_ref.max() > 0.1

    # The first half of the chunks by hand, checkpointed, then resumed.
    ckpt = str(tmp_path / "film.ckpt.npz")
    sc = to_device(scene, "cpu")
    film = tfilm.make_film(opts.xres, opts.yres, opts.crop, "cpu")
    half = total // 256 // 2
    for c in range(half):
        lin = torch.arange(c * 256, (c + 1) * 256)
        torch_render.render_chunk(
            sc, opts, film, (lin % 32).to(torch.int32),
            (lin // 32).to(torch.int32), torch.zeros(256, dtype=torch.int32))
    torch_render.save_checkpoint(ckpt, film, half, opts)
    stats = StatsRegistry()
    rgb_res, alpha_res = torch_render.render(
        scene, opts, device="cpu", stats=stats, checkpoint_path=ckpt,
        resume=True)
    assert stats.get("Film", "Wavefront chunks") == total // 256 - half
    np.testing.assert_allclose(rgb_res, rgb_ref, atol=1e-5)
    np.testing.assert_allclose(alpha_res, alpha_ref, atol=1e-5)
    # Another sample schedule refuses the checkpoint.
    with pytest.raises(ValueError, match="different render"):
        torch_render.render(scene, opts._replace(seed=1), device="cpu",
                            checkpoint_path=ckpt, resume=True)
