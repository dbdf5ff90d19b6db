"""The port's whole slice held against tpuprt on the CPU: the terrain(50)
scene with a checkerboard, an infinite and a distant light, 16x16 x 2 spp
directlighting, through both packages' scene parser and render().

On the CPU the port's traversal runs its plain version; tpuprt runs its
jnp row walk. Also: per-camera-ray intersections, the film's develop and
f16 readback, the EXR writer, and that the port imports no JAX.
"""
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import torch

from test_torch_bvh import assert_hits_agree, terrain_scene_text
from tpuprt import render as jax_render
from tpuprt.accel import intersect as jisect
from tpuprt.cameras import cameras as jcam
from tpuprt.film import film as jfilm
from tpuprt.io import exr as jexr
from tpuprt.samplers import samplers as jsmp
from tpuprt.scene.parser import load_scene_string as jax_load
from tpuprt_torch import render as torch_render
from tpuprt_torch.accel import intersect as tisect
from tpuprt_torch.film import film as tfilm
from tpuprt_torch.io import exr as texr
from tpuprt_torch.scene.parser import load_scene_string

torch.set_num_threads(1)
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_render_matches_tpuprt():
    text = terrain_scene_text()
    jscene, jopts = jax_load(text)
    tscene, topts = load_scene_string(text)
    jrgb, jalpha = jax_render.render(jscene, jopts)
    trgb, talpha = torch_render.render(tscene, topts, device="cpu")
    assert trgb.shape == (16, 16, 3) and np.isfinite(trgb).all()
    np.testing.assert_array_equal(talpha, jalpha)
    # Every sample uses the same counter-based streams, so pixels agree to
    # float rounding. A pixel may still differ where a 1-ulp difference in
    # a grazing ray flips a hit, hence 99.5% and not all.
    close = np.isclose(trgb, jrgb, atol=1e-4, rtol=1e-4).all(-1)
    assert close.mean() >= 0.995, close.mean()


def test_intersect_ids_match_per_camera_ray():
    text = terrain_scene_text()
    jscene, jopts = jax_load(text)
    tscene, _ = load_scene_string(text)
    lin = np.arange(16 * 16 * 2)             # every pixel, both samples
    px = (lin // 2 % 16).astype(np.int32)
    py = (lin // 2 // 16).astype(np.int32)
    s_idx = (lin % 2).astype(np.int32)
    cs = jsmp.camera_samples(jopts.sampler, jnp.asarray(px), jnp.asarray(py),
                             jnp.asarray(s_idx), 0)
    o, d, mint, maxt, _ = jcam.generate_rays(
        jscene.camera, cs["image_x"], cs["image_y"], cs["lens_u"],
        cs["lens_v"], cs["time"], 16, 16)
    jt, jid, jhit = jisect.intersect_ids(jscene, o, d, mint, maxt)
    tt, tid, thit = tisect.intersect_ids(
        tscene, *(torch.from_numpy(np.array(x)) for x in (o, d, mint, maxt)))
    np.testing.assert_array_equal(thit.numpy(), np.asarray(jhit))
    assert np.asarray(jhit).sum() > 100
    # t is recomputed through the same triangle test on both sides.
    assert_hits_agree(jt, jid, tt, tid)


def test_film_develop_and_half_match_tpuprt():
    """develop's weight divide and to_half's clip-to-f16 quantization, on
    a film with an empty pixel and a value past the f16 range."""
    rng = np.random.default_rng(5)
    data = rng.uniform(0.0, 4.0, (6, 7, 5)).astype(np.float32)
    data[0, 0] = 0.0
    data[1, 1, 0] = 1e6
    j = jfilm.to_half(*jfilm.develop(jfilm.Film(data=jnp.asarray(data),
                                                xres=7, yres=6)))
    t = tfilm.to_half(*tfilm.develop(tfilm.Film(data=torch.from_numpy(data),
                                                xres=7, yres=6)))
    for jv, tv in zip(j, t):
        assert tv.dtype == torch.float16
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_exr_matches_tpuprt(tmp_path):
    """The port's EXR writer gives tpuprt's bytes (half pixels, ZIPS), and
    both readers return the same arrays."""
    rng = np.random.default_rng(6)
    rgb = rng.uniform(0.0, 3.0, (5, 9, 3)).astype(np.float32)
    alpha = rng.uniform(0.0, 1.0, (5, 9)).astype(np.float32)
    port, ref = tmp_path / "port.exr", tmp_path / "ref.exr"
    texr.write_exr(str(port), rgb, alpha)
    jexr.write_exr(str(ref), rgb, alpha)
    assert port.read_bytes() == ref.read_bytes()
    for t, j in zip(texr.read_exr(str(port)), jexr.read_exr(str(port))):
        np.testing.assert_array_equal(t, j)
    np.testing.assert_allclose(texr.read_exr(str(port))[0], rgb, rtol=1e-3)


def test_port_imports_no_jax():
    """Every module of the package (pkgutil.walk_packages over
    tpuprt_torch, the CLI's __main__ included) imports without JAX or the
    JAX package."""
    code = ("import importlib, pkgutil, sys, tpuprt_torch; "
            "mods = [m.name for m in pkgutil.walk_packages("
            "tpuprt_torch.__path__, 'tpuprt_torch.')]; "
            "[importlib.import_module(m) for m in mods]; "
            "need = {'tpuprt_torch.cli', 'tpuprt_torch.__main__', "
            "'tpuprt_torch.utils.stats', 'tpuprt_torch.utils.progress', "
            "'tpuprt_torch.utils.errors', 'tpuprt_torch.tonemaps.tonemaps', "
            "'tpuprt_torch.samplers.bc_gen', 'tpuprt_torch.volumes.regions', "
            "'tpuprt_torch.integrators.volume', "
            "'tpuprt_torch.scene.tessellate'}; "
            "assert need <= set(mods), need - set(mods); "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'tpuprt' or "
            "m.startswith('tpuprt.')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=_ROOT, check=True,
                   timeout=120)
