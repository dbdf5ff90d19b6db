"""The port's counter-based sampling and camera held against tpuprt.

- rng hashes, uniforms, the (0,2)-sequence and its Sobol' dimension are
  bit-identical to tpuprt.core.rng on random counters, including values
  at and above 2^31 (the uint32 math runs in int64 masked to 32 bits).
- The lowdiscrepancy camera samples and the perspective camera rays of a
  16x16 film match within 1e-6.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from test_torch_bvh import terrain_scene_text
from tpuprt.cameras import cameras as jcam
from tpuprt.core import rng as jrng
from tpuprt.samplers import samplers as jsmp
from tpuprt.scene.parser import load_scene_string as jax_load
from tpuprt_torch.cameras import cameras as tcam
from tpuprt_torch.core import rng as trng
from tpuprt_torch.samplers import samplers as tsmp
from tpuprt_torch.scene.parser import load_scene_string

torch.set_num_threads(1)


def counters(n=4096, seed=3):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 2 ** 32, size=(3, n), dtype=np.uint64).astype(
        np.uint32)
    c[:, :4] = [[0, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]] * 3
    return c


def to_torch(c):
    return torch.from_numpy(c.astype(np.int64))


def test_hash_and_uniform_bit_identical():
    a, b, c = counters()
    np.testing.assert_array_equal(
        np.asarray(jrng.hash_u32(a, b, 0xC0FFEE, c)).astype(np.int64),
        trng.hash_u32(to_torch(a), to_torch(b), 0xC0FFEE,
                      to_torch(c)).numpy())
    ju = np.asarray(jrng.uniform(a, b, 16))
    tu = trng.uniform(to_torch(a), to_torch(b), 16).numpy()
    np.testing.assert_array_equal(ju.view(np.uint32), tu.view(np.uint32))


@pytest.mark.parametrize("fn", ["van_der_corput", "sobol2"])
def test_radical_inverses_bit_identical(fn):
    n, scr, _ = counters(seed=5)
    j = np.asarray(getattr(jrng, fn)(jnp.asarray(n), jnp.asarray(scr)))
    t = getattr(trng, fn)(to_torch(n), to_torch(scr)).numpy()
    np.testing.assert_array_equal(j.view(np.uint32), t.view(np.uint32))


def test_sample02_bit_identical():
    n, sx, sy = counters(seed=9)
    jx, jy = jrng.sample02(jnp.asarray(n), jnp.asarray(sx), jnp.asarray(sy))
    tx, ty = trng.sample02(to_torch(n), to_torch(sx), to_torch(sy))
    for j, t in ((jx, tx), (jy, ty)):
        np.testing.assert_array_equal(np.asarray(j).view(np.uint32),
                                      t.numpy().view(np.uint32))


def test_camera_samples_and_rays_match():
    text = terrain_scene_text()
    jscene, jopts = jax_load(text)
    tscene, topts = load_scene_string(text)
    spp = 2
    lin = np.arange(16 * 16 * spp)
    px = (lin // spp % 16).astype(np.int32)
    py = (lin // spp // 16).astype(np.int32)
    s_idx = (lin % spp).astype(np.int32)
    jcs = jsmp.camera_samples(jopts.sampler, jnp.asarray(px),
                              jnp.asarray(py), jnp.asarray(s_idx), 0)
    tcs = tsmp.camera_samples(topts.sampler, torch.from_numpy(px),
                              torch.from_numpy(py), torch.from_numpy(s_idx),
                              0)
    for k in ("image_x", "image_y"):
        np.testing.assert_allclose(tcs[k].numpy(), np.asarray(jcs[k]),
                                   rtol=1e-6, atol=1e-6)
    jo, jd, jmint, jmaxt, _ = jcam.generate_rays(
        jscene.camera, jcs["image_x"], jcs["image_y"], jcs["lens_u"],
        jcs["lens_v"], jcs["time"], 16, 16)
    to, td, tmint, tmaxt, _ = tcam.generate_rays(
        tscene.camera, tcs["image_x"], tcs["image_y"], tcs["lens_u"],
        tcs["lens_v"], tcs["time"], 16, 16)
    for t, j in ((to, jo), (td, jd), (tmint, jmint)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(tmaxt.numpy(), np.asarray(jmaxt), rtol=1e-6)
