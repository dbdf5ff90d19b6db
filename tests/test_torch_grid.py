"""The port's uniform grid held against tpuprt on the CPU.

- The grid's tables (resolution, bounds, CSR cell lists) equal tpuprt's,
  on config2 as its file asks (Accelerator "grid") and on a scene of six
  quadrics over a triangle terrain, some triangles repeated (ties).
- Per ray (t, prim id) of the DDA walk against tpuprt's, nearest and
  through occluded (the grid has no any-hit mode: both packages run the
  nearest walk); "auto" between 65 and 4096 prims builds the grid.
- A 16x16 x 4 spp render of config2 with its grid through both packages'
  pools.
"""
import os
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from test_torch_bvh import (assert_hits_agree, assert_tables_equal,
                            numpy_tables)
from test_torch_mt import condition
from test_torch_quadrics import rays_at_quadrics
from tpuprt import render as jax_render
from tpuprt.accel import intersect as jisect
from tpuprt.scene.build import SceneBuilder as JaxBuilder
from tpuprt.scene.parser import load_scene_string as jax_load
from tpuprt_torch import render as torch_render
from tpuprt_torch.accel import intersect as tisect
from tpuprt_torch.core import transform as tf
from tpuprt_torch.scene.bridge import from_numpy_tables
from tpuprt_torch.scene.build import SceneBuilder
from tpuprt_torch.scene.data import GridAccel
from tpuprt_torch.scene.parser import load_scene_string

torch.set_num_threads(1)
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, "tools"))
from make_scenes import config2, terrain  # noqa: E402

RES, SPP = 16, 4
N_RAYS = 8192


def mixed_scene(b, accel):
    """Six quadrics (one of each kind, as test_torch_quadrics lays them
    out) over a terrain of 128 triangles, every 7th repeated after the
    others, on builder `b` with Accelerator `accel`."""
    m = b.matte()

    def at(x, deg, axis, mirror=False):
        xf = tf.translate((x, 0.2 * x, 0.5)) @ tf.rotate(deg, axis)
        return xf @ tf.scale(-1, 1, 1) if mirror else xf

    b.add_sphere(at(-5, 30, (1, 0, 0)), 1.0, -0.6, 0.8, 300.0, m)
    b.add_cylinder(at(-3, 70, (0, 1, 1)), 0.7, -0.5, 0.9, 250.0, m,
                   reverse_orientation=True)
    b.add_disk(at(-1, 50, (1, 1, 0)), 0.2, 1.0, 0.3, 270.0, m)
    b.add_cone(at(1, 110, (1, 0, 1)), 0.8, 1.2, 320.0, m)
    b.add_paraboloid(at(3, 20, (0, 1, 0), mirror=True), 0.9, 0.1, 1.1,
                     290.0, m)
    b.add_hyperboloid(at(5, 60, (1, 2, 3)), (0.3, 0.0, -0.5),
                      (0.6, 0.4, 0.7), 330.0, m)
    v, f = terrain(9)
    v = v.astype(np.float32) * np.float32([7, 2, 4]) + \
        np.float32([0, -1.5, 0.5])
    b.add_trianglemesh(np.eye(4), np.concatenate([f, f[::7]]), v,
                       material=m)
    b.add_distant_light(np.eye(4), (1.0, 1.0, 1.0), (0, 1, 0), (0, 0, 0))
    b.accel_kind = accel
    return b.build()


def mixed_rays():
    """Rays at the quadrics (test_torch_quadrics), every third aimed at the
    terrain instead; a seventh carry a short maxt."""
    o, d, mint, maxt = rays_at_quadrics(N_RAYS, 3)
    rng = np.random.default_rng(9)
    k = np.arange(0, N_RAYS, 3)
    tgt = np.stack([rng.uniform(-3.5, 3.5, len(k)), np.full(len(k), -1.3),
                    rng.uniform(-1.5, 2.5, len(k))], 1)
    aim = tgt - o[k]
    d[k] = (aim / np.linalg.norm(aim, axis=1, keepdims=True)).astype(
        np.float32)
    return o, d, mint, maxt


def assert_walks_agree(jscene, tscene, jt, jid, tt, tid, o, d):
    """Equal hit masks and ids, except at ties, where the t's agree; t
    within test_torch_mt's tolerance: 1e-6 relative times the pair's
    condition number on a triangle, 1e-5 relative on a quadric (XLA:CPU
    contracts the quadratic's multiply-adds, eager torch does not)."""
    rel = assert_hits_agree(jt, jid, tt, tid, t_rtol=1e-5)
    jid = np.asarray(jid)
    nq = tscene.quadrics.count
    tri = jid[jid >= 0] >= nq
    v, idx = tscene.triangles.verts.numpy(), tscene.triangles.idx.numpy()
    k = np.where(jid >= nq, jid - nq, 0)
    p0, p1, p2 = (v[idx[:, i]] for i in range(3))
    cond = condition(p0, p1, p2, o, d, k)[jid >= 0]
    assert np.all(rel[tri] <= 1e-6 * cond[tri]), (rel[tri] / cond[tri]).max()
    return rel


@pytest.fixture(scope="module")
def mixed():
    return mixed_scene(JaxBuilder(), "grid"), mixed_scene(SceneBuilder(),
                                                          "grid")


def test_grid_tables_equal_tpuprt(mixed):
    jscene, tscene = mixed
    assert isinstance(tscene.accel, GridAccel)
    assert tscene.accel.nvoxels == jscene.accel.nvoxels
    assert tscene.accel.max_per_voxel > 1
    # "auto" at 153 prims takes the grid too.
    assert isinstance(mixed_scene(SceneBuilder(), "auto").accel, GridAccel)
    assert_tables_equal(tscene, from_numpy_tables(numpy_tables(jscene),
                                                  "cpu"))


def test_grid_walk_matches_tpuprt(mixed):
    """Nearest and occluded per ray; the hits cover every quadric, the
    terrain and its repeated triangles (ties: the first-tested wins)."""
    jscene, tscene = mixed
    o, d, mint, maxt = mixed_rays()
    jargs = [jnp.asarray(x) for x in (o, d, mint, maxt)]
    targs = [torch.from_numpy(x) for x in (o, d, mint, maxt)]
    jt, jid, jhit = jisect.intersect_ids(jscene, *jargs)
    tt, tid, thit = tisect.intersect_ids(tscene, *targs)
    np.testing.assert_array_equal(thit.numpy(), np.asarray(jhit))
    assert_walks_agree(jscene, tscene, jt, jid, tt, tid, o, d)
    jid = np.asarray(jid)
    assert len(set(jid[(jid >= 0) & (jid < 6)].tolist())) == 6
    assert (jid >= 6).sum() > N_RAYS // 5
    # The repeated triangles (the last ids) never win: each original is
    # tested first at equal t.
    n_terrain = len(terrain(9)[1])
    assert tscene.triangles.count > n_terrain
    assert (jid >= 6 + n_terrain).sum() == 0
    np.testing.assert_array_equal(
        tisect.occluded(tscene, *targs).numpy(),
        np.asarray(jisect.occluded(jscene, *jargs)))


@pytest.fixture(scope="module")
def config2_scenes():
    text = (config2().replace("[128]", f"[{RES}]")
            .replace('"integer pixelsamples" [8]',
                     f'"integer pixelsamples" [{SPP}]'))
    assert 'Accelerator "grid"' in text
    return jax_load(text) + load_scene_string(text)


def test_config2_grid_tables_equal_tpuprt(config2_scenes):
    jscene, _, tscene, _ = config2_scenes
    assert isinstance(tscene.accel, GridAccel)
    assert (tscene.quadrics.count, tscene.triangles.count) == (1, 1282)
    assert_tables_equal(tscene, from_numpy_tables(numpy_tables(jscene),
                                                  "cpu"))


def test_config2_grid_render_matches_tpuprt(config2_scenes):
    """test_torch_render's rule: 99.5% of pixels within atol = rtol =
    1e-4, alpha equal."""
    jscene, jopts, tscene, topts = config2_scenes
    jrgb, jalpha = jax_render.render(jscene, jopts)
    trgb, talpha = torch_render.render(tscene, topts, device="cpu")
    assert trgb.shape == (RES, RES, 3) and np.isfinite(trgb).all()
    np.testing.assert_array_equal(talpha, jalpha)
    close = np.isclose(trgb, jrgb, atol=1e-4, rtol=1e-4).all(-1)
    assert close.mean() >= 0.995, close.mean()
    assert trgb.max() > 1.0     # the light is seen
