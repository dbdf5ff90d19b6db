"""A BVH that holds quadrics, held against tpuprt on the CPU: config2 (a
1280-triangle plastic icosphere, a 2-triangle matte floor and a one-sided
disk area light) with Accelerator "bvh".

- The tables equal tpuprt's (through the bridge): the rows over the
  quadric first, then the triangles, and no tile table; render() copies the
  rows to the device (bvh_cuda.walked_only).
- Per ray (t, prim id) of the plain skip-link walk against tpuprt's jnp
  walk, nearest and any-hit, on the camera rays and on rays aimed at the
  disk light.
- A 16x16 x 4 spp render through both packages' pools.
"""
import os
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from test_torch_brute import camera_rays
from test_torch_bvh import (assert_hits_agree, assert_tables_equal,
                            numpy_tables)
from tpuprt import render as jax_render
from tpuprt.accel import bvh as jbvh
from tpuprt.scene.parser import load_scene_string as jax_load
from tpuprt_torch import render as torch_render
from tpuprt_torch.accel import bvh as tbvh
from tpuprt_torch.ops import bvh_cuda
from tpuprt_torch.scene.bridge import from_numpy_tables
from tpuprt_torch.scene.data import BvhAccel
from tpuprt_torch.scene.parser import load_scene_string

torch.set_num_threads(1)
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, "tools"))
from make_scenes import config2  # noqa: E402

RES, SPP = 16, 4


@pytest.fixture(scope="module")
def scenes():
    text = (config2().replace('Accelerator "grid"', 'Accelerator "bvh"')
            .replace("[128]", f"[{RES}]")
            .replace('"integer pixelsamples" [8]',
                     f'"integer pixelsamples" [{SPP}]'))
    return jax_load(text) + load_scene_string(text)


def test_tables_equal_tpuprt(scenes):
    jscene, _, tscene, _ = scenes
    bvh = tscene.accel
    assert isinstance(bvh, BvhAccel) and bvh.n_quadrics == 1
    assert bvh.nodesT is None and bvh.n_nodes == jscene.accel.n_nodes
    # The quadric is prim 0, in a leaf like any triangle.
    used = torch.arange(8) < bvh.nodes[:, 7:8]
    assert (bvh.nodes[:, 80:88][used] == 0).sum() == 1
    assert_tables_equal(tscene, from_numpy_tables(numpy_tables(jscene),
                                                  "cpu"))
    walked = bvh_cuda.walked_only(bvh)
    assert walked.nodes is bvh.nodes and walked.child is None


@pytest.mark.parametrize("any_hit", [False, True])
def test_walk_matches_tpuprt(scenes, any_hit):
    """Equal hit masks and ids (but at ties), t within 1e-5 relative (the
    winner's t recomputed through each package's prim test; XLA contracts
    the quadric's multiply-adds), every other ray ending short of its
    hit."""
    jscene, jopts, tscene, _ = scenes
    o, d, mint, maxt = camera_rays(jscene, jopts)
    maxt = np.where(np.arange(len(maxt)) % 3 == 0, 2.5, maxt).astype(
        np.float32)
    jt, jid, jhit = jbvh.intersect(jscene, *map(jnp.asarray,
                                                (o, d, mint, maxt)),
                                   any_hit=any_hit)
    tt, tid, thit = tbvh.intersect(
        tscene, *(torch.from_numpy(x) for x in (o, d, mint, maxt)),
        any_hit=any_hit)
    np.testing.assert_array_equal(thit.numpy(), np.asarray(jhit))
    jid = np.asarray(jid)
    # Nearest: hits on the disk, the floor and the icosphere; any hit: the
    # first prim the walk finds.
    assert (jid == 0).sum() > 100 and (jid > 1280).sum() > 50 and \
        ((jid > 0) & (jid <= 1280)).sum() > (20 if any_hit else 50)
    assert_hits_agree(jt, jid, tt, tid, t_rtol=1e-5)


def test_render_matches_tpuprt(scenes):
    """test_torch_render's rule: 99.5% of pixels within atol = rtol =
    1e-4, alpha equal."""
    jscene, jopts, tscene, topts = scenes
    jrgb, jalpha = jax_render.render(jscene, jopts)
    trgb, talpha = torch_render.render(tscene, topts, device="cpu")
    assert trgb.shape == (RES, RES, 3) and np.isfinite(trgb).all()
    np.testing.assert_array_equal(talpha, jalpha)
    close = np.isclose(trgb, jrgb, atol=1e-4, rtol=1e-4).all(-1)
    assert close.mean() >= 0.995, close.mean()
    assert trgb.max() > 1.0     # the light is seen
