"""The port's kd-tree held against tpuprt on the CPU.

- The port builds the tree from its own copy of tpuprt's native builder,
  equal to it line for line but for comments; the tables (node columns,
  leaf lists, padded bounds, max_depth, max_leaf_prims) equal tpuprt's,
  with the Accelerator statement's SAH knobs read as tpuprt reads them.
- Per ray (t, prim id) of the kd-restart walk against tpuprt's, nearest
  and any-hit, on test_torch_grid's scene of six quadrics over a terrain
  with repeated triangles.
- A small kd-tree scene, config4's terrain without a Sampler statement:
  pbrt-v1's default, "bestcandidate", which both packages' parsers read
  as their (0,2)-sequences (tpuprt/scene/parser.py:844-846); rendered at
  16x16 x 4 spp through both pools with the best-candidate sampler
  itself.
"""
import os
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from test_torch_bvh import assert_tables_equal, numpy_tables
from test_torch_grid import assert_walks_agree, mixed_rays, mixed_scene
from tpuprt import render as jax_render
from tpuprt.accel import intersect as jisect
from tpuprt.accel import kdtree as jkd
from tpuprt.samplers import samplers as jsmp
from tpuprt.scene.build import SceneBuilder as JaxBuilder
from tpuprt.scene.parser import load_scene_string as jax_load
from tpuprt_torch import render as torch_render
from tpuprt_torch.accel import intersect as tisect
from tpuprt_torch.accel import kdtree as tkd
from tpuprt_torch.accel import kdtree_build
from tpuprt_torch.scene.bridge import from_numpy_tables
from tpuprt_torch.scene.build import SceneBuilder
from tpuprt_torch.scene.data import KdTreeAccel
from tpuprt_torch.scene.parser import load_scene_string

torch.set_num_threads(1)
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, "tools"))
from make_scenes import config4  # noqa: E402

RES, SPP = 16, 4


def test_builder_source_is_tpuprts():
    port = kdtree_build.KDTREE_BUILD_SRC
    own = os.path.join(_ROOT, "tpuprt_torch")
    assert os.path.commonpath([port, own]) == own and os.path.isfile(port)

    def code(path):
        with open(path) as f:
            lines = (ln.split("//", 1)[0].rstrip() for ln in f)
            return [ln for ln in lines if ln]

    ref = code(os.path.join(_ROOT, "tpuprt", "native", "csrc",
                            "kdtree_build.cpp"))
    assert len(ref) > 100 and code(port) == ref


@pytest.fixture(scope="module")
def mixed():
    return mixed_scene(JaxBuilder(), "kdtree"), mixed_scene(SceneBuilder(),
                                                            "kdtree")


def test_kdtree_tables_equal_tpuprt(mixed):
    jscene, tscene = mixed
    assert isinstance(tscene.accel, KdTreeAccel)
    assert (tscene.accel.max_depth, tscene.accel.max_leaf_prims) == \
        (jscene.accel.max_depth, jscene.accel.max_leaf_prims)
    assert tscene.accel.max_leaf_prims > 1
    assert_tables_equal(tscene, from_numpy_tables(numpy_tables(jscene),
                                                  "cpu"))


@pytest.mark.parametrize("any_hit", [False, True])
def test_kdtree_walk_matches_tpuprt(mixed, any_hit):
    """Per ray (t, id). In any-hit mode a ray stops at the first leaf with
    a hit: its nearest hit there, the same in both packages; occluded
    gives tpuprt's mask."""
    jscene, tscene = mixed
    o, d, mint, maxt = mixed_rays()
    jargs = [jnp.asarray(x) for x in (o, d, mint, maxt)]
    targs = [torch.from_numpy(x) for x in (o, d, mint, maxt)]
    jt, jid, jhit = jkd.intersect(jscene, *jargs, any_hit=any_hit)
    tt, tid, thit = tkd.intersect(tscene, *targs, any_hit=any_hit)
    np.testing.assert_array_equal(thit.numpy(), np.asarray(jhit))
    assert_walks_agree(jscene, tscene, jt, jid, tt, tid, o, d)
    jid = np.asarray(jid)
    assert len(set(jid[(jid >= 0) & (jid < 6)].tolist())) == 6
    assert (jid >= 6).sum() > len(o) // 5
    if any_hit:
        np.testing.assert_array_equal(
            tisect.occluded(tscene, *targs).numpy(),
            np.asarray(jisect.occluded(jscene, *jargs)))
        # Some rays stop at a hit short of their nearest.
        near = tisect.intersect_ids(tscene, *targs)[0].numpy()
        assert (tt.numpy() > near * (1 + 1e-5)).sum() > 20


def test_sah_knobs_follow_the_statement():
    """intersectcost, traversalcost, emptybonus, maxprims and maxdepth
    reach the builder as tpuprt's parser hands them over."""
    text = (config4(12).replace(
        'Accelerator "kdtree"',
        'Accelerator "kdtree" "integer maxprims" [4] "integer maxdepth" [6]'
        ' "float intersectcost" [40] "float emptybonus" [0.2]'
        ' "float traversalcost" [2]'))
    jscene, _ = jax_load(text)
    tscene, _ = load_scene_string(text)
    assert tscene.accel.max_depth <= 7 and tscene.accel.max_leaf_prims > 1
    assert_tables_equal(tscene, from_numpy_tables(numpy_tables(jscene),
                                                  "cpu"))


def test_kdtree_render_without_sampler_matches_tpuprt():
    """test_torch_render's rule: 99.5% of pixels within atol = rtol =
    1e-4, alpha equal. The best-candidate sampler, which no parsed file
    reaches, is set in both packages' options."""
    text = config4(30).replace("[128]", f"[{RES}]")
    lines = [ln for ln in text.splitlines() if not ln.startswith("Sampler")]
    assert len(lines) == len(text.splitlines()) - 1
    text = "\n".join(lines) + "\n"
    jscene, jopts = jax_load(text)
    tscene, topts = load_scene_string(text)
    assert isinstance(tscene.accel, KdTreeAccel)
    assert topts.sampler == (jopts.sampler.kind, jopts.sampler.xsamples,
                             jopts.sampler.ysamples, jopts.sampler.jitter,
                             jopts.sampler.pixelsamples)
    assert topts.sampler.kind == "lowdiscrepancy" and \
        topts.sampler.pixelsamples == SPP
    assert_tables_equal(tscene, from_numpy_tables(numpy_tables(jscene),
                                                  "cpu"))
    jopts = jopts._replace(sampler=jopts.sampler._replace(
        kind="bestcandidate"))
    # tpuprt caches its best-candidate tables as jnp arrays: filled first
    # inside its pool's jit they leak a tracer (tpuprt/samplers/
    # samplers.py:179), so fill the cache eagerly, as test_smoke's order
    # does.
    jsmp._BC_CACHE.pop(SPP, None)
    jsmp._bc_tables(SPP)
    topts = topts._replace(sampler=topts.sampler._replace(
        kind="bestcandidate"))
    jrgb, jalpha = jax_render.render(jscene, jopts)
    trgb, talpha = torch_render.render(tscene, topts, device="cpu")
    assert trgb.shape == (RES, RES, 3) and np.isfinite(trgb).all()
    np.testing.assert_array_equal(talpha, jalpha)
    close = np.isclose(trgb, jrgb, atol=1e-4, rtol=1e-4).all(-1)
    assert close.mean() >= 0.995, close.mean()
    assert trgb.mean() > 0.1
