"""The port's host side and BVH traversal held against tpuprt on the
terrain(50) scene (4802 triangles, ~790 nodes).

- The port's parser + builder give tables EQUAL to tpuprt's, read through
  tpuprt_torch.scene.bridge (the BVH comes from the same native builder,
  whose source the port carries as a copy identical but for comments).
- The plain tile walk (ops/bvh_cuda.traverse_tiles_ref) matches the Pallas
  tile kernel run in interpret mode, and the plain row walk
  (traverse_rows_ref) the Pallas row kernels, whole-table and chunked,
  nearest and any-hit.
- The ray-sorting front end changes no result; without tiles the front
  end walks the rows, with the tile walk's hits.

The CUDA kernels themselves run only on a card: chip_smoke.py holds them
against the plain versions there.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

torch.set_num_threads(1)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, "tools"))
from make_scenes import config4  # noqa: E402

from tpuprt.ops import bvh_pallas  # noqa: E402
from tpuprt.scene.parser import load_scene_string as jax_load  # noqa: E402
from tpuprt_torch.accel import bvh_build  # noqa: E402
from tpuprt_torch.ops import bvh_cuda  # noqa: E402
from tpuprt_torch.scene.bridge import from_numpy_tables  # noqa: E402
from tpuprt_torch.scene.parser import load_scene_string  # noqa: E402


def terrain_scene_text(n=50, res=16, spp=2):
    """config4's terrain/checkerboard/lights at a test size, left to the
    automatic accelerator (the BVH above 4096 triangles)."""
    return (config4(n).replace('Accelerator "kdtree"\n', "")
            .replace("[128]", f"[{res}]")
            .replace('"integer pixelsamples" [4]',
                     f'"integer pixelsamples" [{spp}]'))


def numpy_tables(x):
    """tpuprt SceneData -> the nested numpy dicts bridge.from_numpy_tables
    takes."""
    if dataclasses.is_dataclass(x):
        return {f.name: numpy_tables(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if hasattr(x, "_asdict"):
        return dict(x._asdict())
    if isinstance(x, tuple):
        return tuple(numpy_tables(v) for v in x)
    if isinstance(x, jax.Array):
        return np.asarray(x)
    return x


def assert_tables_equal(a, b, path="scene"):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path
    elif dataclasses.is_dataclass(a):
        assert type(a) is type(b), path
        for f in dataclasses.fields(a):
            assert_tables_equal(getattr(a, f.name), getattr(b, f.name),
                                f"{path}.{f.name}")
    else:
        assert a == b, path


def make_rays(n=2048, seed=7):
    """Packed f32[8, n] rays: most aim from above at the terrain, a quarter
    point in random directions, a fifth carry a short maxt."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.5, 1.5, n)
    tgt = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    tgt[:, 1] = rng.uniform(-0.4, 0.4, n)
    d = tgt - o
    d[::4] = rng.normal(size=(len(d[::4]), 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mint = np.full(n, 1e-3, np.float32)
    maxt = np.full(n, 1e30, np.float32)
    maxt[1::5] = rng.uniform(0.2, 2.0, len(maxt[1::5]))
    return np.ascontiguousarray(np.concatenate(
        [o, d.astype(np.float32), mint[:, None], maxt[:, None]], 1).T)


def assert_hits_agree(t_ref, id_ref, t, ids, t_rtol=1e-6):
    """Equal hit masks; equal ids where both hit, except at ties (the two
    t's equal within 1e-6 relative); t within `t_rtol` relative."""
    t_ref, id_ref, t, ids = (np.asarray(x) for x in (t_ref, id_ref, t, ids))
    hit = id_ref >= 0
    np.testing.assert_array_equal(hit, ids >= 0)
    rel = np.abs(t - t_ref) / np.maximum(np.abs(t_ref), 1e-30)
    tie = rel <= 1e-6
    assert np.all((ids == id_ref) | (hit & tie))
    assert np.all(rel[hit] <= t_rtol), rel[hit].max()
    return rel[hit]


@pytest.fixture(scope="module")
def scenes():
    text = terrain_scene_text()
    jscene, _ = jax_load(text)
    tscene, _ = load_scene_string(text)
    return jscene, tscene


def test_tables_equal_tpuprt(scenes):
    jscene, tscene = scenes
    assert tscene.accel.n_nodes == jscene.accel.n_nodes
    assert tscene.triangles.count == 4802
    assert_tables_equal(tscene, from_numpy_tables(numpy_tables(jscene),
                                                  "cpu"))


@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_traversal_matches_pallas_interpret(scenes, any_hit):
    jscene, tscene = scenes
    rays = make_rays()
    b = jscene.accel
    jt, jid = bvh_pallas.traverse_tiles(
        b.nodesT, b.nodeskip, b.nodemeta, jnp.asarray(rays), nn=b.n_nodes,
        any_hit=any_hit, interpret=True)
    a = tscene.accel
    t, ids = bvh_cuda.traverse_tiles_ref(
        a.nodesT, a.nodeskip, a.nodemeta, torch.from_numpy(rays),
        nn=a.n_nodes, any_hit=any_hit)
    # XLA:CPU contracts multiply-adds into FMAs inside the interpreted
    # kernel, eager torch (and the CUDA kernel, built -fmad=false) does
    # not; the Moller-Trumbore cross products cancel, so one rounding step
    # can move t by a few 1e-6 relative. 99% of hits stay within 1e-6.
    rel = assert_hits_agree(jt, jid, t, ids, t_rtol=1e-5)
    assert (np.asarray(jid) >= 0).sum() > 500
    assert np.mean(rel <= 1e-6) >= 0.99


def test_front_end_sort_changes_nothing(scenes):
    _, tscene = scenes
    rays = torch.from_numpy(make_rays(n=1500, seed=11))
    o, d, mint, maxt = rays[0:3].T, rays[3:6].T, rays[6], rays[7]
    for any_hit in (False, True):
        t0, id0, h0 = bvh_cuda.intersect(tscene.accel, o, d, mint, maxt,
                                         any_hit=any_hit, sort=False)
        t1, id1, h1 = bvh_cuda.intersect(tscene.accel, o, d, mint, maxt,
                                         any_hit=any_hit, sort=True)
        assert torch.equal(t0, t1) and torch.equal(id0, id1)
        assert torch.equal(h0, h1) and bool(h0.any())


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_row_walk_matches_pallas_interpret(scenes, chunked, any_hit):
    """traverse_rows_ref against bvh_pallas.traverse (the whole table) and
    traverse_chunked (64-row chunks), with test_plain_traversal's
    tolerances."""
    jscene, tscene = scenes
    rays = make_rays(seed=8)
    b = jscene.accel
    nodes128 = jnp.pad(b.nodes, ((0, 0), (0, 128 - b.nodes.shape[1])))
    kw = dict(nn=b.n_nodes, leaf_k=b.leaf_k, any_hit=any_hit,
              interpret=True)
    if chunked:
        jt, jid = bvh_pallas.traverse_chunked(nodes128, jnp.asarray(rays),
                                              cap=64, **kw)
    else:
        jt, jid = bvh_pallas.traverse(nodes128, jnp.asarray(rays), **kw)
    a = tscene.accel
    t, ids = bvh_cuda.traverse_rows_ref(a.nodes, torch.from_numpy(rays),
                                        nn=a.n_nodes, any_hit=any_hit)
    assert (np.asarray(jid) >= 0).sum() > 500
    if any_hit:
        np.testing.assert_array_equal(np.asarray(jid) >= 0, ids.numpy() >= 0)
        return
    rel = assert_hits_agree(jt, jid, t, ids, t_rtol=1e-5)
    assert np.mean(rel <= 1e-6) >= 0.99


def test_rows_when_tiles_rejected(scenes, monkeypatch):
    """build_bvh keeps the rows and leaves nodesT None when build_tiles
    rejects the tree (here: a depth limit of 1); the front end then walks
    the rows and finds the tile walk's hits (ids equal except at ties)."""
    _, tscene = scenes
    monkeypatch.setattr(bvh_build, "MAX_TILE_DEPTH", 1)
    rows_only = bvh_build.build_bvh(tscene.triangles)
    assert rows_only.nodesT is None and rows_only.nodemeta is None
    assert torch.equal(rows_only.nodes, tscene.accel.nodes)
    rays = torch.from_numpy(make_rays(n=1500, seed=12))
    o, d, mint, maxt = rays[0:3].T, rays[3:6].T, rays[6], rays[7]
    for any_hit in (False, True):
        t0, id0, h0 = bvh_cuda.intersect(tscene.accel, o, d, mint, maxt,
                                         any_hit=any_hit)
        t1, id1, h1 = bvh_cuda.intersect(rows_only, o, d, mint, maxt,
                                         any_hit=any_hit)
        assert torch.equal(h0, h1) and bool(h0.any())
        if not any_hit:
            assert_hits_agree(t0, id0, t1, id1)


def test_render_copies_only_the_walked_format(scenes, monkeypatch):
    """render() hands the pool the tiles without the rows when the BVH has
    tiles, and the rows when it has none."""
    from tpuprt_torch import render as R
    _, tscene = scenes
    seen = []
    monkeypatch.setattr(R.path_wavefront, "render",
                        lambda scene, opts, device: seen.append(scene.accel))
    rows_only = dataclasses.replace(tscene, accel=dataclasses.replace(
        tscene.accel, nodesT=None, nodeskip=None, nodemeta=None))
    for scene in (tscene, rows_only):
        R.render(scene, R.RenderOptions(), device="cpu")
    assert seen[0].nodes is None and seen[0].nodesT is not None
    assert torch.equal(seen[1].nodes, tscene.accel.nodes)
    assert tscene.accel.nodes is not None


def test_builder_source_is_tpuprts():
    """The port builds its BVH from its own copy of tpuprt's native builder,
    line for line in everything but comments, so the trees (and the tables
    compared above) match; it builds its kernels from its own sources too."""
    port = bvh_build.BVH_BUILD8_SRC
    own = os.path.join(_ROOT, "tpuprt_torch")
    for src in (port, bvh_cuda.KERNEL_SRC, bvh_cuda.ROWS_SRC):
        assert os.path.commonpath([src, own]) == own and os.path.isfile(src)

    def code(path):
        with open(path) as f:
            lines = (ln.split("//", 1)[0].rstrip() for ln in f)
            return [ln for ln in lines if ln]

    ref = code(os.path.join(_ROOT, "tpuprt", "native", "csrc",
                            "bvh_build8.cpp"))
    assert len(ref) > 100 and code(port) == ref
