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

The descent mirror on these scenes is in test_torch_bvh_descent.py; the
builder's source, the deep tree, the stack sizing and the bindings in
test_torch_bvh_builds.py (no file holds more than ten cases).
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
    elif type(a) is tuple and any(dataclasses.is_dataclass(x) for x in a):
        assert type(b) is tuple and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tables_equal(x, y, f"{path}[{i}]")
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
    """render() hands the pool the tiles and their child-id table without
    the rows when the BVH has tiles, and the rows without the child-id
    table (the row walk reads its rows' own child ids) when it has none."""
    from tpuprt_torch import render as R
    _, tscene = scenes
    seen = []
    monkeypatch.setattr(R.path_wavefront, "render",
                        lambda scene, opts, device, **kw:
                        seen.append(scene.accel))
    rows_only = dataclasses.replace(tscene, accel=dataclasses.replace(
        tscene.accel, nodesT=None, nodeskip=None, nodemeta=None))
    for scene in (tscene, rows_only):
        R.render(scene, R.RenderOptions(), device="cpu")
    assert seen[0].nodes is None and seen[0].nodesT is not None
    assert torch.equal(seen[0].child, tscene.accel.child)
    assert torch.equal(seen[1].nodes, tscene.accel.nodes)
    assert seen[1].child is None and seen[1].max_depth == \
        tscene.accel.max_depth
    assert tscene.accel.nodes is not None


# The descent both CUDA walks now take, as a plain torch mirror: an entered
# interior node tests its children's boxes, enters the lowest hit and
# keeps (node << 8) | the other hits on a per-ray stack, one entry a
# level; a pop takes the deepest entry's lowest bit, so nodes are entered
# in preorder. The tile walk finds a node's children in the child-id
# table, the row walk in the node's own row (cols 8..15, by slot). It belongs to these tests: the plain versions stay the
# skip-link walks, and the mirror shows the two bit-identical on the CPU.

def _tiles_leaf(row, o, d, mint, maxt, bt, bi, any_hit):
    """The tile walk's leaf: 8 Moller-Trumbore tests on tile rows, the
    lowest id among equal t (traverse_tiles_ref's arithmetic)."""
    ox, oy, oz = (o[:, k, None] for k in range(3))
    dx, dy, dz = (d[:, k, None] for k in range(3))
    p0x, p0y, p0z = row[:, 0:8], row[:, 8:16], row[:, 16:24]
    e1x, e1y, e1z = row[:, 24:32], row[:, 32:40], row[:, 40:48]
    e2x, e2y, e2z = row[:, 48:56], row[:, 56:64], row[:, 64:72]
    pidf = row[:, 72:80]
    s1x, s1y, s1z = dy * e2z - dz * e2y, dz * e2x - dx * e2z, \
        dx * e2y - dy * e2x
    div = s1x * e1x + s1y * e1y + s1z * e1z
    ok = torch.abs(div) > 1e-12
    inv = 1.0 / torch.where(ok, div, 1.0)
    sx, sy, sz = ox - p0x, oy - p0y, oz - p0z
    b1 = (sx * s1x + sy * s1y + sz * s1z) * inv
    s2x, s2y, s2z = sy * e1z - sz * e1y, sz * e1x - sx * e1z, \
        sx * e1y - sy * e1x
    b2 = (dx * s2x + dy * s2y + dz * s2z) * inv
    t = (e2x * s2x + e2y * s2y + e2z * s2z) * inv
    valid = ok & (b1 >= 0.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0) & \
        (t > mint[:, None]) & (t < torch.minimum(maxt, bt)[:, None]) & \
        (pidf >= 0.0)
    if any_hit:
        valid = valid & (bi < 0)[:, None]
    tv = torch.where(valid, t, 1e30)
    tmin = tv.min(dim=1).values
    idmin = torch.where(valid & (tv <= tmin[:, None]), pidf,
                        1e30).min(dim=1).values
    upd = tmin < bt
    return torch.where(upd, tmin, bt), torch.where(upd, idmin.int(), bi)


def _rows_leaf(row, o, d, mint, maxt, bt, bi, any_hit):
    """The row walk's leaf: 8 tests in slot order against the running
    best, slot j valid for j < nprims and pid >= 0 (_walk_rows's)."""
    nprims = row[:, 7].long()
    for j in range(8):
        c = 8 + 9 * j
        p0 = row[:, c:c + 3]
        e1, e2 = row[:, c + 3:c + 6] - p0, row[:, c + 6:c + 9] - p0
        pid = row[:, 80 + j].to(torch.int32)
        s1 = [d[:, 1] * e2[:, 2] - d[:, 2] * e2[:, 1],
              d[:, 2] * e2[:, 0] - d[:, 0] * e2[:, 2],
              d[:, 0] * e2[:, 1] - d[:, 1] * e2[:, 0]]
        div = s1[0] * e1[:, 0] + s1[1] * e1[:, 1] + s1[2] * e1[:, 2]
        ok = torch.abs(div) > 1e-12
        inv = 1.0 / torch.where(ok, div, 1.0)
        s = [o[:, k] - p0[:, k] for k in range(3)]
        b1 = (s[0] * s1[0] + s[1] * s1[1] + s[2] * s1[2]) * inv
        s2 = [s[1] * e1[:, 2] - s[2] * e1[:, 1],
              s[2] * e1[:, 0] - s[0] * e1[:, 2],
              s[0] * e1[:, 1] - s[1] * e1[:, 0]]
        b2 = (d[:, 0] * s2[0] + d[:, 1] * s2[1] + d[:, 2] * s2[2]) * inv
        t = (e2[:, 0] * s2[0] + e2[:, 1] * s2[1] + e2[:, 2] * s2[2]) * inv
        valid = ok & (b1 >= 0.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0) & \
            (t > mint) & (t < torch.minimum(maxt, bt)) & (j < nprims) & \
            (pid >= 0)
        if any_hit:
            valid = valid & (bi < 0)
        bt = torch.where(valid, t, bt)
        bi = torch.where(valid, pid, bi)
    return bt, bi


def slot_children(nodes, nd):
    """The child ids of nodes `nd` by slot, from their rows' cols 8..15
    (-1 where the slot is empty or the node is a leaf): what the row walk
    descends by."""
    c = nodes[nd, 8:16]
    return torch.where((nodes[nd, 7:8] == 0) & (c > 0), c.long(), -1)


def descent_mirror(table, child, rays, nn, any_hit, rows):
    """The tile walk (rows=False: `table` the tile rows, `child` its
    child-id table) or the row walk (rows=True: `table` the node rows,
    whose own child ids it reads, `child` unused; each node's own box
    tested again on entry) as the CUDA kernels descend, vectorized over
    rays. Returns (t,
    id, steps i64[N]: the nodes the walk moved to, entered or not, entered
    i64[N]: the nodes entered, the most stack levels any ray held)."""
    n = rays.shape[1]
    o_all, d_all = rays[0:3].T, rays[3:6].T
    inv_all = bvh_cuda._safe_inv(d_all)
    best_t = torch.full((n,), 1e30)
    best_id = torch.full((n,), -1, dtype=torch.int32)
    node = torch.full((n,), 0 if nn else -1, dtype=torch.int64)
    top = torch.zeros(n, dtype=torch.int64)
    stack = torch.zeros((n, 64), dtype=torch.int64)
    steps, entered = torch.zeros_like(top), torch.zeros_like(top)
    deepest = 0

    def children(nd):
        return slot_children(table, nd) if rows else child[nd].long()
    while True:
        act = torch.nonzero(node >= 0).flatten()
        if not act.numel():
            break
        nd = node[act]
        row = table[nd]
        o, d, inv = o_all[act], d_all[act], inv_all[act]
        mint, maxt = rays[6, act], rays[7, act]
        bt, bi = best_t[act], best_id[act]
        ids = children(nd)
        clip = (torch.minimum(maxt, bt) * (1.0 + 1e-6))[:, None]
        own = bvh_cuda._slab_hit(row[:, :6], o, inv, mint, clip[:, 0]) \
            if rows else torch.ones_like(nd, dtype=torch.bool)
        if rows:
            leaf = own & (row[:, 7] > 0)
            inner = own & (row[:, 7] == 0)
            boxes = table[ids.clamp(min=0)][:, :, :6]
            leaf_fn = _rows_leaf
        else:
            leaf = ids[:, 0] < 0
            inner = ~leaf
            boxes = row[:, :48].reshape(-1, 6, 8).transpose(1, 2)
            leaf_fn = _tiles_leaf
        nt, ni = leaf_fn(row, o, d, mint, maxt, bt, bi, any_hit)
        best_t[act] = torch.where(leaf, nt, bt)
        best_id[act] = torch.where(leaf, ni, bi)
        hit = inner[:, None] & (ids >= 0) & bvh_cuda._slab_hit(
            boxes, o[:, None], inv[:, None], mint[:, None], clip)
        steps[act] += 1
        entered[act] += own.long()

        # Descend to the lowest hit; the others wait with their parent.
        hits = torch.where(hit, 1 << torch.arange(8), 0).sum(dim=1)
        down = hits > 0
        first = torch.log2((hits & -hits).clamp(min=1).double()).long()
        rest = hits & (hits - 1)
        t = top[act]
        push = rest > 0
        stack[act[push], t[push]] = (nd[push] << 8) | rest[push]
        t = t + push.long()
        nxt = torch.full_like(nd, -1)
        nxt[down] = ids[down, first[down]]
        deepest = max(deepest, int(t.max()))
        # Pop: the deepest entry's lowest bit; an entry with none left goes.
        up = ~down & (t > 0)
        e = stack[act[up], t[up] - 1]
        m = e & 0xFF
        left = m & (m - 1)
        stack[act[up], t[up] - 1] = (e & ~0xFF) | left
        bit = torch.log2((m & -m).double()).long()
        nxt[up] = children(e >> 8).gather(1, bit[:, None])[:, 0]
        t[up] -= (left == 0).long()
        if any_hit:
            nxt[leaf & (best_id[act] >= 0)] = -1
        top[act] = t
        node[act] = nxt
    return best_t, best_id, steps, entered, deepest


def skip_link_children(nodes, nn):
    """[n, r] = the r-th child of n along the skip links (n + 1, then each
    child's skip until n's own), -1 past the last."""
    skip = nodes[:nn, 6].long().tolist()
    nprims = nodes[:nn, 7].long().tolist()
    out = torch.full((nn, 8), -1, dtype=torch.int32)
    for n in range(nn):
        if nprims[n]:
            continue
        c, r = n + 1, 0
        while c < skip[n]:
            out[n, r] = c
            c, r = skip[c], r + 1
    return out


def _mirror_sets(tscene):
    import chip_smoke
    opts = load_scene_string(terrain_scene_text())[1]
    cam = chip_smoke.camera_rays(tscene, opts, "cpu")
    return {"camera": cam, "random": torch.from_numpy(make_rays(1200, 13))}
