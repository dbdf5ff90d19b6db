"""Host-side construction of the wide (8-ary) skip-link BVH (port of
tpuprt/accel/bvh_build.py: build_rows, build_tiles, build_bvh).

The tree comes from the same native binned-SAH builder as the reference:
``csrc/bvh_build8.cpp`` here is a copy of tpuprt's
``native/csrc/bvh_build8.cpp``, equal to it in everything but comments (a
test holds the two equal line for line with comments stripped), compiled
with g++ at first use, so the port walks the same tree bit for bit and ids
can be compared per ray. The reference's NumPy LBVH fallback is not carried
over: without g++ the build raises.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from ..native import GXX, build_shared
from ..scene.data import BvhAccel
from .grid_build import prim_bounds

LEAF_K = 8
BRANCH = 8
ROW_W = 96
NODE_COLS = 128    # rows are padded to this width for the row-walk kernels
MAX_TILE_DEPTH = 32

BVH_BUILD8_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "csrc", "bvh_build8.cpp")


def _native_builder():
    fn = build_shared(BVH_BUILD8_SRC, GXX).tpuprt_bvh_build8
    fptr = ctypes.POINTER(ctypes.c_float)
    iptr = ctypes.POINTER(ctypes.c_int)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, fptr, fptr, ctypes.c_int, ctypes.c_int,
                   fptr, ctypes.c_int, fptr, ctypes.c_int, iptr]
    return fn, fptr, iptr


def build_rows(lo, hi, nq, tri9):
    """Binned-SAH wide BVH over prim AABBs (nq quadrics first, then
    triangles with packed verts tri9; a leaf inlines its triangles'
    vertices, a quadric's slot stays zero). Shared by the scene BVH
    (build_bvh) and the per-prototype BLAS builds (accel/instances.py,
    nq 0). Returns (rows f32[NN,96], prim_ids i32[NN,LEAF_K], nn)."""
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    tri9 = np.ascontiguousarray(tri9, np.float32)
    p = len(lo)
    # Prim ids and node counts ride in f32 rows: exact only below 2^24.
    if p >= (1 << 24):
        raise ValueError(f"{p} prims exceeds the f32-id row format")
    fn, fptr, iptr = _native_builder()
    cap = max(p // 2 + 64, 64)
    while True:
        rows = np.zeros((cap, ROW_W), np.float32)
        prim_ids = np.full((cap, LEAF_K), -1, np.int32)
        nn = fn(p, lo.ctypes.data_as(fptr), hi.ctypes.data_as(fptr), nq,
                len(tri9), tri9.ctypes.data_as(fptr), LEAF_K,
                rows.ctypes.data_as(fptr), cap,
                prim_ids.ctypes.data_as(iptr))
        if nn == -1:
            cap *= 2
            continue
        if nn < 0:
            raise RuntimeError(f"native BVH build failed ({nn})")
        if nn >= (1 << 24):
            raise ValueError(f"{nn} nodes exceeds the f32-id row format")
        return rows[:nn], prim_ids[:nn], nn


def pad_rows(rows):
    """f32[NN, 96] rows -> f32[NN, NODE_COLS] (zero columns appended)."""
    out = np.zeros((len(rows), NODE_COLS), np.float32)
    out[:, :rows.shape[1]] = rows
    return out


def tree_links(rows, nn: int):
    """Depth, rank (sibling index in emission order) and parent of each of
    the nn preorder nodes of skip-link rows (col 6 skip, col 7 nprims),
    from the skip links alone. Returns (depth i32[NN], rank i32[NN],
    parent i64[NN], -1 at the root)."""
    rows = np.asarray(rows)
    skip = rows[:nn, 6].astype(np.int64)
    nprims = rows[:nn, 7].astype(np.int32)
    depth = np.zeros(nn, np.int32)
    rank = np.zeros(nn, np.int32)
    parent = np.full(nn, -1, np.int64)
    stack = []                     # [end, node, children_so_far]
    for i in range(nn):
        while stack and stack[-1][0] <= i:
            stack.pop()
        if stack:
            top = stack[-1]
            depth[i] = len(stack)
            rank[i] = top[2]
            parent[i] = top[1]
            top[2] += 1
        if nprims[i] == 0:
            stack.append([skip[i], i, 0])
    return depth, rank, parent


def child_table(rank, parent):
    """The child-id table the tile walk descends by: i32[NN, BRANCH], entry
    [n, r] the node id of n's child of rank r, -1 where there is none (a
    leaf's row is all -1). Raises on a node with more than BRANCH children, which
    the row format (8 child slots) cannot hold."""
    nn = len(rank)
    if rank.max(initial=0) >= BRANCH:
        raise ValueError(f"a node has more than {BRANCH} children")
    child = np.full((nn, BRANCH), -1, np.int32)
    nonroot = parent >= 0
    child[parent[nonroot], rank[nonroot]] = np.nonzero(nonroot)[0]
    return child


def build_tiles(rows, prim_ids, nn: int, leaf_k: int = LEAF_K, links=None):
    """Re-pack skip-link rows into the param-major tile format the traversal
    kernel walks. Row n (128 f32 lanes): lanes [8k, 8k+8) hold param k of
    the node's 8 payload slots — interior: child j's [lo(3), hi(3)];
    leaf: triangle j's [p0(3), e1(3), e2(3), pid]. skip and meta
    (depth | rank<<5 | nprims<<8) are separate i32 tables. `links`:
    tree_links(rows, nn), computed here when not given.

    Returns (tilesP f32[NN,128], skip i32[NN], meta i32[NN]) or None when
    the tree is deeper than the walk's per-depth stack.
    """
    rows = np.asarray(rows)
    prim_ids = np.asarray(prim_ids).reshape(nn, leaf_k)
    skip = rows[:nn, 6].astype(np.int64)
    nprims = rows[:nn, 7].astype(np.int32)
    depth, rank, parent = links if links is not None else \
        tree_links(rows, nn)
    if nn and int(depth.max()) >= MAX_TILE_DEPTH:
        return None
    if rank.max(initial=0) >= BRANCH:
        return None

    tiles = np.zeros((nn, 16, 8), np.float32)   # [node, param, slot]
    interior = nprims == 0
    # Interior: empty child slots get inverted boxes (never entered).
    tiles[interior, 0:3, :] = 1e30
    tiles[interior, 3:6, :] = -1e30
    nonroot = parent >= 0
    p = parent[nonroot]
    r = rank[nonroot]
    bb = rows[:nn][nonroot]
    for k in range(6):
        tiles[p, k, r] = bb[:, k]
    # Leaves: slot j = triangle j as [p0, e1, e2, pid]; empty slots are
    # all-zero with pid -1.
    L = ~interior
    if L.any():
        verts = rows[:nn][L][:, 8:8 + 9 * leaf_k].reshape(-1, leaf_k, 9)
        p0 = verts[:, :, 0:3]
        tiles[L, 0:3, :leaf_k] = p0.transpose(0, 2, 1)
        tiles[L, 3:6, :leaf_k] = (verts[:, :, 3:6] - p0).transpose(0, 2, 1)
        tiles[L, 6:9, :leaf_k] = (verts[:, :, 6:9] - p0).transpose(0, 2, 1)
        tiles[L, 9, :leaf_k] = prim_ids[L].astype(np.float32)
        tiles[L, 9, leaf_k:] = -1.0
    meta = depth | (rank << 5) | (nprims << 8)
    return (np.ascontiguousarray(tiles.reshape(nn, 128)),
            skip.astype(np.int32), meta.astype(np.int32))


def build_bvh(tri, quad=None) -> BvhAccel:
    """BVH over a host TriangleTable and QuadricTable (numpy-backed
    tensors; prims the quadrics first, then the triangles, as
    tpuprt/accel/bvh_build.py:233-266 orders them): the rows, padded to
    NODE_COLS, the tree's depth (the row walk's stack), the child-id table
    the tile walk descends by, and the tile format, or no tiles (nodesT
    None) when the tree holds quadrics or build_tiles rejects it. The
    front end walks the tiles, else the rows: by the row-walk kernel
    without quadrics, by the plain skip-link walk with them
    (accel/bvh.py)."""
    nq = quad.count if quad is not None else 0
    idx = tri.idx.numpy()
    verts = tri.verts.numpy()
    pts = verts[idx]                                     # [T,3,3]
    lo = pts.min(1).astype(np.float32)
    hi = pts.max(1).astype(np.float32)
    if nq:
        qlo, qhi = prim_bounds(quad, None)
        lo = np.concatenate([qlo.astype(np.float32), lo])
        hi = np.concatenate([qhi.astype(np.float32), hi])
    tri9 = np.concatenate([verts[idx[:, 0]], verts[idx[:, 1]],
                           verts[idx[:, 2]]], axis=1).astype(np.float32) \
        if tri.count else np.zeros((1, 9), np.float32)
    rows, prim_ids, nn = build_rows(lo, hi, nq, tri9)
    links = tree_links(rows, nn)
    built = build_tiles(rows, prim_ids, nn, LEAF_K, links) if nq == 0 \
        else None
    tiles = nskip = nmeta = None
    if built is not None:
        tiles, nskip, nmeta = (torch.from_numpy(a) for a in built)
    pad = 1e-4 * max(np.abs(lo).max(initial=0),
                     np.abs(hi).max(initial=0)) + 1e-4
    return BvhAccel(
        bounds_lo=torch.from_numpy(lo.min(0) - pad),
        bounds_hi=torch.from_numpy(hi.max(0) + pad),
        nodes=torch.from_numpy(pad_rows(rows)),
        tri9=torch.from_numpy(tri9), nodesT=tiles, nodeskip=nskip,
        nodemeta=nmeta, child=torch.from_numpy(child_table(*links[1:])),
        max_depth=int(links[0].max(initial=0)), n_nodes=nn, leaf_k=LEAF_K,
        n_quadrics=nq)
