"""Host-side SAH kd-tree construction (port of tpuprt/accel/kdtree_build.py,
its native route; pbrt-v1 accelerators/kdtree.cpp:141-311).

The tree comes from the same native builder as the reference:
``csrc/kdtree_build.cpp`` here is a copy of tpuprt's
``native/csrc/kdtree_build.cpp``, equal to it in everything but comments (a
test holds the two equal line for line with comments stripped), compiled
with g++ and tpuprt's flags at first use, so the port walks the same tree.
The reference's NumPy fallback is not carried over: without g++ the build
raises. SAH knobs default to pbrt-v1's (isect 80, traversal 1, empty bonus
0.5, one prim a leaf, depth 8 + 1.3 log2 N; kdtree.cpp:489-498).
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from ..native import GXX, build_shared
from ..scene.data import KdTreeAccel, QuadricTable, TriangleTable
from .grid_build import prim_bounds

KDTREE_BUILD_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "csrc", "kdtree_build.cpp")


def _build_native(lo, hi, isect_cost, trav_cost, empty_bonus, max_prims,
                  max_depth):
    """The native build (tpuprt/accel/kdtree_build.py:144-185): node and
    id capacities grow fourfold on overflow, four times at most."""
    fn = build_shared(KDTREE_BUILD_SRC, GXX).tpuprt_kdtree_build
    fn.restype = ctypes.c_int
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    fn.argtypes = [ctypes.c_int, f32p, f32p, ctypes.c_float, ctypes.c_float,
                   ctypes.c_float, ctypes.c_int, ctypes.c_int,
                   i32p, f32p, i32p, i32p, i32p,
                   ctypes.c_int, ctypes.c_int, i32p]
    n = len(lo)
    node_cap = max(4 * n + 16, 512)
    idx_cap = max(16 * n + 16, 1024)
    lo32 = np.ascontiguousarray(lo, np.float32)
    hi32 = np.ascontiguousarray(hi, np.float32)
    for _ in range(4):
        flags = np.zeros(node_cap, np.int32)
        split = np.zeros(node_cap, np.float32)
        above = np.zeros(node_cap, np.int32)
        nprims = np.zeros(node_cap, np.int32)
        ids = np.zeros(idx_cap, np.int32)
        counts = np.zeros(4, np.int32)
        r = fn(n, lo32, hi32, isect_cost, trav_cost, empty_bonus, max_prims,
               max_depth, flags, split, above, nprims, ids, node_cap,
               idx_cap, counts)
        if r >= 0:
            nn, ni = int(counts[0]), int(counts[1])
            return (flags[:nn], split[:nn], above[:nn], nprims[:nn],
                    ids[:max(ni, 1)], int(counts[2]), int(counts[3]),
                    lo32.min(0).astype(np.float64),
                    hi32.max(0).astype(np.float64))
        node_cap *= 4
        idx_cap *= 4
    raise RuntimeError(f"native kd-tree build failed for {n} prims")


def build_kdtree(quad: QuadricTable, tri: TriangleTable, isect_cost=80.0,
                 trav_cost=1.0, empty_bonus=0.5, max_prims=1,
                 max_depth=-1) -> KdTreeAccel:
    lo, hi = prim_bounds(quad, tri)
    flags, split, above, nprims, ids, max_leaf, depth_seen, blo, bhi = \
        _build_native(lo, hi, isect_cost, trav_cost, empty_bonus, max_prims,
                      max_depth)
    # The root box, padded (tpuprt/accel/kdtree_build.py:200).
    pad = 1e-4 * np.maximum(np.abs(blo), np.abs(bhi)).max() + 1e-4
    t = torch.from_numpy
    return KdTreeAccel(
        bounds_lo=t(np.asarray(blo - pad, np.float32)),
        bounds_hi=t(np.asarray(bhi + pad, np.float32)),
        node_flags=t(np.ascontiguousarray(flags)),
        node_split=t(np.ascontiguousarray(split)),
        node_above=t(np.ascontiguousarray(above)),
        node_nprims=t(np.ascontiguousarray(nprims)),
        prim_ids=t(np.ascontiguousarray(ids)),
        max_depth=max(int(depth_seen) + 1, 1),
        max_leaf_prims=max(int(max_leaf), 1))
