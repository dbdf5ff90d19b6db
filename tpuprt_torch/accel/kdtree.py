"""kd-tree traversal by stackless kd-restart (port of tpuprt/accel/kdtree.py;
pbrt-v1 KdTreeAccel::Intersect and IntersectP, accelerators/kdtree.cpp:
313-483, with tpuprt's walk in place of the todo stack), in plain torch.

Each ray keeps a window [t0, tend] inside the tree's box. A pass descends
from the root to the leaf holding t0 (max_depth steps; the near child by
the side of the plane the origin lies on, t1 clamped at each plane it
crosses), tests the leaf's prims in slot order with a strict `<`, and
ends the ray when its best hit lies at or before the leaf's exit
(best_t <= t1 (1 + 1e-6) + 1e-7) or, in any-hit mode, on any hit;
otherwise t0 advances to max(t1, t0 + 1e-7). The walk runs detached
(tpuprt/accel/kdtree.py:78-81); the winner's t is then recomputed with
maxt 1e30, as on the grid.

As on the grid (accel/grid.py), only the live rays are carried from pass
to pass, and a leaf's (ray, slot) pairs are tested in one batch with the
slot-order tie rule; each ray's tests and their order are tpuprt's.
"""
from __future__ import annotations

import torch

from ..core import vecmath as vm
from ..scene.data import KdTreeAccel, SceneData
from .grid import nearest_in_ranges, recompute_t

_BIG = 1e30


def descend(kd: KdTreeAccel, o, inv_d, t0, t1):
    """Each ray from the root to the leaf that holds its window's start t0,
    with t1 clamped to the first split plane past t0: (leaf, t1)
    (tpuprt/accel/kdtree.py:27-61)."""
    node = torch.zeros(t0.shape, dtype=torch.long, device=t0.device)
    for _ in range(kd.max_depth):
        flags = kd.node_flags[node]
        interior = flags < 3
        axis = torch.clamp(flags, max=2).long()[:, None]
        split = kd.node_split[node]
        o_a = torch.gather(o, 1, axis)[:, 0]
        inv_a = torch.gather(inv_d, 1, axis)[:, 0]
        tplane = (split - o_a) * inv_a
        # The near child by the origin's side (kdtree.cpp:348-351).
        below_first = (o_a < split) | ((o_a == split) & (inv_a < 0.0))
        below = node + 1
        above = kd.node_above[node].long()
        near = torch.where(below_first, below, above)
        far = torch.where(below_first, above, below)
        # tplane <= 0: moving away from the plane, stay near; tplane <= t0:
        # the window starts past the plane, far; tplane >= t1: it ends
        # before the plane, near; else near, the window clamped at it.
        pos = tplane > 0.0
        far_only = pos & (tplane <= t0)
        clamp = pos & (tplane > t0) & (tplane < t1)
        node = torch.where(interior, torch.where(far_only, far, near), node)
        t1 = torch.where(interior & clamp, tplane, t1)
    return node, t1


def intersect(scene: SceneData, o, d, mint, maxt, any_hit: bool = False):
    """Nearest hit (t, prim_id, hit) by kd-restart; any_hit stops a ray at
    the first leaf with a hit (its nearest there)."""
    return recompute_t(scene, walk(scene, o, d, mint, maxt, any_hit), o, d,
                       mint)


@torch.no_grad()
def walk(scene: SceneData, o, d, mint, maxt, any_hit: bool = False):
    """The kd-restart walk, detached: each ray's winning prim id, -1 where
    none."""
    kd: KdTreeAccel = scene.accel
    lo, hi = kd.bounds_lo, kd.bounds_hi
    n = o.shape[0]
    dev = o.device
    inside0 = torch.all((o >= lo) & (o <= hi), -1)
    hit_b, t0b, t1b = vm.bbox_intersect_p(lo, hi, o, d, mint, maxt)
    tstart = torch.where(inside0, mint, t0b)
    tend = torch.minimum(t1b, maxt)
    live = torch.nonzero((inside0 | hit_b) & (tstart <= tend)).squeeze(1)

    o_l, d_l, mint_l, maxt_l = o[live], d[live], mint[live], maxt[live]
    t0, tend_l = tstart[live], tend[live]
    d_safe = torch.where(torch.abs(d_l) < 1e-12,
                         torch.where(d_l < 0, -1e-12, 1e-12), d_l)
    inv_d = 1.0 / d_safe
    bt = torch.full(live.shape, _BIG, dtype=torch.float32, device=dev)
    bid = torch.full(live.shape, -1, dtype=torch.int32, device=dev)
    best_t = torch.full((n,), _BIG, dtype=torch.float32, device=dev)
    best_id = torch.full((n,), -1, dtype=torch.int32, device=dev)

    while live.numel():
        leaf, t1 = descend(kd, o_l, inv_d, t0, tend_l)
        t_v, id_v = nearest_in_ranges(
            scene, kd.prim_ids, kd.node_above[leaf], kd.node_nprims[leaf],
            o_l, d_l, mint_l, torch.minimum(maxt_l, bt))
        upd = id_v >= 0
        bt = torch.where(upd, t_v, bt)
        bid = torch.where(upd, id_v, bid)
        # Leaves come front to back: a hit at or before this leaf's exit
        # is the nearest.
        done = bt <= t1 * (1.0 + 1e-6) + 1e-7
        if any_hit:
            done = done | (bid >= 0)
        t0 = torch.maximum(t1, t0 + 1e-7)
        go = ~done & (t0 < tend_l)
        fin = ~go
        best_t[live[fin]] = bt[fin]
        best_id[live[fin]] = bid[fin]
        keep = torch.nonzero(go).squeeze(1)
        live = live[keep]
        o_l, d_l, mint_l, maxt_l = o_l[keep], d_l[keep], mint_l[keep], \
            maxt_l[keep]
        t0, tend_l, inv_d = t0[keep], tend_l[keep], inv_d[keep]
        bt, bid = bt[keep], bid[keep]
    return best_id
