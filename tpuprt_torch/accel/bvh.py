"""Scene-level BVH intersection (port of tpuprt/accel/bvh.py).

A triangle-only BVH goes to the traversal kernels (ops/bvh_cuda.py), which
find each ray's winning triangle. A BVH that holds quadrics is walked by
its skip links in plain torch, as tpuprt walks it in plain JAX
(accel/bvh.py:64-149; its Pallas walks are triangle-only too): each leaf
slot through the generic prim test (grid.candidate_hits). Either way the
winner's t is then recomputed through the prim test from the rays' own
o/d/mint, as the reference does (accel/bvh.py:84-88, 140-149), so t
follows the reference's arithmetic and a later gradient pass can reuse it.
"""
from __future__ import annotations

import torch

from ..ops import bvh_cuda
from ..scene.data import SceneData
from .grid import nearest_in_ranges, recompute_t

_BIG = 1e30


def intersect(scene: SceneData, o, d, mint, maxt, any_hit: bool = False):
    """Nearest hit (t, prim_id, hit); any_hit stops at the first hit found
    (IntersectP). The kernels' any-hit t is returned unrecomputed."""
    if scene.accel.n_quadrics:
        return recompute_t(scene, walk_skip_links(scene, o, d, mint, maxt,
                                                  any_hit), o, d, mint)
    t_raw, best_id, hit = bvh_cuda.intersect(scene.accel, o, d, mint, maxt,
                                             any_hit=any_hit)
    if any_hit:
        return t_raw, best_id, hit
    return recompute_t(scene, best_id, o, d, mint)


@torch.no_grad()
def walk_skip_links(scene: SceneData, o, d, mint, maxt,
                    any_hit: bool = False):
    """tpuprt's walk of the rows by their skip links (bvh.py:95-137): each
    ray visits its node, tests the box against [mint, min(maxt, best t) x
    (1 + 1e-6)], at a hit leaf tests every slot with the generic prim test
    (a slot wins with a strictly smaller t, the earlier slot at a tie),
    goes to node + 1 below a hit interior node and to the skip link
    otherwise, until it passes the last node, or, with any_hit, finds a
    hit. Only the live rays are carried from step to step; a leaf's
    (ray, slot) pairs are tested in one batch (grid.nearest_in_ranges).
    Returns the winning prim id per ray, -1 where none."""
    bvh = scene.accel
    nn = bvh.n_nodes
    dev = o.device
    box = bvh.nodes[:nn, 0:8].contiguous()
    slots = bvh.nodes[:nn, 80:80 + bvh.leaf_k].to(torch.int32).reshape(-1)
    d_safe = torch.where(torch.abs(d) < 1e-12,
                         torch.where(d < 0, -1e-12, 1e-12), d)
    inv_d = 1.0 / d_safe
    best_id = torch.full(o.shape[:1], -1, dtype=torch.int32, device=dev)
    live = torch.arange(o.shape[0], device=dev)
    node = torch.zeros_like(live)
    bt = torch.full(live.shape, _BIG, dtype=torch.float32, device=dev)
    bid = best_id.clone()
    o_l, d_l, inv_l, mint_l, maxt_l = o, d, inv_d, mint, maxt
    while live.numel():
        row = box[node]
        nprims = row[:, 7].to(torch.int64)
        tlo = (row[:, 0:3] - o_l) * inv_l
        thi = (row[:, 3:6] - o_l) * inv_l
        t0 = torch.maximum(torch.minimum(tlo, thi).amax(-1), mint_l)
        t1 = torch.minimum(torch.maximum(tlo, thi).amin(-1),
                           torch.minimum(maxt_l, bt) * (1.0 + 1e-6))
        hit_box = t0 <= t1
        leaf = hit_box & (nprims > 0)
        t_v, id_v = nearest_in_ranges(
            scene, slots, node * bvh.leaf_k, torch.where(leaf, nprims, 0),
            o_l, d_l, mint_l, torch.minimum(maxt_l, bt))
        upd = id_v >= 0
        bt = torch.where(upd, t_v, bt)
        bid = torch.where(upd, id_v, bid)
        node = torch.where(hit_box & (nprims == 0), node + 1,
                           row[:, 6].to(torch.int64))
        done = node >= nn
        if any_hit:
            done = done | (bid >= 0)
        best_id[live[done]] = bid[done]
        keep = torch.nonzero(~done).squeeze(1)
        live, node, bt, bid = live[keep], node[keep], bt[keep], bid[keep]
        o_l, d_l, inv_l = o_l[keep], d_l[keep], inv_l[keep]
        mint_l, maxt_l = mint_l[keep], maxt_l[keep]
    return best_id
