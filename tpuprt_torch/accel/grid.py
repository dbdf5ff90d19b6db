"""Uniform-grid DDA traversal (port of tpuprt/accel/grid.py;
pbrt-v1 GridAccel::Intersect, accelerators/grid.cpp:206-310), in plain
torch.

The walk is tpuprt's, step for step: the DDA set up with d clamped away
from 0 at 1e-12 and each axis's next crossing measured from the ray origin;
at each step the ray's voxel's prims are tested in slot order with a strict
`<` (the first-tested prim wins at equal t; no mailbox), then the axis of
the first minimum crossing is stepped. A ray stops when its best hit lies
before the next crossing, when it leaves the grid or when the crossing
passes maxt. The walk runs detached, as tpuprt's does (accel/grid.py:
58-61); the winner's t is then recomputed with maxt 1e30 from the rays and
the live tables, which carries the gradient. The grid has no any-hit mode:
tpuprt's occluded runs this nearest walk.

Two things keep the torch version short of tpuprt's per-lane loops, with
each ray's tests and their order unchanged: only the live rays are carried
from step to step (compacted), and one step tests every (ray, slot) pair of
the live rays at once, reduced per ray with the slot-order tie rule
(`nearest_in_ranges`).
"""
from __future__ import annotations

import torch

from ..core import vecmath as vm
from ..scene.data import GridAccel, SceneData
from ..shapes import quadrics, triangle

_BIG = 1e30


def candidate_hits(scene: SceneData, pid, o, d, mint, maxt, active):
    """Each lane against its single candidate prim pid (quadric q -> q,
    triangle t -> NQ + t): (t, 1e30 where invalid, valid)."""
    nq = scene.quadrics.count if scene.quadrics is not None else 0
    nt = scene.triangles.count
    t_out = torch.full(pid.shape, _BIG, dtype=torch.float32, device=o.device)
    valid = torch.zeros(pid.shape, dtype=torch.bool, device=o.device)
    if nq:
        qid = torch.clamp(pid, 0, nq - 1).long()
        tq, vq = quadrics.intersect_gathered(scene.quadrics, qid, o, d, mint,
                                             maxt)
        is_q = pid < nq
        t_out = torch.where(is_q, tq, t_out)
        valid = torch.where(is_q, vq, valid)
    if nt:
        tid = torch.clamp(pid - nq, 0, nt - 1).long()
        p0, p1, p2 = triangle.gather_verts(scene.triangles, tid)
        tt, _, _, vt = triangle.intersect_pairs(p0, p1, p2, o, d, mint, maxt)
        is_t = pid >= nq
        t_out = torch.where(is_t, tt, t_out)
        valid = torch.where(is_t, vt, valid)
    valid = valid & active
    return torch.where(valid, t_out, _BIG), valid


def nearest_in_ranges(scene: SceneData, prim_ids, start, count, o, d, mint,
                      maxt):
    """Each lane's nearest hit among prim_ids[start : start + count] with
    t in (mint, maxt), as a loop over the slots in order with a strict `<`
    gives it (the first slot wins at equal t): (t f32[N], 1e30 where none,
    pid i32[N], -1 where none). All (lane, slot) pairs are tested in one
    batch."""
    n = start.shape[0]
    dev = start.device
    t_best = torch.full((n,), _BIG, dtype=torch.float32, device=dev)
    pid_best = torch.full((n,), -1, dtype=torch.int32, device=dev)
    cnt = count.long()
    total = int(cnt.sum())
    if total == 0:
        return t_best, pid_best
    lane = torch.repeat_interleave(torch.arange(n, device=dev), cnt,
                                   output_size=total)
    j = torch.arange(total, device=dev)
    first_pair = torch.cumsum(cnt, 0) - cnt
    slot = start.long()[lane] + (j - first_pair[lane])
    pid = prim_ids[slot]
    t, valid = candidate_hits(scene, pid, o[lane], d[lane], mint[lane],
                          maxt[lane], torch.ones(total, dtype=torch.bool,
                                                 device=dev))
    t_best = t_best.scatter_reduce(0, lane, t, "amin")
    tie = valid & (t == t_best[lane])
    first = torch.full((n,), total, dtype=torch.long, device=dev)
    first = first.scatter_reduce(0, lane, torch.where(tie, j, total), "amin")
    found = first < total
    pid_best = torch.where(found, pid[torch.clamp(first, max=total - 1)],
                           pid_best)
    return torch.where(found, t_best, _BIG), pid_best


def recompute_t(scene: SceneData, best_id, o, d, mint):
    """The winner's t recomputed with maxt 1e30 (tpuprt/accel/grid.py:
    144-149): (t, 1e30 where no hit, hit)."""
    hit = best_id >= 0
    t, valid = candidate_hits(scene, torch.clamp(best_id, min=0), o, d, mint,
                          torch.full_like(mint, _BIG), hit)
    return torch.where(hit & valid, t, _BIG), best_id, hit


def intersect(scene: SceneData, o, d, mint, maxt):
    """Nearest hit by the grid DDA: (t[N], prim_id[N], hit[N])."""
    return recompute_t(scene, walk(scene, o, d, mint, maxt), o, d, mint)


@torch.no_grad()
def walk(scene: SceneData, o, d, mint, maxt):
    """The DDA walk, detached: each ray's winning prim id, -1 where none."""
    grid: GridAccel = scene.accel
    nx, ny, nz = grid.nvoxels
    dev = o.device
    res = torch.tensor([nx, ny, nz], dtype=torch.int32, device=dev)
    lo, hi = grid.bounds_lo, grid.bounds_hi
    n = o.shape[0]

    # Clip the ray to the grid's bounds (grid.cpp:211-218).
    inside0 = torch.all((o >= lo) & (o <= hi), -1)
    hit_b, t0, _ = vm.bbox_intersect_p(lo, hi, o, d, mint, maxt)
    ray_t = torch.where(inside0, mint, t0)
    live = torch.nonzero(inside0 | hit_b).squeeze(1)

    # Per-axis DDA set-up (grid.cpp:219-238), for the rays that enter.
    o_l, d_l = o[live], d[live]
    mint_l, maxt_l = mint[live], maxt[live]
    grid_isect = o_l + ray_t[live][..., None] * d_l
    pos_f = (grid_isect - lo) * grid.inv_width
    pos = torch.minimum(torch.clamp(pos_f.to(torch.int32), min=0), res - 1)
    d_safe = torch.where(torch.abs(d_l) < 1e-12,
                         torch.where(d_l < 0, -1e-12, 1e-12), d_l)
    inv_d = 1.0 / d_safe
    pos_dir = d_l >= 0
    step = torch.where(pos_dir, 1, -1).to(torch.int32)
    next_vox = torch.where(pos_dir, pos + 1, pos)
    # The next crossing's ray parameter, measured from the origin
    # (grid.cpp:228-237 adds (boundary - gridIntersect)/d to rayT).
    nc = (lo + next_vox.to(torch.float32) * grid.width - o_l) * inv_d
    delta_t = torch.abs(grid.width * inv_d)
    out = torch.where(pos_dir, res, -1).to(torch.int32)
    bt = torch.full(live.shape, _BIG, dtype=torch.float32, device=dev)
    bid = torch.full(live.shape, -1, dtype=torch.int32, device=dev)
    best_t = torch.full((n,), _BIG, dtype=torch.float32, device=dev)
    best_id = torch.full((n,), -1, dtype=torch.int32, device=dev)

    while live.numel():
        vox = pos[:, 0] + pos[:, 1] * nx + pos[:, 2] * (nx * ny)
        vox = torch.clamp(vox, 0, nx * ny * nz - 1).long()
        start = grid.cell_start[vox]
        t_v, id_v = nearest_in_ranges(
            scene, grid.prim_ids, start, grid.cell_start[vox + 1] - start,
            o_l, d_l, mint_l, torch.minimum(maxt_l, bt))
        upd = id_v >= 0
        bt = torch.where(upd, t_v, bt)
        bid = torch.where(upd, id_v, bid)
        # Step the axis of the first minimum crossing (grid.cpp:274-284).
        axis = torch.argmin(nc, dim=-1)
        t_next = nc.amin(-1)
        onehot = torch.nn.functional.one_hot(axis, 3).to(torch.int32)
        new_pos = pos + onehot * step
        ax = axis[:, None]
        leaving = (torch.gather(new_pos, 1, ax) ==
                   torch.gather(out, 1, ax))[:, 0]
        # Done on a hit before the next crossing, on leaving the grid, or
        # past maxt.
        go = ~(bt < t_next) & ~leaving & ~(t_next > maxt_l)
        nc = nc + onehot.to(torch.float32) * delta_t
        done = ~go
        best_t[live[done]] = bt[done]
        best_id[live[done]] = bid[done]
        keep = torch.nonzero(go).squeeze(1)
        live = live[keep]
        pos, nc, bt, bid = new_pos[keep], nc[keep], bt[keep], bid[keep]
        o_l, d_l, mint_l, maxt_l = o_l[keep], d_l[keep], mint_l[keep], \
            maxt_l[keep]
        step, delta_t, out = step[keep], delta_t[keep], out[keep]
    return best_id
