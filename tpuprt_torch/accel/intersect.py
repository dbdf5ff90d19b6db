"""Scene-level intersection, hit geometry and ray differentials (port of
tpuprt/accel/intersect.py for triangle scenes with a BVH, and their
ObjectInstance meshes).

A primitive id is a triangle id t in [0, NT) (the port builds no
quadrics), or NT + inst * n_tris + proto_tri for a hit on an instanced
prototype triangle (accel/instances.py).
"""
from __future__ import annotations

import torch

from ..core import vecmath as vm
from ..scene.data import SceneData
from ..shapes import triangle
from . import bvh as bvh_mod
from . import instances as inst_mod

_BIG = 1e30


def _require_bvh(scene: SceneData):
    if scene.accel is None:
        raise NotImplementedError(
            "scenes without a BVH (brute force, grid, kd-tree) are not "
            "ported")


def _has_instances(scene: SceneData) -> bool:
    return scene.instances is not None and scene.instances.count > 0


def intersect_ids(scene: SceneData, o, d, mint, maxt):
    """Nearest-hit (t, prim_id, hit) without differential geometry. The
    instanced geometry is a second aggregate: its hits are min-combined
    with the main one, and an instanced winner's t is recomputed through
    the world-space triangle test."""
    _require_bvh(scene)
    t, pid, hit = bvh_mod.intersect(scene, o, d, mint, maxt)
    if _has_instances(scene):
        inst = scene.instances
        ti, code, hi_ = inst_mod.intersect(inst, o, d, mint, maxt)
        t_id, valid_i = inst_mod.recompute_t(inst, code, o, d, mint, hi_)
        ti = torch.where(hi_ & valid_i, t_id, torch.where(hi_, ti, _BIG))
        t_main = torch.where(hit, t, _BIG)
        choose = hi_ & (ti < t_main)
        t = torch.where(choose, ti, t_main)
        pid = torch.where(choose, scene.triangles.count + code, pid)
        hit = hit | hi_
    return t, pid, hit


def occluded(scene: SceneData, o, d, mint, maxt):
    """Any-hit shadow-ray predicate (Scene::IntersectP)."""
    _require_bvh(scene)
    hit = bvh_mod.intersect(scene, o, d, mint, maxt, any_hit=True)[2]
    if _has_instances(scene):
        hit = hit | inst_mod.intersect(scene.instances, o, d, mint, maxt,
                                       any_hit=True)[2]
    return hit


def hit_geometry(scene: SceneData, prim_id, o, d, t):
    """DifferentialGeometry + material/area-light ids for winning prims.
    prim_id may be -1 (miss); callers mask those lanes by `hit`."""
    tri = scene.triangles
    base = tri.count
    tid = torch.clamp(prim_id, 0, base - 1).long()
    dg = triangle.differential_geometry(tri, tid, o, d, t)
    dg["material"] = tri.material[tid]
    dg["area_light"] = tri.area_light[tid]
    if _has_instances(scene):
        is_inst = torch.clamp(prim_id, min=0) >= base
        dg_i = inst_mod.hit_geometry(
            scene.instances, torch.clamp(prim_id - base, min=0), o, d, t)
        m = is_inst[..., None]
        for k in ("p", "nn", "sn", "ss", "ts", "dpdu", "dpdv", "dndu",
                  "dndv"):
            dg[k] = torch.where(m, dg_i[k], dg[k])
        for k in ("u", "v", "material", "area_light"):
            dg[k] = torch.where(is_inst, dg_i[k], dg[k])
    return dg


def compute_differentials(dg, rx_o, rx_d, ry_o, ry_d, active):
    """DifferentialGeometry::ComputeDifferentials
    (pbrt-v1 core/shape.cpp:52-106): intersect the +x/+y auxiliary
    camera rays with the tangent plane at the hit, then solve the 2x2
    plane-projection system for (dudx, dvdx) / (dudy, dvdy)."""
    nn, p, dpdu, dpdv = dg["nn"], dg["p"], dg["dpdu"], dg["dpdv"]
    dplane = -vm.dot(nn, p)

    def aux(o_a, d_a):
        denom = vm.dot(nn, d_a)
        ok = torch.abs(denom) > 1e-12
        tx = -(vm.dot(nn, o_a) + dplane) / torch.where(ok, denom, 1.0)
        return o_a + tx[..., None] * d_a, ok

    px, okx = aux(rx_o, rx_d)
    py, oky = aux(ry_o, ry_d)
    live = active & okx & oky
    dpdx = torch.where(live[..., None], px - p, 0.0)
    dpdy = torch.where(live[..., None], py - p, 0.0)

    # Projection plane: drop the dominant normal axis (shape.cpp:69-78).
    dom = torch.argmax(torch.abs(nn), dim=-1)
    ax0 = torch.where(dom == 0, 1, 0)
    ax1 = torch.where(dom == 2, 1, 2)

    def comp(v, ax):
        return torch.gather(v, -1, ax[..., None])[..., 0]

    a00 = comp(dpdu, ax0)
    a01 = comp(dpdv, ax0)
    a10 = comp(dpdu, ax1)
    a11 = comp(dpdv, ax1)
    det = a00 * a11 - a01 * a10
    solvable = torch.abs(det) >= 1e-5          # SolveLinearSystem2x2 guard
    inv_det = 1.0 / torch.where(solvable, det, 1.0)

    def solve(b, fallback):
        b0 = comp(b, ax0)
        b1 = comp(b, ax1)
        du = torch.where(solvable, (a11 * b0 - a01 * b1) * inv_det,
                         fallback[0])
        dv = torch.where(solvable, (a00 * b1 - a10 * b0) * inv_det,
                         fallback[1])
        return du, dv

    dudx, dvdx = solve(dpdx, (1.0, 0.0))
    dudy, dvdy = solve(dpdy, (0.0, 1.0))
    out = dict(dg)
    out["dpdx"] = dpdx
    out["dpdy"] = dpdy
    out["dudx"] = torch.where(live, dudx, 0.0)
    out["dvdx"] = torch.where(live, dvdx, 0.0)
    out["dudy"] = torch.where(live, dudy, 0.0)
    out["dvdy"] = torch.where(live, dvdy, 0.0)
    return out
