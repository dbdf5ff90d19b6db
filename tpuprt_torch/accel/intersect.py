"""Scene-level intersection, hit geometry and ray differentials (port of
tpuprt/accel/intersect.py for triangle scenes with a BVH).

A primitive id is a triangle id (the port builds no quadrics).
"""
from __future__ import annotations

import torch

from ..core import vecmath as vm
from ..scene.data import SceneData
from ..shapes import triangle
from . import bvh as bvh_mod


def _require_bvh(scene: SceneData):
    if scene.accel is None:
        raise NotImplementedError(
            "scenes without a BVH (brute force, grid, kd-tree) are not "
            "ported")


def intersect_ids(scene: SceneData, o, d, mint, maxt):
    """Nearest-hit (t, prim_id, hit) without differential geometry."""
    _require_bvh(scene)
    return bvh_mod.intersect(scene, o, d, mint, maxt)


def occluded(scene: SceneData, o, d, mint, maxt):
    """Any-hit shadow-ray predicate (Scene::IntersectP)."""
    _require_bvh(scene)
    return bvh_mod.intersect(scene, o, d, mint, maxt, any_hit=True)[2]


def hit_geometry(scene: SceneData, prim_id, o, d, t):
    """DifferentialGeometry + material/area-light ids for winning prims.
    prim_id may be -1 (miss); callers mask those lanes by `hit`."""
    tri = scene.triangles
    tid = torch.clamp(prim_id, 0, tri.count - 1).long()
    dg = triangle.differential_geometry(tri, tid, o, d, t)
    dg["material"] = tri.material[tid]
    dg["area_light"] = tri.area_light[tid]
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
