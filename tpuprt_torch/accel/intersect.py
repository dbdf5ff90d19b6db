"""Scene-level intersection, hit geometry and ray differentials (port of
tpuprt/accel/intersect.py: the BVH, the uniform grid, the kd-tree and the
brute-force aggregate over quadrics and triangles, plus ObjectInstance
meshes).

A primitive id is, as in the reference, a quadric id q in [0, NQ), a
triangle id t as NQ + t, or NQ + NT + inst * n_tris + proto_tri for a hit
on an instanced prototype triangle (accel/instances.py).

Without an accelerator (scene.accel None) every ray is tested against
every primitive: the quadrics by plain torch all pairs, the triangles by
the dense kernel (ops/mt_cuda.py), whatever their count, in its any-hit
mode for shadow rays. tpuprt's BRUTE_UNROLL_MAX, PALLAS_MIN_TRIS and
force_pallas choose among TPU formulations with the same results; the port
has one.
"""
from __future__ import annotations

import torch

from ..core import transform as tf
from ..core import vecmath as vm
from ..ops import mt_cuda
from ..scene.data import (QUADRIC_CONE, QUADRIC_CYLINDER, QUADRIC_DISK,
                          QUADRIC_HYPERBOLOID, QUADRIC_PARABOLOID, GridAccel,
                          KdTreeAccel, SceneData)
from ..shapes import quadrics, triangle
from ..utils.stats import span
from . import bvh as bvh_mod
from . import grid as grid_mod
from . import instances as inst_mod
from . import kdtree as kd_mod

_BIG = 1e30


def _has_instances(scene: SceneData) -> bool:
    return scene.instances is not None and scene.instances.count > 0


def _nq(scene: SceneData) -> int:
    return scene.quadrics.count if scene.quadrics is not None else 0


def _brute_force(scene: SceneData, o, d, mint, maxt, any_hit=False):
    """Nearest hit over all primitives (tpuprt/accel/intersect.py:89-128,
    its non-unrolled form): the quadrics first, then the triangles replace
    them only where strictly nearer, so a quadric wins a tie; among
    triangles the lowest index wins. Returns (t, prim_id, hit). With
    any_hit the triangle kernel stops at each ray's lowest-index hit: hit is
    the same mask, t and prim_id need not be the nearest."""
    n = o.shape[0]
    nq, nt = _nq(scene), scene.triangles.count
    best_t = torch.full((n,), _BIG, dtype=torch.float32, device=o.device)
    best_id = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    if nq:
        tq, _ = quadrics.intersect(scene.quadrics, o, d, mint, maxt)
        qt, qi = tq.min(dim=1)
        upd = qt < best_t
        best_t = torch.where(upd, qt, best_t)
        best_id = torch.where(upd, qi.to(torch.int32), best_id)
    if nt:
        # The kernel finds the winners on the packed table (render()'s, or
        # one packed here outside autograd); t is recomputed from the
        # triangle table's own vertices, so a loss keeps their gradient
        # whether or not the scene holds a packed table.
        tris = scene.tris_packed
        if tris is None:
            with torch.no_grad():
                tris = mt_cuda.pack_table(scene.triangles)
        ids = mt_cuda.winners(tris, (scene.world_bound_lo,
                                     scene.world_bound_hi), o, d, mint, maxt,
                              any_hit=any_hit)
        p0, p1, p2 = triangle.gather_verts(scene.triangles,
                                           torch.clamp(ids, min=0).long())
        t_tri, ti, _ = mt_cuda.recompute(ids, p0, p1 - p0, p2 - p0, o, d,
                                         mint, maxt)
        upd = t_tri < best_t
        best_t = torch.where(upd, t_tri, best_t)
        best_id = torch.where(upd, ti + nq, best_id)
    return best_t, best_id, best_id >= 0


def _main_intersect(scene: SceneData, o, d, mint, maxt, any_hit=False):
    """The main aggregate by its accelerator (tpuprt/accel/intersect.py:
    135-193). The grid has no any-hit mode: an any-hit caller gets its
    nearest walk, as tpuprt's occluded does."""
    accel = scene.accel
    if accel is None:
        # The quadrics resolve their nearest hit, the triangle kernel stops
        # at a first hit for an any-hit caller, who reads only the mask
        # (tpuprt/accel/intersect.py:187-188 reads tpuprt's nearest mask,
        # the same booleans).
        return _brute_force(scene, o, d, mint, maxt, any_hit=any_hit)
    if isinstance(accel, GridAccel):
        return grid_mod.intersect(scene, o, d, mint, maxt)
    if isinstance(accel, KdTreeAccel):
        return kd_mod.intersect(scene, o, d, mint, maxt, any_hit=any_hit)
    return bvh_mod.intersect(scene, o, d, mint, maxt, any_hit=any_hit)


def intersect_ids(scene: SceneData, o, d, mint, maxt):
    """Nearest-hit (t, prim_id, hit) without differential geometry. The
    instanced geometry is a second aggregate: its hits are min-combined
    with the main one, and an instanced winner's t is recomputed through
    the world-space triangle test. The span "intersect"."""
    with span("intersect"):
        t, pid, hit = _main_intersect(scene, o, d, mint, maxt)
        if _has_instances(scene):
            inst = scene.instances
            ti, code, hi_ = inst_mod.intersect(inst, o, d, mint, maxt)
            t_id, valid_i = inst_mod.recompute_t(inst, code, o, d, mint, hi_)
            ti = torch.where(hi_ & valid_i, t_id, torch.where(hi_, ti, _BIG))
            t_main = torch.where(hit, t, _BIG)
            choose = hi_ & (ti < t_main)
            t = torch.where(choose, ti, t_main)
            base = _nq(scene) + scene.triangles.count
            pid = torch.where(choose, base + code, pid)
            hit = hit | hi_
        return t, pid, hit


def occluded(scene: SceneData, o, d, mint, maxt):
    """Any-hit shadow-ray predicate (Scene::IntersectP). The span
    "shadow"."""
    with span("shadow"):
        hit = _main_intersect(scene, o, d, mint, maxt, any_hit=True)[2]
        if _has_instances(scene):
            hit = hit | inst_mod.intersect(scene.instances, o, d, mint, maxt,
                                           any_hit=True)[2]
        return hit


def hit_geometry(scene: SceneData, prim_id, o, d, t):
    """DifferentialGeometry + material/area-light ids for winning prims
    (tpuprt/accel/intersect.py:197-265). prim_id may be -1 (miss);
    callers mask those lanes by `hit`."""
    nq, nt = _nq(scene), scene.triangles.count
    base = nq + nt
    pid = torch.clamp(prim_id, min=0)
    if nt:
        tid = torch.clamp(pid - nq, 0, nt - 1).long()
        dg = triangle.differential_geometry(scene.triangles, tid, o, d, t)
        dg["material"] = scene.triangles.material[tid]
        dg["area_light"] = scene.triangles.area_light[tid]
    if nq:
        q = scene.quadrics
        qid = torch.clamp(pid, 0, nq - 1).long()
        dgq = quadrics.differential_geometry(q, qid, o, d, t)
        # A quadric's shading frame is its geometric one.
        dgq["sn"] = dgq["nn"]
        dgq["ss"] = vm.normalize(dgq["dpdu"])
        dgq["ts"] = vm.normalize(vm.cross(dgq["nn"], dgq["ss"]))
        dgq["material"] = q.material[qid]
        dgq["area_light"] = q.area_light[qid]
        if nt:
            is_tri = pid >= nq
            dg = {k: torch.where(is_tri if v.dim() == 1 else
                                 is_tri[..., None], v, dgq[k])
                  for k, v in dg.items()}
        else:
            dg = dgq
    if _has_instances(scene):
        is_inst = pid >= base
        dg_i = inst_mod.hit_geometry(
            scene.instances, torch.clamp(prim_id - base, min=0), o, d, t)
        m = is_inst[..., None]
        for k in ("p", "nn", "sn", "ss", "ts", "dpdu", "dpdv", "dndu",
                  "dndv"):
            dg[k] = torch.where(m, dg_i[k], dg[k])
        for k in ("u", "v", "material", "area_light"):
            dg[k] = torch.where(is_inst, dg_i[k], dg[k])
    return dg


def hit_geometry_light(scene: SceneData, prim_id, o, d, t):
    """The hit record a light-identification ray needs: p, nn (geometric,
    flip applied), area_light, material (tpuprt/accel/intersect.py:331-428).
    A quadric's normal comes from its implicit surface's gradient at the
    object-space hit, with no trigonometry."""
    nq, nt = _nq(scene), scene.triangles.count
    base = nq + nt
    pid = torch.clamp(prim_id, min=0)
    p = o + t[..., None] * d
    if nt:
        tri = scene.triangles
        tid = torch.clamp(pid - nq, 0, nt - 1).long()
        p0, p1, p2 = triangle.gather_verts(tri, tid)
        nn = vm.normalize(vm.cross(p1 - p0, p2 - p0)) * \
            tri.flip_normal[tid][..., None]
        area_light = tri.area_light[tid]
        material = tri.material[tid]
    if nq:
        q = scene.quadrics
        qid = torch.clamp(pid, 0, nq - 1).long()
        w2o_c = tf.row_components(q.w2o, qid)
        kind = q.kind[qid]
        prm = q.params[qid]
        ph = tf.rows_apply_point(w2o_c, p)
        x, y, z = ph[..., 0], ph[..., 1], ph[..., 2]
        zeros, ones = torch.zeros_like(x), torch.ones_like(x)
        kp = q.kinds_present or quadrics.ALL_QUADRIC_KINDS
        grad = torch.stack([x, y, z], -1)                 # sphere
        if QUADRIC_CYLINDER in kp:
            grad = torch.where((kind == QUADRIC_CYLINDER)[..., None],
                               torch.stack([x, y, zeros], -1), grad)
        if QUADRIC_DISK in kp:
            grad = torch.where((kind == QUADRIC_DISK)[..., None],
                               torch.stack([zeros, zeros, ones], -1), grad)
        if QUADRIC_CONE in kp:
            r_co, h_co = prm[..., 0], prm[..., 1]
            k_co = (r_co / torch.where(h_co == 0, 1.0, h_co)) ** 2
            grad = torch.where((kind == QUADRIC_CONE)[..., None],
                               torch.stack([x, y, -k_co * (z - h_co)], -1),
                               grad)
        if QUADRIC_PARABOLOID in kp:
            r_pa, zmax_pa = prm[..., 0], prm[..., 2]
            k_pa = zmax_pa / torch.where(r_pa == 0, 1.0, r_pa * r_pa)
            grad = torch.where((kind == QUADRIC_PARABOLOID)[..., None],
                               torch.stack([2 * k_pa * x, 2 * k_pa * y,
                                            -ones], -1), grad)
        if QUADRIC_HYPERBOLOID in kp:
            a_h, c_h = prm[..., 0], prm[..., 1]
            grad = torch.where((kind == QUADRIC_HYPERBOLOID)[..., None],
                               torch.stack([a_h * x, a_h * y, -c_h * z], -1),
                               grad)
        nnq = vm.normalize(tf.rows_apply_normal(w2o_c, grad)) * \
            q.flip_normal[qid][..., None]
        if nt:
            is_tri = pid >= nq
            nn = torch.where(is_tri[..., None], nn, nnq)
            area_light = torch.where(is_tri, area_light, q.area_light[qid])
            material = torch.where(is_tri, material, q.material[qid])
        else:
            nn, area_light, material = nnq, q.area_light[qid], \
                q.material[qid]
    if _has_instances(scene):
        # An instanced hit's light: its instance's, on an emissive
        # prototype.
        is_inst = pid >= base
        dg_i = inst_mod.hit_geometry(
            scene.instances, torch.clamp(prim_id - base, min=0), o, d, t)
        nn = torch.where(is_inst[..., None], dg_i["nn"], nn)
        area_light = torch.where(is_inst, dg_i["area_light"], area_light)
        material = torch.where(is_inst, dg_i["material"], material)
    return dict(p=p, nn=nn, area_light=area_light, material=material)


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
