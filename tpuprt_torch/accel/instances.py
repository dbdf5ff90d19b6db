"""Ray-transform instancing: build, intersection and shading geometry (port
of tpuprt/accel/instances.py; pbrt-v1's InstancePrimitive,
core/primitive.cpp:66-85).

Prototype triangle meshes are stored once in object space, each with its
own BLAS (accel/bvh_build.build_rows); instances carry only 4x4 transforms.
Traversal (ops/bvh_cuda.traverse_instanced) moves each ray into the
instance's object space with its direction unnormalized, so t stays the
world t and instanced hits compare directly with the main aggregate's.

A top-level BVH over the traversal entries' world boxes (build_top) lets
the kernel visit only the entries near a ray; the entry tables keep their
order, which defines the result (the earliest entry wins at equal t).

Global prim id of an instanced hit: NQ + NT + inst * n_tris + proto_tri,
so integrator signatures are unchanged.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import transform as tf, vecmath as vm
from ..ops import bvh_cuda
from ..scene.data import InstanceTable
from ..shapes import triangle as trimod
from .bvh_build import build_rows, pad_rows

_BIG = 1e30
BLOCK_CAP = 2048
TOP_COLS = 16


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def build_top(entry_bbox):
    """Top-level BVH over E entry boxes f32[E, >=6] (lo xyz, hi xyz): the
    native builder's tree with the boxes as AABB-only prims, in skip-link
    rows f32[NN, TOP_COLS] = [lo xyz, hi xyz, skip, nprims, 8 entry ids
    (leaves; -1 in unused slots and in interior rows)], as numpy."""
    box = np.asarray(entry_bbox, np.float32)
    rows, prim_ids, nn = build_rows(box[:, 0:3], box[:, 3:6], len(box),
                                    np.zeros((0, 9), np.float32))
    top = np.empty((nn, TOP_COLS), np.float32)
    top[:, 0:8] = rows[:, 0:8]
    top[:, 8:16] = prim_ids
    return top


def build_instances(protos, instances) -> InstanceTable:
    """protos: list of dicts with keys verts f32[V,3], idx i32[T,3],
    uv f32[V,2]|None, normals f32[V,3]|None, material (global material id),
    flip float. instances: list of (proto_id, o2w 4x4). CPU tensors."""
    v_ofs = 0
    t_ofs = 0
    all_v, all_i, all_uv, all_n, all_hn, all_m, all_f = \
        [], [], [], [], [], [], []
    node_blocks = []
    proto_blocks = []       # per proto: (block_ofs, n_blocks, nn)
    proto_block_bbox = []   # per proto: [n_blocks, 6] object-space bbox
    blk_ofs = 0
    for pr in protos:
        verts = np.asarray(pr["verts"], np.float32)
        idx = np.asarray(pr["idx"], np.int32)
        T = len(idx)
        tri9 = np.concatenate([verts[idx[:, 0]], verts[idx[:, 1]],
                               verts[idx[:, 2]]], axis=1).astype(np.float32)
        lo = tri9.reshape(T, 3, 3).min(1)
        hi = tri9.reshape(T, 3, 3).max(1)
        rows, _pids, nn = build_rows(lo, hi, 0, tri9)
        # Leaf prim ids -> global proto-tri ids (cols 80..87; only leaf
        # rows read them, guarded by j < nprims).
        rows = rows.copy()
        rows[:, 80:88] += float(t_ofs)
        nb = -(-nn // BLOCK_CAP)
        padded = np.zeros((nb * BLOCK_CAP, rows.shape[1]), np.float32)
        padded[:nn] = rows
        node_blocks.append(padded)
        spans = [(b * BLOCK_CAP, min(nn, (b + 1) * BLOCK_CAP))
                 for b in range(nb)]
        bbox = np.stack([
            np.stack([rows[s:e, 0:3].min(0) for s, e in spans]),
            np.stack([rows[s:e, 3:6].max(0) for s, e in spans]),
        ], axis=1).reshape(nb, 6)
        proto_blocks.append((blk_ofs, nb, nn))
        proto_block_bbox.append(bbox)
        blk_ofs += nb

        all_v.append(verts)
        all_i.append(idx + v_ofs)
        uv = pr.get("uv")
        all_uv.append(np.asarray(uv, np.float32) if uv is not None
                      else np.zeros((len(verts), 2), np.float32))
        nrm = pr.get("normals")
        all_n.append(np.asarray(nrm, np.float32) if nrm is not None
                     else np.zeros((len(verts), 3), np.float32))
        all_hn.append(np.full(T, nrm is not None, bool))
        all_m.append(np.asarray(pr["material"], np.int32) *
                     np.ones(T, np.int32))
        all_f.append(np.full(T, float(pr.get("flip", 1.0)), np.float32))
        v_ofs += len(verts)
        t_ofs += T

    if t_ofs >= (1 << 24):
        raise ValueError("prototype triangles exceed the f32-id row format")
    nodes = pad_rows(np.concatenate(node_blocks))

    # Entries: (instance, proto block) pairs with world-space bboxes.
    e_blk, e_inst, e_start, e_stop, e_bbox = [], [], [], [], []
    o2w_list, w2o_list = [], []
    lo_all = np.full(3, 1e30, np.float32)
    hi_all = np.full(3, -1e30, np.float32)
    for ii, (pid, o2w) in enumerate(instances):
        o2w = np.asarray(o2w, np.float32)
        o2w_list.append(o2w)
        w2o_list.append(np.linalg.inv(o2w).astype(np.float32))
        ofs, nb, nn = proto_blocks[pid]
        bbox = proto_block_bbox[pid]
        for b in range(nb):
            blo, bhi = bbox[b, 0:3], bbox[b, 3:6]
            corners = np.array([[x, y, z] for x in (blo[0], bhi[0])
                                for y in (blo[1], bhi[1])
                                for z in (blo[2], bhi[2])], np.float32)
            wc = corners @ o2w[:3, :3].T + o2w[:3, 3]
            wlo, whi = wc.min(0), wc.max(0)
            pad = 1e-5 * np.abs(wc).max() + 1e-6
            e_blk.append(ofs + b)
            e_inst.append(ii)
            e_start.append(b * BLOCK_CAP)
            e_stop.append(min(nn, (b + 1) * BLOCK_CAP))
            e_bbox.append(np.concatenate([wlo - pad, whi + pad,
                                          np.zeros(2, np.float32)]))
            lo_all = np.minimum(lo_all, wlo)
            hi_all = np.maximum(hi_all, whi)

    signs = np.asarray([1.0 if np.linalg.det(m[:3, :3]) >= 0 else -1.0
                        for m in o2w_list], np.float32)
    i32 = lambda v: _t(np.asarray(v, np.int32))
    return InstanceTable(
        inst_sign=_t(signs),
        verts=_t(np.concatenate(all_v)), idx=_t(np.concatenate(all_i)),
        uv=_t(np.concatenate(all_uv)), normals=_t(np.concatenate(all_n)),
        has_normals=_t(np.concatenate(all_hn)),
        material=_t(np.concatenate(all_m)),
        flip_normal=_t(np.concatenate(all_f)),
        nodes=_t(nodes),
        inst_o2w=_t(np.stack(o2w_list)), inst_w2o=_t(np.stack(w2o_list)),
        entry_block=i32(e_blk), entry_inst=i32(e_inst),
        entry_start=i32(e_start), entry_stop=i32(e_stop),
        entry_bbox=_t(np.stack(e_bbox)), top_nodes=_t(build_top(e_bbox)),
        bounds_lo=_t(lo_all), bounds_hi=_t(hi_all),
        tri_emissive=_t(np.zeros(t_ofs, bool)),
        inst_area_light=i32(np.full(len(instances), -1)),
        count=len(instances), n_tris=t_ofs, n_entries=len(e_blk),
        block_cap=BLOCK_CAP, leaf_k=8)


def intersect(inst: InstanceTable, o, d, mint, maxt, any_hit=False):
    """(t, code, hit): code = inst * n_tris + proto_tri for hits, -1 else.
    The rays go to the walk in lane order: sorting them (bvh_cuda.sort_key
    over the instances' bounds) did not make the walk faster on the card
    and costs about as much as the walk (PERF.md). The walk carries no
    gradient (tpuprt/accel/instances.py:148-165); callers recompute the
    winner's t through recompute_t."""
    rays = torch.cat([o.T, d.T, mint[None], maxt[None]], dim=0).contiguous()
    w2o12 = inst.inst_w2o[:, :3, :].reshape(inst.count, 12).contiguous()
    t, tri, ii = bvh_cuda.traverse_instanced(
        inst.nodes, inst.entry_block, inst.entry_inst, inst.entry_start,
        inst.entry_stop, inst.entry_bbox, w2o12, rays, cap=inst.block_cap,
        top=inst.top_nodes, any_hit=any_hit)
    hit = (tri >= 0) & (ii >= 0)
    code = torch.where(hit, ii * inst.n_tris + tri, -1)
    return torch.where(hit, t, _BIG), code, hit


def _world_verts(inst: InstanceTable, code):
    """The hit triangle's vertices moved to world space. Returns (inst_id,
    tri_id, o2w rows, w2o rows, p0, p1, p2, i3)."""
    code = torch.clamp(code, min=0).long()
    ii = code // inst.n_tris
    tid = code % inst.n_tris
    i3 = inst.idx[tid].long()
    o2w_c = tf.row_components(inst.inst_o2w, ii)
    w2o_c = tf.row_components(inst.inst_w2o, ii)
    p0 = tf.rows_apply_point(o2w_c, inst.verts[i3[..., 0]])
    p1 = tf.rows_apply_point(o2w_c, inst.verts[i3[..., 1]])
    p2 = tf.rows_apply_point(o2w_c, inst.verts[i3[..., 2]])
    return ii, tid, o2w_c, w2o_c, p0, p1, p2, i3


def recompute_t(inst: InstanceTable, code, o, d, mint, hit):
    """t of the winning instanced triangle through the world-space triangle
    test, and whether it is valid there (accel/bvh.py's estimator)."""
    _, _, _, _, p0, p1, p2, _ = _world_verts(inst, code)
    t, _, _, valid = trimod.intersect_pairs(
        p0, p1, p2, o, d, mint, torch.full_like(mint, _BIG))
    return t, valid & hit


def hit_geometry(inst: InstanceTable, code, o, d, t):
    """DifferentialGeometry of instanced hits: the prototype triangle moved
    to world space (as triangle.differential_geometry; normals by the
    inverse transpose)."""
    ii, tid, o2w_c, w2o_c, p0, p1, p2, i3 = _world_verts(inst, code)
    _, b1, b2, _ = trimod.intersect_pairs(
        p0, p1, p2, o, d, torch.full_like(t, -_BIG), torch.full_like(t, _BIG))
    b0 = 1.0 - b1 - b2
    uv0 = inst.uv[i3[..., 0]]
    uv1 = inst.uv[i3[..., 1]]
    uv2 = inst.uv[i3[..., 2]]
    p = o + t[..., None] * d
    u = b0 * uv0[..., 0] + b1 * uv1[..., 0] + b2 * uv2[..., 0]
    v = b0 * uv0[..., 1] + b1 * uv1[..., 1] + b2 * uv2[..., 1]

    du1 = uv0[..., 0] - uv2[..., 0]
    du2 = uv1[..., 0] - uv2[..., 0]
    dv1 = uv0[..., 1] - uv2[..., 1]
    dv2 = uv1[..., 1] - uv2[..., 1]
    dp1 = p0 - p2
    dp2 = p1 - p2
    det = du1 * dv2 - dv1 * du2
    degen = torch.abs(det) < 1e-12
    invdet = 1.0 / torch.where(degen, 1.0, det)
    dpdu = (dv2[..., None] * dp1 - dv1[..., None] * dp2) * invdet[..., None]
    dpdv = (-du2[..., None] * dp1 + du1[..., None] * dp2) * invdet[..., None]
    ng_raw = vm.cross(p1 - p0, p2 - p0)
    _, fu, fv = vm.coordinate_system(vm.normalize(ng_raw))
    dpdu = torch.where(degen[..., None], fu, dpdu)
    dpdv = torch.where(degen[..., None], fv, dpdv)

    # A mirror instance swaps handedness: fold the per-instance sign in so
    # orientation matches the duplicated mesh's flip.
    flip = inst.flip_normal[tid] * inst.inst_sign[ii]
    nn = vm.normalize(vm.cross(dpdu, dpdv)) * flip[..., None]

    has_n = inst.has_normals[tid]
    n0 = tf.rows_apply_normal(w2o_c, inst.normals[i3[..., 0]])
    n1 = tf.rows_apply_normal(w2o_c, inst.normals[i3[..., 1]])
    n2 = tf.rows_apply_normal(w2o_c, inst.normals[i3[..., 2]])
    ns = vm.normalize(b0[..., None] * n0 + b1[..., None] * n1 +
                      b2[..., None] * n2) * flip[..., None]
    ns = torch.where(has_n[..., None], ns, nn)
    ss = vm.normalize(dpdu)
    ts = vm.normalize(vm.cross(ns, ss))
    ss = vm.cross(ts, ns)
    # dndu/dndv of the world-space shading normals from the uv deltas
    # (trianglemesh.cpp:104-123; pbrt-v1 transforms the prototype's dn by
    # the instance transform, core/primitive.cpp:75-85, which equals
    # differencing the transformed normals).
    dn1 = n0 - n2
    dn2 = n1 - n2
    dndu = (dv2[..., None] * dn1 - dv1[..., None] * dn2) * invdet[..., None]
    dndv = (-du2[..., None] * dn1 + du1[..., None] * dn2) * invdet[..., None]
    bad = (degen | ~has_n)[..., None]
    dndu = torch.where(bad, 0.0, dndu)
    dndv = torch.where(bad, 0.0, dndv)
    # An emissive prototype's triangle is its instance's own light.
    area_light = torch.where(inst.tri_emissive[tid],
                             inst.inst_area_light[ii], -1).to(torch.int32)
    return dict(p=p, nn=nn, sn=ns, ss=ss, ts=ts, u=u, v=v,
                dpdu=dpdu, dpdv=dpdv, dndu=dndu, dndv=dndv,
                material=inst.material[tid], area_light=area_light)
