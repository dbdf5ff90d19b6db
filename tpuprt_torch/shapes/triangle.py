"""Ray-triangle intersection and triangle differential geometry (port of
tpuprt/shapes/triangle.py; Triangle::Intersect / GetShadingGeometry,
pbrt-v1 shapes/trianglemesh.cpp:213-278, :71-133)."""
from __future__ import annotations

import torch

from ..core import vecmath as vm
from ..scene.data import TriangleTable

_BIG = 1e30


def gather_verts(tri: TriangleTable, tid):
    i = tri.idx[tid].long()  # [..., 3]
    return tri.verts[i[..., 0]], tri.verts[i[..., 1]], tri.verts[i[..., 2]]


def intersect_pairs(p0, p1, p2, o, d, mint, maxt):
    """Edge test for broadcast-compatible point/ray stacks.
    Returns (t, b1, b2, valid)."""
    return intersect_edges(p0, p1 - p0, p2 - p0, o, d, mint, maxt)


def intersect_edges(p0, e1, e2, o, d, mint, maxt):
    """intersect_pairs with the edges e1 = p1 - p0, e2 = p2 - p0 given (as
    the brute-force kernel's packed triangles carry them). The CUDA kernel
    (ops/csrc/mt_best.cu) repeats these steps in this order."""
    s1 = vm.cross(d, e2)
    div = vm.dot(s1, e1)
    ok = torch.abs(div) > 1e-12
    inv = 1.0 / torch.where(ok, div, 1.0)
    s = o - p0
    b1 = vm.dot(s, s1) * inv
    s2 = vm.cross(s, e1)
    b2 = vm.dot(d, s2) * inv
    t = vm.dot(e2, s2) * inv
    valid = ok & (b1 >= 0.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0) & \
        (t > mint) & (t < maxt)
    return t, b1, b2, valid


def intersect(tri: TriangleTable, o, d, mint, maxt):
    """All-pairs test: o, d f32[N,3] vs the T triangles -> (t f32[N,T],
    1e30 where invalid, valid bool[N,T])."""
    p0, p1, p2 = gather_verts(tri, torch.arange(tri.count,
                                                device=o.device))
    t, _, _, valid = intersect_pairs(
        p0[None], p1[None], p2[None],
        o[:, None], d[:, None], mint[:, None], maxt[:, None])
    return torch.where(valid, t, _BIG), valid


def differential_geometry(tri: TriangleTable, tid, o, d, t):
    """Geometric + shading differential geometry for winning hits: uv
    gradients dpdu/dpdv (trianglemesh.cpp:243-266) and the interpolated
    shading frame (trianglemesh.cpp:71-133)."""
    p0, p1, p2 = gather_verts(tri, tid)
    _, b1, b2, _ = intersect_pairs(p0, p1, p2, o, d,
                                   torch.full_like(t, -_BIG),
                                   torch.full_like(t, _BIG))
    b0 = 1.0 - b1 - b2
    i = tri.idx[tid].long()
    uv0, uv1, uv2 = tri.uv[i[..., 0]], tri.uv[i[..., 1]], tri.uv[i[..., 2]]

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
    # Degenerate uvs: arbitrary frame around the geometric normal.
    _, fu, fv = vm.coordinate_system(vm.normalize(vm.cross(p1 - p0, p2 - p0)))
    dpdu = torch.where(degen[..., None], fu, dpdu)
    dpdv = torch.where(degen[..., None], fv, dpdv)

    flip = tri.flip_normal[tid][..., None]
    nn = vm.normalize(vm.cross(dpdu, dpdv)) * flip

    # Shading geometry: interpolate per-vertex normals/tangents if present.
    has_n = tri.has_normals[tid][..., None]
    n0, n1, n2 = (tri.normals[i[..., 0]], tri.normals[i[..., 1]],
                  tri.normals[i[..., 2]])
    ns = vm.normalize(b0[..., None] * n0 + b1[..., None] * n1 +
                      b2[..., None] * n2) * flip
    ns = torch.where(has_n, ns, nn)

    has_t = tri.has_tangents[tid][..., None]
    t0, t1, t2 = (tri.tangents[i[..., 0]], tri.tangents[i[..., 1]],
                  tri.tangents[i[..., 2]])
    ss_interp = vm.normalize(b0[..., None] * t0 + b1[..., None] * t1 +
                             b2[..., None] * t2)
    ss = torch.where(has_t, ss_interp, vm.normalize(dpdu))
    ts = vm.cross(ss, ns)
    ts_len = vm.length(ts)[..., None]
    ts = torch.where(ts_len > 1e-6, ts / torch.clamp(ts_len, min=1e-12),
                     vm.coordinate_system(ns)[1])
    ss = vm.cross(ts, ns)

    # dndu/dndv for shading normals from uv deltas (trianglemesh.cpp:104-123).
    dn1 = n0 - n2
    dn2 = n1 - n2
    dndu = (dv2[..., None] * dn1 - dv1[..., None] * dn2) * invdet[..., None]
    dndv = (-du2[..., None] * dn1 + du1[..., None] * dn2) * invdet[..., None]
    flat = (degen[..., None] | ~has_n)
    dndu = torch.where(flat, 0.0, dndu)
    dndv = torch.where(flat, 0.0, dndv)

    return dict(p=p, nn=nn, u=u, v=v, dpdu=dpdu, dpdv=dpdv,
                dndu=dndu, dndv=dndv, sn=ns, ss=ss, ts=ts)
