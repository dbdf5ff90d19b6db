"""Batched ray-quadric intersection and quadric differential geometry (port
of tpuprt/shapes/quadrics.py; pbrt-v1 shapes/{sphere,cylinder,disk,cone,
paraboloid,hyperboloid}.cpp).

Every kind goes through one pipeline: the ray in object space, per-kind
quadratic coefficients (A, B, C), one quadratic solve, per-kind z/phi clip
tests of both roots, the nearer root that passes. The disk is the linear
case, folded in by masking. Differential geometry follows the reference's
object-space formulas, with the Weingarten equations for dndu/dndv.
"""
from __future__ import annotations

import math

import torch

from ..core import transform as tf
from ..core import vecmath as vm
from ..scene.data import (QUADRIC_CONE, QUADRIC_CYLINDER, QUADRIC_DISK,
                          QUADRIC_HYPERBOLOID, QUADRIC_PARABOLOID,
                          QUADRIC_SPHERE, QuadricTable)

_BIG = 1e30
ALL_QUADRIC_KINDS = (0, 1, 2, 3, 4, 5)


def _phi_of(x, y):
    """atan2(y, x) in [0, 2 pi)."""
    phi = torch.atan2(y, x)
    return torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)


def _select(kind, table, kinds_present):
    """The value of each lane's kind from [(kind, value), ...], over the
    kinds present (the first present kind is the default)."""
    present = [(k, v) for k, v in table if k in kinds_present]
    out = present[0][1]
    for k, v in present[1:]:
        out = torch.where(kind == k, v, out)
    return out


def _phimax(kind, p):
    return torch.where(kind == QUADRIC_DISK, p[..., 3],
                       torch.where(kind == QUADRIC_CONE, p[..., 2],
                                   torch.where(kind == QUADRIC_HYPERBOLOID,
                                               p[..., 6], p[..., 3])))


def _coeffs(kind, p, o, d, kinds_present=ALL_QUADRIC_KINDS):
    """Quadratic coefficients (A, B, C) of each lane's kind."""
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    radius = p[..., 0]
    # sphere (shapes/sphere.cpp:96-101)
    a_s = dx * dx + dy * dy + dz * dz
    b_s = 2.0 * (dx * ox + dy * oy + dz * oz)
    c_s = ox * ox + oy * oy + oz * oz - radius * radius
    # cylinder (shapes/cylinder.cpp:68-73)
    a_c = dx * dx + dy * dy
    b_c = 2.0 * (dx * ox + dy * oy)
    c_c = ox * ox + oy * oy - radius * radius
    # disk: linear, (h - oz) / dz as A = 0, B = dz, C = oz - h
    a_d = torch.zeros_like(a_s)
    b_d = dz
    c_d = oz - p[..., 0]
    # cone (shapes/cone.cpp:64-73): k = (r / h)^2
    r_co, h_co = p[..., 0], p[..., 1]
    k_co = (r_co / torch.where(h_co == 0, 1.0, h_co)) ** 2
    a_co = dx * dx + dy * dy - k_co * dz * dz
    b_co = 2.0 * (dx * ox + dy * oy - k_co * dz * (oz - h_co))
    c_co = ox * ox + oy * oy - k_co * (oz - h_co) * (oz - h_co)
    # paraboloid (shapes/paraboloid.cpp:64-72): k = zmax / r^2
    r_pa, zmax_pa = p[..., 0], p[..., 2]
    k_pa = zmax_pa / torch.where(r_pa == 0, 1.0, r_pa * r_pa)
    a_pa = k_pa * (dx * dx + dy * dy)
    b_pa = 2.0 * k_pa * (dx * ox + dy * oy) - dz
    c_pa = k_pa * (ox * ox + oy * oy) - oz
    # hyperboloid (shapes/hyperboloid.cpp:93-101): a(x^2 + y^2) - c z^2 = 1
    a_h, c_h = p[..., 0], p[..., 1]
    a_hy = a_h * (dx * dx + dy * dy) - c_h * dz * dz
    b_hy = 2.0 * (a_h * (dx * ox + dy * oy) - c_h * dz * oz)
    c_hy = a_h * (ox * ox + oy * oy) - c_h * oz * oz - 1.0

    kinds = (QUADRIC_SPHERE, QUADRIC_CYLINDER, QUADRIC_DISK, QUADRIC_CONE,
             QUADRIC_PARABOLOID, QUADRIC_HYPERBOLOID)
    return tuple(_select(kind, list(zip(kinds, vals)), kinds_present)
                 for vals in ((a_s, a_c, a_d, a_co, a_pa, a_hy),
                              (b_s, b_c, b_d, b_co, b_pa, b_hy),
                              (c_s, c_c, c_d, c_co, c_pa, c_hy)))


def _clip_ok(kind, p, o, d, t, kinds_present=ALL_QUADRIC_KINDS):
    """Per-kind z/phi/radius clip tests of the hit point at parameter t."""
    hit = o + t[..., None] * d
    x, y, z = hit[..., 0], hit[..., 1], hit[..., 2]
    phimax = _phimax(kind, p)
    ok_phi = _phi_of(x, y) <= phimax + 1e-6
    zmin, zmax = p[..., 1], p[..., 2]
    d2 = x * x + y * y
    z_in = (z >= zmin) & (z <= zmax)
    ok = _select(kind, [
        (QUADRIC_SPHERE, z_in),
        (QUADRIC_CYLINDER, z_in),
        (QUADRIC_DISK, (d2 <= p[..., 1] * p[..., 1]) &
         (d2 >= p[..., 2] * p[..., 2])),
        (QUADRIC_CONE, (z >= 0.0) & (z <= p[..., 1])),
        (QUADRIC_PARABOLOID, (z >= torch.minimum(p[..., 1], p[..., 2])) &
         (z <= torch.maximum(p[..., 1], p[..., 2]))),
        # hyperboloid: z between p1z and p2z, stored at 2 and 5
        (QUADRIC_HYPERBOLOID, (z >= torch.minimum(p[..., 2], p[..., 5])) &
         (z <= torch.maximum(p[..., 2], p[..., 5]))),
    ], kinds_present)
    return ok & ok_phi


def intersect(quad: QuadricTable, o, d, mint, maxt):
    """Test rays against every quadric: o, d f32[N,3] world space, mint,
    maxt f32[N]. Returns (t f32[N,Q], valid bool[N,Q]), each pair's
    nearest valid root (1e30 where none)."""
    oo = tf.apply_point(quad.w2o[None], o[:, None, :])
    od = tf.apply_vector(quad.w2o[None], d[:, None, :])
    kind = quad.kind[None, :]
    p = quad.params[None, :]
    kp = quad.kinds_present or ALL_QUADRIC_KINDS
    a, b, c = _coeffs(kind, p, oo, od, kp)
    linear = kind == QUADRIC_DISK
    okq, t0, t1 = vm.quadratic(a, b, c)
    # Disk: the single root -C/B, none if the ray runs along the plane.
    t_lin = -c / torch.where(torch.abs(b) < 1e-12, 1e-12, b)
    t0 = torch.where(linear, t_lin, t0)
    t1 = torch.where(linear, _BIG, t1)
    okq = torch.where(linear, torch.abs(b) >= 1e-7, okq)
    mint_b, maxt_b = mint[:, None], maxt[:, None]
    in0 = okq & (t0 > mint_b) & (t0 < maxt_b) & \
        _clip_ok(kind, p, oo, od, t0, kp)
    in1 = okq & (t1 > mint_b) & (t1 < maxt_b) & \
        _clip_ok(kind, p, oo, od, t1, kp)
    t = torch.where(in0, t0, torch.where(in1, t1, _BIG))
    return t, in0 | in1


def intersect_gathered(quad: QuadricTable, qid, o, d, mint, maxt):
    """Each lane against its own quadric qid i[N] (an accelerator walk's
    candidate): (t f32[N], 1e30 where none, valid bool[N])
    (tpuprt/shapes/quadrics.py:157-185)."""
    kind = quad.kind[qid]
    p = quad.params[qid]
    w2o_c = tf.row_components(quad.w2o, qid)
    oo = tf.rows_apply_point(w2o_c, o)
    od = tf.rows_apply_vector(w2o_c, d)
    kp = quad.kinds_present or ALL_QUADRIC_KINDS
    a, b, c = _coeffs(kind, p, oo, od, kp)
    linear = kind == QUADRIC_DISK
    okq, t0, t1 = vm.quadratic(a, b, c)
    t_lin = -c / torch.where(torch.abs(b) < 1e-12, 1e-12, b)
    t0 = torch.where(linear, t_lin, t0)
    t1 = torch.where(linear, _BIG, t1)
    okq = torch.where(linear, torch.abs(b) >= 1e-7, okq)
    in0 = okq & (t0 > mint) & (t0 < maxt) & \
        _clip_ok(kind, p, oo, od, t0, kp)
    in1 = okq & (t1 > mint) & (t1 < maxt) & \
        _clip_ok(kind, p, oo, od, t1, kp)
    t = torch.where(in0, t0, torch.where(in1, t1, _BIG))
    return t, in0 | in1


def differential_geometry(quad: QuadricTable, qid, o, d, t):
    """DifferentialGeometry of each ray's quadric qid i[N] (a valid index)
    at t: dict(p, nn (geometric, flip applied), u, v, dpdu, dpdv, dndu,
    dndv), world space (e.g. shapes/sphere.cpp:145-202; the orientation
    flip of core/shape.cpp:49-50)."""
    qid = qid.long()
    w2o_c = tf.row_components(quad.w2o, qid)
    o2w_c = tf.row_components(quad.o2w, qid)
    kind = quad.kind[qid]
    p = quad.params[qid]
    oo = tf.rows_apply_point(w2o_c, o)
    od = tf.rows_apply_vector(w2o_c, d)
    ph = oo + t[..., None] * od                       # object-space hit
    x, y, z = ph[..., 0], ph[..., 1], ph[..., 2]
    phimax = _phimax(kind, p)
    u = _phi_of(x, y) / torch.where(phimax == 0, 1.0, phimax)

    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    zero3 = torch.zeros_like(ph)
    kp = quad.kinds_present or ALL_QUADRIC_KINDS

    def st(*cs):
        return torch.stack(cs, dim=-1)

    # Every kind's dpdu and d2pduu (the rotation about z).
    dpdu_rot = st(-phimax * y, phimax * x, zeros)
    d2pduu_rot = (-phimax * phimax)[..., None] * st(x, y, zeros)
    per_kind = {}  # kind -> (v, dpdu, dpdv, d2pduu, d2pduv, d2pdvv)
    if QUADRIC_SPHERE in kp:
        # shapes/sphere.cpp:145-202
        radius, thetamin, thetamax = p[..., 0], p[..., 4], p[..., 5]
        theta = torch.arccos(torch.clamp(
            z / torch.where(radius == 0, 1.0, radius), -1 + 1e-7, 1 - 1e-7))
        dth = thetamax - thetamin
        v_sph = (theta - thetamin) / torch.where(thetamax == thetamin, 1.0,
                                                 dth)
        zr = torch.sqrt(torch.clamp(x * x + y * y, min=1e-12))
        inv_zr = 1.0 / zr
        cphi, sphi = x * inv_zr, y * inv_zr
        dpdv_s = dth[..., None] * st(z * cphi, z * sphi,
                                     -radius * torch.sin(theta))
        d2pduv_s = (dth * z * phimax)[..., None] * st(-sphi, cphi, zeros)
        d2pdvv_s = (-dth ** 2)[..., None] * ph
        per_kind[QUADRIC_SPHERE] = (v_sph, dpdu_rot, dpdv_s, d2pduu_rot,
                                    d2pduv_s, d2pdvv_s)
    if QUADRIC_CYLINDER in kp:
        # shapes/cylinder.cpp:106-136
        zmin, zmax = p[..., 1], p[..., 2]
        v_cyl = (z - zmin) / torch.where(zmax == zmin, 1.0, zmax - zmin)
        dpdv_c = st(zeros, zeros, zmax - zmin)
        per_kind[QUADRIC_CYLINDER] = (v_cyl, dpdu_rot, dpdv_c, d2pduu_rot,
                                      zero3, zero3)
    if QUADRIC_DISK in kp:
        # shapes/disk.cpp:92-112: v from the radius
        r_disk, ir_disk = p[..., 1], p[..., 2]
        dist = torch.sqrt(torch.clamp(x * x + y * y, min=1e-12))
        v_dsk = 1.0 - (dist - ir_disk) / torch.where(
            r_disk == ir_disk, 1.0, r_disk - ir_disk)
        one_m_v = torch.where(v_dsk >= 1.0, 1.0, 1.0 - v_dsk)
        dpdv_d = st(-x / one_m_v, -y / one_m_v, zeros) * \
            ((r_disk - ir_disk) /
             torch.where(r_disk == 0, 1.0, r_disk))[..., None]
        per_kind[QUADRIC_DISK] = (v_dsk, dpdu_rot, dpdv_d, zero3, zero3,
                                  zero3)
    if QUADRIC_CONE in kp:
        # shapes/cone.cpp:107-133
        h_co = p[..., 1]
        v_con = z / torch.where(h_co == 0, 1.0, h_co)
        one_m_v = torch.clamp(1.0 - v_con, min=1e-6)
        dpdv_co = st(-x / one_m_v, -y / one_m_v, h_co)
        d2pduv_co = (phimax / one_m_v)[..., None] * st(y, -x, zeros)
        per_kind[QUADRIC_CONE] = (v_con, dpdu_rot, dpdv_co, d2pduu_rot,
                                  d2pduv_co, zero3)
    if QUADRIC_PARABOLOID in kp:
        # shapes/paraboloid.cpp:107-137
        zmin_pa, zmax_pa = p[..., 1], p[..., 2]
        dz_pa = zmax_pa - zmin_pa
        v_par = (z - zmin_pa) / torch.where(zmax_pa == zmin_pa, 1.0, dz_pa)
        z_safe = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
        dpdv_pa = dz_pa[..., None] * st(x / (2.0 * z_safe),
                                        y / (2.0 * z_safe), ones)
        d2pduv_pa = (dz_pa * phimax)[..., None] * st(
            -y / (2.0 * z_safe), x / (2.0 * z_safe), zeros)
        d2pdvv_pa = (-dz_pa ** 2 / (4.0 * z_safe * z_safe))[..., None] * \
            st(x, y, zeros)
        per_kind[QUADRIC_PARABOLOID] = (v_par, dpdu_rot, dpdv_pa, d2pduu_rot,
                                        d2pduv_pa, d2pdvv_pa)
    if QUADRIC_HYPERBOLOID in kp:
        # shapes/hyperboloid.cpp:128-167; params [a, c, p1z, p1x, p1y, p2z,
        # phimax, 0]. dpdv: the surface tangent orthogonal to dpdu, from
        # the gradient of F = a(x^2 + y^2) - c z^2 - 1.
        p1z, p2z = p[..., 2], p[..., 5]
        v_hyp = (z - p1z) / torch.where(p2z == p1z, 1.0, p2z - p1z)
        a_h, c_h = p[..., 0], p[..., 1]
        grad = st(2 * a_h * x, 2 * a_h * y, -2 * c_h * z)
        dpdv_h = vm.normalize(vm.cross(grad, dpdu_rot)) * torch.where(
            p2z == p1z, 1.0, torch.abs(p2z - p1z))[..., None]
        per_kind[QUADRIC_HYPERBOLOID] = (v_hyp, dpdu_rot, dpdv_h, d2pduu_rot,
                                         zero3, zero3)

    items = [(k, per_kind[k]) for k in kp if k in per_kind]
    v, dpdu, dpdv, d2pduu, d2pduv, d2pdvv = items[0][1]
    for k, vals in items[1:]:
        m1 = kind == k
        m3 = m1[..., None]
        v = torch.where(m1, vals[0], v)
        dpdu = torch.where(m3, vals[1], dpdu)
        dpdv = torch.where(m3, vals[2], dpdv)
        d2pduu = torch.where(m3, vals[3], d2pduu)
        d2pduv = torch.where(m3, vals[4], d2pduv)
        d2pdvv = torch.where(m3, vals[5], d2pdvv)

    # Weingarten equations -> dndu, dndv (shapes/sphere.cpp:168-189).
    e_ = vm.dot(dpdu, dpdu)
    f_ = vm.dot(dpdu, dpdv)
    g_ = vm.dot(dpdv, dpdv)
    n_obj = vm.normalize(vm.cross(dpdu, dpdv))
    e = vm.dot(n_obj, d2pduu)
    f = vm.dot(n_obj, d2pduv)
    gg = vm.dot(n_obj, d2pdvv)
    inv_egf2 = 1.0 / torch.clamp(e_ * g_ - f_ * f_, min=1e-12)
    dndu = ((f * f_ - e * g_) * inv_egf2)[..., None] * dpdu + \
        ((e * f_ - f * e_) * inv_egf2)[..., None] * dpdv
    dndv = ((gg * f_ - f * g_) * inv_egf2)[..., None] * dpdu + \
        ((f * f_ - gg * e_) * inv_egf2)[..., None] * dpdv

    # To world space; normals by the inverse transpose.
    dpdu_w = tf.rows_apply_vector(o2w_c, dpdu)
    dpdv_w = tf.rows_apply_vector(o2w_c, dpdv)
    nn = vm.normalize(vm.cross(dpdu_w, dpdv_w)) * \
        quad.flip_normal[qid][..., None]
    return dict(p=tf.rows_apply_point(o2w_c, ph), nn=nn, u=u, v=v,
                dpdu=dpdu_w, dpdv=dpdv_w,
                dndu=tf.rows_apply_normal(w2o_c, dndu),
                dndv=tf.rows_apply_normal(w2o_c, dndv))
