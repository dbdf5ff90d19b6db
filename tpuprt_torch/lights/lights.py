"""Batched light sampling (port of tpuprt/lights/lights.py).

Per-lane light ids index the LightTable; each kind's sample is computed
masked and selected, as in the reference:
  * point I / d^2 (lights/point.cpp:55-77), spot with its falloff
    ((cos - cw) / (cf - cw))^4 (lights/spot.cpp:67-78), projection through
    its screen window and map (lights/projection.cpp:100-113),
    goniometric by its direction map (lights/goniometric.cpp): the delta
    lights at a position;
  * distant (lights/distant.cpp:61-75);
  * area on a quadric: a sphere by cone sampling (shapes/sphere.cpp:45-79)
    with the cone's pdf, a disk or cylinder uniformly over its surface; on
    a triangle mesh, a triangle picked by the area CDF, then uniformly
    (core/shape.h ShapeSet); on an instanced prototype the same over its
    object-space triangles, moved by the instance's transform; the
    solid-angle pdf dist^2/(|cos| area) (core/shape.h:96-107), one-sided
    emission (core/light.h:88-116);
  * infinite: cosine-weighted about the normal with a hemisphere flip and
    pdf |cos|/2pi (lights/infinite.cpp:96-120), the map's radiance by
    spherical direction; infinitesample by its map's importance tables
    (lights/infinitesample.cpp:152-191).

The maps are read through the MIPMap's trilinear lookup at the finest
level (textures/graph.mipmap_lookup_tri with width 0).
"""
from __future__ import annotations

import math

import torch

from ..core import mc, transform as tf, vecmath as vm
from ..core.vecmath import RAY_EPSILON
from ..scene.data import (AREA_GEOM_INST, AREA_GEOM_QUADRIC,
                          AREA_GEOM_TRIS, LIGHT_AREA,
                          LIGHT_DISTANT, LIGHT_GONIOMETRIC,
                          LIGHT_INFINITE, LIGHT_POINT, LIGHT_PROJECTION,
                          LIGHT_SPOT, QUADRIC_DISK, QUADRIC_SPHERE,
                          SceneData)
from ..textures.graph import mipmap_lookup_tri, spherical_phi, \
    spherical_theta

_BIG = 1e30
DELTA_KINDS = (LIGHT_POINT, LIGHT_SPOT, LIGHT_DISTANT, LIGHT_PROJECTION,
               LIGHT_GONIOMETRIC)
# The delta lights whose intensity varies with direction.
DIRECTIONAL_KINDS = (LIGHT_SPOT, LIGHT_PROJECTION, LIGHT_GONIOMETRIC)


def _any_kind(kind, kinds):
    m = kind == kinds[0]
    for k in kinds[1:]:
        m = m | (kind == k)
    return m


def is_delta(kind):
    """IsDeltaLight (core/light.h:60-65); `kind` is an int or an int
    tensor."""
    if isinstance(kind, int):
        return kind in DELTA_KINDS
    return _any_kind(kind, DELTA_KINDS)


def is_directional(kind):
    """Whether each lane's light is a spot, projection or goniometric
    light, whose intensity is scaled by `_projection_factor`."""
    return _any_kind(kind, DIRECTIONAL_KINDS)


def _map_lookup(scene: SceneData, img: int, s, t):
    return mipmap_lookup_tri(scene.images, img, s, t, torch.zeros_like(s))


def _env_value(scene: SceneData, lid: int, img: int, d_world):
    """Infinite light `lid`'s radiance toward d_world: its L, times its
    map at the direction's spherical coordinates when it has one."""
    lights = scene.lights
    base = lights.spectrum[lid]
    if img < 0:
        return base.expand(d_world.shape[:-1] + (3,))
    wl = vm.normalize(tf.apply_vector(lights.w2l[lid], d_world))
    s = spherical_phi(wl) * (0.5 / math.pi)
    t = spherical_theta(wl) * (1.0 / math.pi)
    return base * _map_lookup(scene, img, s, t)


def env_radiance(scene: SceneData, light_id, d_world):
    """Radiance of the infinite light `light_id` toward d_world (other
    lanes 0)."""
    L = torch.zeros(d_world.shape[:-1] + (3,), dtype=torch.float32,
                    device=d_world.device)
    for (lid, img, _imp) in scene.lights.infinite_meta:
        L = torch.where((light_id == lid)[..., None],
                        _env_value(scene, lid, img, d_world), L)
    return L


def le_escaped(scene: SceneData, d_world):
    """Sum of Le over all infinite lights for escaped rays
    (lights/infinite.cpp:83-95)."""
    L = torch.zeros(d_world.shape[:-1] + (3,), dtype=torch.float32,
                    device=d_world.device)
    for (lid, img, _imp) in scene.lights.infinite_meta:
        L = L + _env_value(scene, lid, img, d_world)
    return L


def _projection_factor(scene: SceneData, light_id, w_world):
    """The direction factor of spot, projection and goniometric lights
    toward w_world (light to point); 1 on other lanes
    (tpuprt/lights/lights.py:87-138)."""
    lights = scene.lights
    kind = lights.kind[light_id]
    wl = tf.rows_apply_vector(tf.row_components(lights.w2l, light_id),
                              w_world)
    fac = torch.ones(w_world.shape[:-1] + (3,), dtype=torch.float32,
                     device=w_world.device)
    # Spot falloff; params [cos total width, cos falloff start].
    wln = vm.normalize(wl)
    costheta = wln[..., 2]
    p = lights.params[light_id]
    cw, cf = p[..., 0], p[..., 1]
    delta = torch.clamp((costheta - cw) / torch.clamp(cf - cw, min=1e-8),
                        0.0, 1.0)
    delta2 = delta * delta          # delta^4 by squaring, as XLA's pow
    fall = torch.where(costheta < cw, 0.0,
                       torch.where(costheta > cf, 1.0, delta2 * delta2))
    fac = torch.where((kind == LIGHT_SPOT)[..., None], fall[..., None], fac)
    # Projection: x' = p00 x / z, y' = p11 y / z inside the screen window.
    zl = wln[..., 2]
    ok_z = zl >= RAY_EPSILON
    inv_z = 1.0 / torch.where(ok_z, zl, 1.0)
    xs = p[..., 0] * wln[..., 0] * inv_z
    ys = p[..., 1] * wln[..., 1] * inv_z
    inside = ok_z & (xs >= p[..., 4]) & (xs <= p[..., 5]) & \
        (ys >= p[..., 6]) & (ys <= p[..., 7])
    fac = torch.where((kind == LIGHT_PROJECTION)[..., None],
                      torch.where(inside, 1.0, 0.0)[..., None], fac)
    # Maps: a projection light's by screen coordinates, a goniometric
    # light's by the spherical coordinates of wl.
    if lights.dir_map_meta:
        s_p = (xs - p[..., 4]) / torch.clamp(p[..., 5] - p[..., 4],
                                             min=1e-8)
        t_p = (ys - p[..., 6]) / torch.clamp(p[..., 7] - p[..., 6],
                                             min=1e-8)
        s_g = spherical_phi(wln) * (0.5 / math.pi)
        t_g = spherical_theta(wln) * (1.0 / math.pi)
        is_proj = kind == LIGHT_PROJECTION
        s = torch.where(is_proj, s_p, s_g)
        t = torch.where(is_proj, t_p, t_g)
    for (lid, img) in lights.dir_map_meta:
        fac = torch.where((light_id == lid)[..., None],
                          fac * _map_lookup(scene, img, s, t), fac)
    return fac


def _pick_area_triangle(lights, light_id, u3):
    """The triangle of a mesh emitter's area CDF that u3 falls in: the
    binary search steps right on u3 > cdf[mid + 1], so a tie stays left
    (tpuprt/lights/lights.py:147-158). Returns global triangle ids."""
    off = lights.cdf_offset[light_id].long()
    cnt = lights.area_count[light_id].long()
    last = torch.clamp(cnt - 1, min=0)
    lo = torch.zeros_like(off)
    hi = last
    steps = max(1, int(math.ceil(math.log2(max(lights.max_area_count,
                                                2)))) + 1)
    for _ in range(steps):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        go_right = u3 > lights.area_cdf[off + mid + 1]
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    return lights.area_first[light_id].long() + torch.minimum(
        torch.clamp(lo, min=0), last)


def _sample_area_tris(scene: SceneData, light_id, u1, u2, u3):
    """ShapeSet sampling of a mesh emitter: a triangle by the area CDF,
    then a point uniform on it and its normal (trianglemesh.cpp:336-349)."""
    tri = scene.triangles
    # Lanes of other lights pick garbage here, which the caller discards;
    # the clamp keeps their gathers in bounds (a quadric emitter's index
    # may pass the triangle count).
    tid = torch.clamp(_pick_area_triangle(scene.lights, light_id, u3), 0,
                      tri.count - 1)
    i3 = tri.idx[tid].long()
    p0, p1, p2 = tri.verts[i3[..., 0]], tri.verts[i3[..., 1]], \
        tri.verts[i3[..., 2]]
    su1 = torch.sqrt(u1)
    b0, b1 = 1.0 - su1, u2 * su1
    ps = b0[..., None] * p0 + b1[..., None] * p1 + \
        (1.0 - b0 - b1)[..., None] * p2
    ns = vm.normalize(vm.cross(p1 - p0, p2 - p0)) * \
        tri.flip_normal[tid][..., None]
    return ps, ns


def _sample_area_inst(scene: SceneData, light_id, u1, u2, u3):
    """ShapeSet sampling of an instanced emitter (AREA_GEOM_INST;
    tpuprt/lights/lights.py:162-200): a prototype triangle by the area CDF
    (object space, shared by the prototype's instances), a point uniform
    on it, both moved by the light's l2w, which is the instance's
    transform. The normal is the one the instance's hits see
    (accel/instances.hit_geometry): the prototype's, flipped as it is,
    moved by the inverse transpose. tpuprt multiplies it once more by the
    sign of l2w's determinant (lights.py:197-199), which turns a mirrored
    instance's lamp to the side its hits do not emit on."""
    inst = scene.instances
    tid = torch.clamp(_pick_area_triangle(scene.lights, light_id, u3), 0,
                      inst.n_tris - 1)
    i3 = inst.idx[tid].long()
    p0, p1, p2 = inst.verts[i3[..., 0]], inst.verts[i3[..., 1]], \
        inst.verts[i3[..., 2]]
    su1 = torch.sqrt(u1)
    b0, b1 = 1.0 - su1, u2 * su1
    ps_o = b0[..., None] * p0 + b1[..., None] * p1 + \
        (1.0 - b0 - b1)[..., None] * p2
    ns_o = vm.normalize(vm.cross(p1 - p0, p2 - p0)) * \
        inst.flip_normal[tid][..., None]
    ps = tf.rows_apply_point(tf.row_components(scene.lights.l2w, light_id),
                             ps_o)
    ns = vm.normalize(tf.rows_apply_normal(
        tf.row_components(scene.lights.w2l, light_id), ns_o))
    return ps, ns


def sample_area_mesh(scene: SceneData, light_id, u1, u2, u3, ps, ns):
    """(ps, ns) with the lanes of triangle-mesh and instanced emitters
    replaced by a point on their triangles (u3 picks the triangle)."""
    lights = scene.lights
    geom = lights.area_geom_kind[light_id]
    for g, fn in ((AREA_GEOM_TRIS, _sample_area_tris),
                  (AREA_GEOM_INST, _sample_area_inst)):
        if g in lights.area_geoms_present:
            ps_g, ns_g = fn(scene, light_id, u1, u2, u3)
            m = (geom == g)[..., None]
            ps, ns = torch.where(m, ps_g, ps), torch.where(m, ns_g, ns)
    return ps, ns


def _sample_quadric(scene: SceneData, light_id, p, u1, u2):
    """A point on each lane's area-light quadric: the sphere by cone
    sampling from p (uniformly over the sphere when p is inside it), the
    disk and cylinder uniformly over their surface (tpuprt/lights/
    lights.py:243-327). Returns (ps, ns, pdf of the sphere's cone,
    solid_angle: whether that pdf applies)."""
    q = scene.quadrics
    qid = torch.clamp(scene.lights.area_first[light_id], 0,
                      q.count - 1).long()
    center = q.o2w[:, :3, 3][qid]
    radius = q.params[qid][..., 0]
    to_c = center - p
    dc2 = torch.clamp(vm.length_sq(to_c), min=1e-12)
    inside = dc2 - radius * radius < 1e-4
    wc = to_c * torch.rsqrt(dc2)[..., None]
    _, wcx, wcy = vm.coordinate_system(wc)
    cos_max = torch.sqrt(torch.clamp(1.0 - radius * radius / dc2,
                                     min=1e-12))
    dir_cone = mc.uniform_sample_cone_frame(u1, u2, cos_max, wcx, wcy, wc)
    # The cone ray's first hit on the sphere, in closed form.
    b = vm.dot(dir_cone, to_c)
    disc = b * b - (dc2 - radius * radius)
    thit = b - torch.sqrt(torch.clamp(disc, min=0.0))
    thit = torch.where(disc > 0, thit, vm.dot(to_c, dir_cone))
    ps_sph = p + thit[..., None] * dir_cone
    ns_sph = vm.normalize(ps_sph - center)
    # Inside: uniform over the sphere (sphere.cpp:53-55).
    sph_dir = mc.uniform_sample_sphere(u1, u2)
    ps_q = torch.where(inside[..., None], center + radius[..., None] *
                       sph_dir, ps_sph)
    ns_q = torch.where(inside[..., None], sph_dir, ns_sph)

    # Disk [height, radius, inner, phimax]: r from a lerp in r^2; cylinder
    # [radius, zmin, zmax, phimax]. Object space, then to world.
    qkind = q.kind[qid]
    pq = q.params[qid]
    d_h, d_r, d_ri, d_ph = pq[..., 0], pq[..., 1], pq[..., 2], pq[..., 3]
    rr = torch.sqrt(d_ri * d_ri + u1 * (d_r * d_r - d_ri * d_ri))
    phi_d = u2 * d_ph
    disk_ps = torch.stack([rr * torch.cos(phi_d), rr * torch.sin(phi_d),
                           d_h], -1)
    disk_ns = torch.zeros_like(disk_ps)
    disk_ns[..., 2] = 1.0
    c_r, c_z0, c_z1, c_ph = pq[..., 0], pq[..., 1], pq[..., 2], pq[..., 3]
    phi_c = u2 * c_ph
    zc = c_z0 + u1 * (c_z1 - c_z0)
    cyl_ps = torch.stack([c_r * torch.cos(phi_c), c_r * torch.sin(phi_c),
                          zc], -1)
    cyl_ns = torch.stack([torch.cos(phi_c), torch.sin(phi_c),
                          torch.zeros_like(zc)], -1)
    is_disk = (qkind == QUADRIC_DISK)[..., None]
    obj_ps = torch.where(is_disk, disk_ps, cyl_ps)
    obj_ns = torch.where(is_disk, disk_ns, cyl_ns)
    ps_flat = tf.rows_apply_point(tf.row_components(q.o2w, qid), obj_ps)
    ns_flat = vm.normalize(tf.rows_apply_normal(
        tf.row_components(q.w2o, qid), obj_ns))
    sphere = qkind == QUADRIC_SPHERE
    ps_q = torch.where(sphere[..., None], ps_q, ps_flat)
    ns_q = torch.where(sphere[..., None], ns_q, ns_flat) * \
        q.flip_normal[qid][..., None]
    return ps_q, ns_q, mc.uniform_cone_pdf(cos_max), sphere & ~inside


def sample(scene: SceneData, light_id, p, n, u1, u2, u3):
    """Light::Sample_L(p, n, u1, u2, u3) for a wavefront.

    Returns dict(Li, wi, pdf, delta, vis_maxt): the caller tests the
    visibility segment p + [eps, vis_maxt] * wi.
    """
    lights = scene.lights
    kp = lights.kinds_present
    kind = lights.kind[light_id]
    I = lights.spectrum[light_id]
    light_pos = lights.l2w[:, :3, 3][light_id]
    delta = is_delta(kind)

    # Distant: world direction stored in params[0:3].
    wi = lights.params[light_id][..., 0:3]
    Li = I
    if any(k in kp for k in (LIGHT_POINT,) + DIRECTIONAL_KINDS):
        # The delta lights at a position: I / d^2 toward it, times the
        # direction factor of spot, projection and goniometric lights.
        to_l = light_pos - p
        d2 = torch.clamp(vm.length_sq(to_l), min=1e-12)
        wi_pt = to_l * torch.rsqrt(d2)[..., None]
        Li_pt = I / d2[..., None]
        if any(k in kp for k in DIRECTIONAL_KINDS):
            Li_pt = Li_pt * torch.where(
                is_directional(kind)[..., None],
                _projection_factor(scene, light_id, -wi_pt), 1.0)
        at_pos = delta & (kind != LIGHT_DISTANT)
        wi = torch.where(at_pos[..., None], wi_pt, wi)
        Li = torch.where(at_pos[..., None], Li_pt, Li)

    # Infinite: cosine about n with a hemisphere flip by u3; an
    # infinitesample light by its importance tables.
    if LIGHT_INFINITE in kp:
        x, y = mc.concentric_sample_disk(u1, u2)
        z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=1e-12))
        z = torch.where(u3 < 0.5, -z, z)
        nf = vm.normalize(n)
        _, v1, v2 = vm.coordinate_system(nf)
        wi_inf = x[..., None] * v1 + y[..., None] * v2 + z[..., None] * nf
        pdf_inf = torch.abs(z) * mc.INV_TWOPI
        Li_inf = env_radiance(scene, light_id, wi_inf)
        for (lid, img, imp) in lights.infinite_meta:
            if imp < 0:
                continue
            wi_is, pdf_is, Li_is = _sample_env_importance(
                scene, lid, scene.env_importance[imp], img, u1, u2)
            sel = light_id == lid
            wi_inf = torch.where(sel[..., None], wi_is, wi_inf)
            pdf_inf = torch.where(sel, pdf_is, pdf_inf)
            Li_inf = torch.where(sel[..., None], Li_is, Li_inf)
        wi = torch.where(delta[..., None], wi, wi_inf)
        Li = torch.where(delta[..., None], Li, Li_inf)
        pdf = torch.where(delta, 1.0, pdf_inf)
    else:
        pdf = torch.where(delta, 1.0, 0.0)
    # The reference treats every delta light, distant included, as a
    # segment to the light's position (lights.py:398-402): a point light's
    # shadow ray ends short of it, and a distant light's at |l2w origin -
    # p|. Kept for parity.
    seg_target = light_pos
    seg = delta

    if LIGHT_AREA in kp:
        geoms = lights.area_geoms_present
        if AREA_GEOM_QUADRIC in geoms:
            ps_a, ns_a, pdf_q, solid_angle = _sample_quadric(
                scene, light_id, p, u1, u2)
            solid_angle = solid_angle & (lights.area_geom_kind[light_id] ==
                                         AREA_GEOM_QUADRIC)
        else:
            ps_a = p
            ns_a = torch.zeros_like(p)
            pdf_q = torch.zeros_like(u1)
            solid_angle = torch.zeros_like(u1, dtype=torch.bool)
        ps_a, ns_a = sample_area_mesh(scene, light_id, u1, u2, u3, ps_a,
                                      ns_a)
        to_s = ps_a - p
        ds2 = torch.clamp(vm.length_sq(to_s), min=1e-12)
        wi_area = to_s * torch.rsqrt(ds2)[..., None]
        # Solid-angle pdf (core/shape.h:96-107): dist^2 / (|cos| area).
        pdf_sa = ds2 / torch.clamp(vm.absdot(ns_a, wi_area) *
                                   lights.area_total_area[light_id],
                                   min=1e-12)
        emits = vm.dot(ns_a, -wi_area) > 0.0
        area = kind == LIGHT_AREA
        wi = torch.where(area[..., None], wi_area, wi)
        Li = torch.where(area[..., None], torch.where(emits[..., None], I,
                                                      0.0), Li)
        pdf = torch.where(area, torch.where(solid_angle, pdf_q, pdf_sa), pdf)
        seg_target = torch.where(area[..., None], ps_a, seg_target)
        seg = seg | area
    dist = torch.sqrt(torch.clamp(vm.length_sq(seg_target - p), min=1e-12))
    vis_maxt = torch.where(seg, dist * (1.0 - 1e-3), _BIG)
    return dict(Li=Li, wi=wi, pdf=pdf, delta=delta, vis_maxt=vis_maxt)


def _cdf_offset(cdf_gather, n: int, u):
    """The largest i in [0, n] with cdf[i] <= u (Distribution1D::Sample's
    upper_bound, lights/infinitesample.cpp:42-51): the search steps on
    u >= cdf[mid], so a tie goes right; clipped to n - 1."""
    lo = torch.zeros(u.shape, dtype=torch.long, device=u.device)
    hi = torch.full_like(lo, n)
    for _ in range(int(math.ceil(math.log2(n + 1))) + 1):
        mid = torch.div(lo + hi + 1, 2, rounding_mode="floor")
        go = u >= cdf_gather(mid)
        lo = torch.where(go, mid, lo)
        hi = torch.where(go, hi, mid - 1)
    return torch.clamp(lo, 0, n - 1)


def _sample_env_importance(scene: SceneData, lid: int, dist, img: int,
                           u1, u2):
    """InfiniteAreaLightIS::Sample_L(p, u1, u2) (lights/infinitesample.cpp:
    152-178): the column by the marginal, the row by that column's
    conditional, (fu, fv) -> (phi, theta), the pdf with the sin(theta)
    Jacobian."""
    nu, nv = dist.nu, dist.nv
    o_u = _cdf_offset(lambda i: dist.cdf_u[i], nu, u1)
    c0u = dist.cdf_u[o_u]
    du = (u1 - c0u) / torch.clamp(dist.cdf_u[o_u + 1] - c0u, min=1e-20)
    fu = o_u.to(torch.float32) + torch.clamp(du, 0.0, 1.0)
    pdf_u = dist.func_u[o_u] / torch.clamp(dist.int_u, min=1e-20)

    # The column's conditional CDF, read in place: cdf_v[o_u, i].
    cdf_v, row = dist.cdf_v.reshape(-1), o_u * (nv + 1)
    o_v = _cdf_offset(lambda i: cdf_v[row + i], nv, u2)
    c0, c1 = cdf_v[row + o_v], cdf_v[row + o_v + 1]
    dv = (u2 - c0) / torch.clamp(c1 - c0, min=1e-20)
    fv = o_v.to(torch.float32) + torch.clamp(dv, 0.0, 1.0)
    pdf_v = dist.func_v[o_u, o_v] / torch.clamp(dist.int_v[o_u], min=1e-20)

    theta = fv * (math.pi / nv)
    phi = fu * (2.0 * math.pi / nu)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    wl = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t],
                     -1)
    wi = tf.apply_vector(scene.lights.l2w[lid], wl)
    ok = sin_t > 1e-7
    pdf_val = torch.where(ok, pdf_u * pdf_v / (
        2.0 * math.pi * math.pi * torch.clamp(sin_t, min=1e-7)), 0.0)
    tex = _map_lookup(scene, img, fu / nu, fv / nv)
    Li = torch.where(ok[..., None], scene.lights.spectrum[lid] * tex, 0.0)
    return wi, pdf_val, Li


def _pdf_env_importance(scene: SceneData, lid: int, dist, wi_world):
    """InfiniteAreaLightIS::Pdf (lights/infinitesample.cpp:179-191)."""
    nu, nv = dist.nu, dist.nv
    wl = vm.normalize(tf.apply_vector(scene.lights.w2l[lid], wi_world))
    theta = spherical_theta(wl)
    phi = spherical_phi(wl)
    u = torch.clamp((phi * (0.5 / math.pi) * nu).to(torch.int32), 0,
                    nu - 1).long()
    v = torch.clamp((theta * (1.0 / math.pi) * nv).to(torch.int32), 0,
                    nv - 1).long()
    sin_t = torch.clamp(torch.sin(theta), min=1e-7)
    return (dist.func_u[u] * dist.func_v[u, v]) / \
        torch.clamp(dist.int_u * dist.int_v[u], min=1e-20) / \
        (2.0 * math.pi * math.pi * sin_t)


def pdf(scene: SceneData, light_id, p, n, wi):
    """light->Pdf(p, n, wi) for the BSDF strategy's MIS weight: 0 for
    delta lights, |n.wi|/2pi for infinite lights (lights/infinite.cpp:
    117-120), an infinitesample light's map pdf, the cone pdf of an
    area-light sphere (tpuprt/lights/lights.py:472-512). A disk's,
    cylinder's or mesh's pdf needs the ray's hit on it: the caller takes
    pdf_area_from_hit for those."""
    lights = scene.lights
    kind = lights.kind[light_id]
    out = torch.where(kind == LIGHT_INFINITE,
                      vm.absdot(n, wi) * mc.INV_TWOPI, 0.0)
    for (lid, _img, imp) in lights.infinite_meta:
        if imp < 0:
            continue
        out = torch.where(light_id == lid, _pdf_env_importance(
            scene, lid, scene.env_importance[imp], wi), out)
    q = scene.quadrics
    if q is not None and q.count > 0:
        qid = torch.clamp(lights.area_first[light_id], 0, q.count - 1).long()
        center = q.o2w[:, :3, 3][qid]
        radius = q.params[qid][..., 0]
        dc2 = torch.clamp(vm.length_sq(center - p), min=1e-12)
        cos_max = torch.sqrt(torch.clamp(1.0 - radius * radius / dc2,
                                         min=1e-12))
        is_sphere = (kind == LIGHT_AREA) & \
            (lights.area_geom_kind[light_id] == AREA_GEOM_QUADRIC) & \
            (q.kind[qid] == QUADRIC_SPHERE)
        out = torch.where(is_sphere, mc.uniform_cone_pdf(cos_max), out)
    return out


def pdf_area_from_hit(scene: SceneData, light_id, p, wi, hit_p, hit_nn):
    """Solid-angle pdf of an area light given the ray's actual hit on it
    (Shape::Pdf(p, wi))."""
    d2 = vm.length_sq(hit_p - p)
    cos_l = vm.absdot(hit_nn, wi)
    return d2 / torch.clamp(cos_l * scene.lights.area_total_area[light_id],
                            min=1e-12)


def area_emission(scene: SceneData, area_id, nn, w):
    """AreaLight::L(p, n, w): one-sided Lemit (core/light.h:97-101); 0 where
    area_id is -1. Without lights it raises IndexError, where tpuprt's
    gather from the empty table fails (tpuprt/lights/lights.py:525-528:
    directlighting's scan Li on a scene without lights)."""
    if scene.lights.count == 0:
        raise IndexError("area_emission: the scene has no lights")
    L = scene.lights.spectrum[torch.clamp(area_id, min=0).long()]
    emits = (vm.dot(nn, w) > 0.0) & (area_id >= 0)
    return torch.where(emits[..., None], L, 0.0)


def power(scene: SceneData):
    """Light::Power of each light f32[L,3] (tpuprt/lights/lights.py:
    533-553): 4 pi I for a point or goniometric light, 2 pi I (1 - (cw +
    cf) / 2) for a spot or projection light, L pi area for an area light,
    L pi r^2 over the world's bounding sphere for a distant or infinite
    light."""
    lights = scene.lights
    radius = 0.5 * vm.length(scene.world_bound_hi - scene.world_bound_lo)
    k = lights.kind[..., None]
    spec = lights.spectrum
    far = spec * (math.pi * radius * radius)
    point = spec * (4.0 * math.pi)
    spot = spec * (2.0 * math.pi * (1.0 - 0.5 * (
        lights.params[..., 1] + lights.params[..., 0])))[..., None]
    out = torch.where(k == LIGHT_POINT, point, far)
    out = torch.where((k == LIGHT_SPOT) | (k == LIGHT_PROJECTION), spot, out)
    out = torch.where(k == LIGHT_GONIOMETRIC, point, out)
    return torch.where(k == LIGHT_AREA, spec * (
        lights.area_total_area[..., None] * math.pi), out)
