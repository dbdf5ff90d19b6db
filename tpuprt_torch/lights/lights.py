"""Batched light sampling (port of tpuprt/lights/lights.py for point and
distant lights, infinite lights without an environment map, and area
lights on a sphere, disk or cylinder).

Per-lane light ids index the LightTable; each kind's sample is computed
masked and selected, as in the reference:
  * point (lights/point.cpp:38-50): I / d^2 toward the light's position,
    a delta light,
  * distant (lights/distant.cpp:61-75),
  * infinite: cosine-weighted about the normal with a hemisphere flip and
    pdf |cos|/2pi (lights/infinite.cpp:96-120),
  * area on a quadric: a sphere by cone sampling (shapes/sphere.cpp:45-79)
    with the cone's pdf, a disk or cylinder uniformly over its surface with
    the solid-angle pdf dist^2/(|cos| area) (core/shape.h:96-107); one-sided
    emission (core/light.h:88-116).
"""
from __future__ import annotations

import math

import torch

from ..core import mc, transform as tf, vecmath as vm
from ..scene.data import (AREA_GEOM_QUADRIC, LIGHT_AREA, LIGHT_DISTANT,
                          LIGHT_INFINITE, LIGHT_POINT, QUADRIC_DISK,
                          QUADRIC_SPHERE, SceneData)

_BIG = 1e30
PORTED_KINDS = (LIGHT_POINT, LIGHT_DISTANT, LIGHT_AREA, LIGHT_INFINITE)


def check(lights):
    missing = set(lights.kinds_present) - set(PORTED_KINDS)
    if missing:
        raise NotImplementedError(f"light kinds {sorted(missing)} not ported")
    if any(img >= 0 for (_lid, img, _imp) in lights.infinite_meta):
        raise NotImplementedError("environment-mapped infinite lights are "
                                  "not ported")
    area = lights.kind == LIGHT_AREA
    if bool((area & (lights.area_geom_kind != AREA_GEOM_QUADRIC)).any()):
        raise NotImplementedError("area lights on triangle meshes or "
                                  "instanced objects are not ported")


def env_radiance(scene: SceneData, light_id, d_world):
    """Radiance of the infinite light `light_id` toward d_world (its
    constant L; other lanes 0)."""
    lights = scene.lights
    L = torch.zeros(d_world.shape[:-1] + (3,), dtype=torch.float32,
                    device=d_world.device)
    for (lid, _img, _imp) in lights.infinite_meta:
        L = torch.where((light_id == lid)[..., None],
                        lights.spectrum[lid].expand_as(L), L)
    return L


def le_escaped(scene: SceneData, d_world):
    """Sum of Le over all infinite lights for escaped rays
    (lights/infinite.cpp:83-95)."""
    lights = scene.lights
    L = torch.zeros(d_world.shape[:-1] + (3,), dtype=torch.float32,
                    device=d_world.device)
    for (lid, _img, _imp) in lights.infinite_meta:
        L = L + lights.spectrum[lid]
    return L


def is_delta(kind):
    """IsDeltaLight (core/light.h:60-65) among the ported kinds; `kind` is
    an int or an int tensor."""
    return (kind == LIGHT_POINT) | (kind == LIGHT_DISTANT)


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
    kind = lights.kind[light_id]
    I = lights.spectrum[light_id]
    light_pos = lights.l2w[:, :3, 3][light_id]

    # Distant: world direction stored in params[0:3].
    wi_dist = lights.params[light_id][..., 0:3]
    if LIGHT_POINT in lights.kinds_present:
        # Point: I / d^2 toward the light (tpuprt/lights/lights.py:
        # 221-224).
        to_l = light_pos - p
        d2 = torch.clamp(vm.length_sq(to_l), min=1e-12)
        wi_dist = torch.where((kind == LIGHT_POINT)[..., None],
                              to_l * torch.rsqrt(d2)[..., None], wi_dist)
        I = torch.where((kind == LIGHT_POINT)[..., None], I / d2[..., None],
                        I)

    # Infinite: cosine about n, hemisphere flip by u3.
    x, y = mc.concentric_sample_disk(u1, u2)
    z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=1e-12))
    z = torch.where(u3 < 0.5, -z, z)
    nf = vm.normalize(n)
    _, v1, v2 = vm.coordinate_system(nf)
    wi_inf = x[..., None] * v1 + y[..., None] * v2 + z[..., None] * nf
    pdf_inf = torch.abs(z) * mc.INV_TWOPI
    Li_inf = env_radiance(scene, light_id, wi_inf)

    delta = is_delta(kind)
    wi = torch.where(delta[..., None], wi_dist, wi_inf)
    Li = torch.where(delta[..., None], I, Li_inf)
    pdf = torch.where(delta, 1.0, pdf_inf)
    # The reference treats every delta light, distant included, as a
    # segment to the light's position (lights.py:398-402): a point light's
    # shadow ray ends short of it, and a distant light's at |l2w origin -
    # p|. Kept for parity.
    seg_target = light_pos
    seg = delta

    if LIGHT_AREA in lights.kinds_present:
        ps_a, ns_a, pdf_q, solid_angle = _sample_quadric(scene, light_id, p,
                                                         u1, u2)
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


def pdf(scene: SceneData, light_id, p, n, wi):
    """light->Pdf(p, n, wi) for the BSDF strategy's MIS weight: 0 for
    delta lights, |n.wi|/2pi for infinite lights (lights/infinite.cpp:
    117-120), the cone pdf of an area-light sphere (tpuprt/lights/
    lights.py:472-512). A disk's or cylinder's pdf needs the ray's hit on
    it: the caller takes pdf_area_from_hit for those."""
    lights = scene.lights
    kind = lights.kind[light_id]
    out = torch.where(kind == LIGHT_INFINITE,
                      vm.absdot(n, wi) * mc.INV_TWOPI, 0.0)
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
    area_id is -1."""
    L = scene.lights.spectrum[torch.clamp(area_id, min=0).long()]
    emits = (vm.dot(nn, w) > 0.0) & (area_id >= 0)
    return torch.where(emits[..., None], L, 0.0)


def power(scene: SceneData):
    """Light::Power of each light f32[L,3] (tpuprt/lights/lights.py:
    529-550): a point light's 4 pi I, an area light's L pi area, a distant
    or infinite light's L pi r^2 over the world's bounding sphere."""
    lights = scene.lights
    radius = 0.5 * vm.length(scene.world_bound_hi - scene.world_bound_lo)
    k = lights.kind[..., None]
    spec = lights.spectrum
    out = spec * (math.pi * radius * radius)
    out = torch.where(k == LIGHT_POINT, spec * (4.0 * math.pi), out)
    return torch.where(k == LIGHT_AREA, spec * (
        lights.area_total_area[..., None] * math.pi), out)
