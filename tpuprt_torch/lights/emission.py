"""Photon emission: Light::Sample_L(scene, u1..u4, ray, pdf) for a wavefront
(port of tpuprt/lights/emission.py). Per kind:

  point:       o = the light's position, d uniform over the sphere, pdf
               1/4pi, Le = I (point.cpp:70-77)
  spot:        d uniform in the cone of cos total width about the light's
               +z, the cone's pdf, Le = I x falloff (spot.cpp:87-95)
  projection:  the same in the cone through the screen window's corner
               (projection.cpp:122-128), Le = I x the projection factor
  goniometric: d uniform over the sphere, Le = I x its map (goniometric.cpp)
  distant:     o on the disk of the world's bounding sphere (radius r x
               1.01) across the light's direction, d = that direction, pdf
               1/(pi r^2) (distant.cpp:74-93)
  area:        a point on the sphere, disk, cylinder, triangle mesh or
               instanced prototype by area (a mesh's triangle picked by
               the fifth uniform; lights.sample_area_mesh), d
               uniform over the sphere and flipped to the normal's side, pdf
               (1/area) / 2pi (area.cpp:83-92)
  infinite:    the chord between two uniform points of the bounding sphere,
               pdf |cos| / (4 pi r^2), Le its radiance toward -d
               (infinite.cpp:132-154, infinitesample.cpp:193-215)
"""
from __future__ import annotations

import math

import torch

from ..core import mc, transform as tf, vecmath as vm
from ..scene.data import (AREA_GEOM_QUADRIC, LIGHT_AREA,
                          LIGHT_DISTANT, LIGHT_INFINITE,
                          LIGHT_PROJECTION, LIGHT_SPOT, QUADRIC_DISK,
                          QUADRIC_SPHERE, SceneData)
from . import lights as lt


def world_sphere(scene: SceneData):
    """(center f32[3], radius f32[]) of the world bound's sphere."""
    c = 0.5 * (scene.world_bound_lo + scene.world_bound_hi)
    return c, vm.length(scene.world_bound_hi - c)


def _sample_quadric_area(scene: SceneData, light_id, u1, u2):
    """Shape::Sample(u1, u2, &ns) of each lane's area-light quadric: a point
    uniform over its area and the normal there (orientation applied)."""
    q = scene.quadrics
    qid = torch.clamp(scene.lights.area_first[light_id], 0,
                      q.count - 1).long()
    center = q.o2w[:, :3, 3][qid]
    qkind = q.kind[qid]
    pq = q.params[qid]
    sph = mc.uniform_sample_sphere(u1, u2)
    ps_sph = center + pq[..., 0:1] * sph
    # Disk [height, radius, inner, phimax]: r from a lerp in r^2, uniform
    # over the annulus sector (disk.cpp:36-44); cylinder [radius, zmin,
    # zmax, phimax].
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
    ps_flat = tf.rows_apply_point(tf.row_components(q.o2w, qid),
                                  torch.where(is_disk, disk_ps, cyl_ps))
    ns_flat = vm.normalize(tf.rows_apply_normal(
        tf.row_components(q.w2o, qid), torch.where(is_disk, disk_ns, cyl_ns)))
    sphere = (qkind == QUADRIC_SPHERE)[..., None]
    ps = torch.where(sphere, ps_sph, ps_flat)
    ns = torch.where(sphere, sph, ns_flat) * q.flip_normal[qid][..., None]
    return ps, ns


def sample_emission(scene: SceneData, light_id, u1, u2, u3, u4, u5):
    """A photon ray leaving light `light_id` (i32[N]): dict(o, d, pdf, Le).
    u5 picks a mesh emitter's triangle (the RandomFloat() inside
    ShapeSet::Sample, core/shape.h:121-127)."""
    lights = scene.lights
    kind = lights.kind[light_id]
    kp = lights.kinds_present
    o = lights.l2w[:, :3, 3][light_id]
    d = mc.uniform_sample_sphere(u1, u2)
    pdf = torch.full(u1.shape, mc.uniform_sphere_pdf(), dtype=torch.float32,
                     device=u1.device)
    Le = lights.spectrum[light_id]
    c, r = world_sphere(scene)
    r = r * 1.01

    if LIGHT_SPOT in kp or LIGHT_PROJECTION in kp:
        # A cone about the light's +z: a spot light's total width, a
        # projection light's through the screen window's corner
        # (projection.cpp:86-92).
        p = lights.params[light_id]
        tan_x = torch.maximum(torch.abs(p[..., 4]), torch.abs(p[..., 5])) / \
            torch.clamp(p[..., 0], min=1e-8)
        tan_y = torch.maximum(torch.abs(p[..., 6]), torch.abs(p[..., 7])) / \
            torch.clamp(p[..., 1], min=1e-8)
        cos_w = torch.where(
            kind == LIGHT_PROJECTION,
            1.0 / torch.sqrt(1.0 + tan_x * tan_x + tan_y * tan_y),
            p[..., 0])
        d_cone = vm.normalize(tf.rows_apply_vector(
            tf.row_components(lights.l2w, light_id),
            mc.uniform_sample_cone(u1, u2, cos_w)))
        sel = (kind == LIGHT_SPOT) | (kind == LIGHT_PROJECTION)
        d = torch.where(sel[..., None], d_cone, d)
        pdf = torch.where(sel, mc.uniform_cone_pdf(cos_w), pdf)

    if any(k in kp for k in lt.DIRECTIONAL_KINDS):
        Le = Le * torch.where(lt.is_directional(kind)[..., None],
                              lt._projection_factor(scene, light_id, d), 1.0)

    if LIGHT_DISTANT in kp:
        edir = -lights.params[light_id][..., 0:3]      # emission direction
        _, v1, v2 = vm.coordinate_system(vm.normalize(edir))
        d1, d2 = mc.concentric_sample_disk(u1, u2)
        pdisk = c + r * (d1[..., None] * v1 + d2[..., None] * v2)
        sel = kind == LIGHT_DISTANT
        o = torch.where(sel[..., None], pdisk - r * edir, o)
        d = torch.where(sel[..., None], edir, d)
        pdf = torch.where(sel, 1.0 / (math.pi * r * r), pdf)

    if LIGHT_AREA in kp:
        geoms = lights.area_geoms_present
        if AREA_GEOM_QUADRIC in geoms:
            ps, ns = _sample_quadric_area(scene, light_id, u1, u2)
        else:
            ps, ns = o, torch.zeros_like(o)
        ps, ns = lt.sample_area_mesh(scene, light_id, u1, u2, u5, ps, ns)
        da = mc.uniform_sample_sphere(u3, u4)
        da = torch.where(vm.dot(da, ns)[..., None] < 0.0, -da, da)
        sel = kind == LIGHT_AREA
        o = torch.where(sel[..., None], ps, o)
        d = torch.where(sel[..., None], da, d)
        pdf = torch.where(sel, mc.INV_TWOPI / torch.clamp(
            lights.area_total_area[light_id], min=1e-12), pdf)

    if LIGHT_INFINITE in kp:
        p1 = c + r * mc.uniform_sample_sphere(u1, u2)
        p2 = c + r * mc.uniform_sample_sphere(u3, u4)
        di = vm.normalize(p2 - p1)
        costheta = vm.absdot(vm.normalize(c - p1), di)
        sel = kind == LIGHT_INFINITE
        o = torch.where(sel[..., None], p1, o)
        d = torch.where(sel[..., None], di, d)
        pdf = torch.where(sel, costheta / (4.0 * math.pi * r * r), pdf)
        Le = torch.where(sel[..., None],
                         lt.env_radiance(scene, light_id, -di), Le)
    return dict(o=o, d=d, pdf=pdf, Le=Le)


def pick_light_uniform(scene: SceneData, u):
    """lightNum = min(floor(nLights u), n - 1), pdf 1/n
    (photonmap.cpp:186-190)."""
    n = scene.lights.count
    return torch.clamp((u * n).to(torch.int32), max=n - 1), 1.0 / n
