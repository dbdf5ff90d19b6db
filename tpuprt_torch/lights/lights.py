"""Batched light sampling (port of tpuprt/lights/lights.py for distant
lights and infinite lights without an environment map).

Per-lane light ids index the LightTable; each kind's sample is computed
masked and selected, as in the reference:
  * distant (lights/distant.cpp:61-75),
  * infinite: cosine-weighted about the normal with a hemisphere flip and
    pdf |cos|/2pi (lights/infinite.cpp:96-120).
"""
from __future__ import annotations

import torch

from ..core import mc, vecmath as vm
from ..scene.data import LIGHT_DISTANT, LIGHT_INFINITE, SceneData

_BIG = 1e30
PORTED_KINDS = (LIGHT_DISTANT, LIGHT_INFINITE)


def check(lights):
    missing = set(lights.kinds_present) - set(PORTED_KINDS)
    if missing:
        raise NotImplementedError(f"light kinds {sorted(missing)} not ported")
    if any(img >= 0 for (_lid, img, _imp) in lights.infinite_meta):
        raise NotImplementedError("environment-mapped infinite lights are "
                                  "not ported")


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
    return kind == LIGHT_DISTANT


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
    # segment to the light's position (lights.py:398-402): a distant
    # light's shadow ray ends at |l2w origin - p|. Kept for parity.
    dist = torch.sqrt(torch.clamp(vm.length_sq(light_pos - p), min=1e-12))
    vis_maxt = torch.where(delta, dist * (1.0 - 1e-3), _BIG)
    return dict(Li=Li, wi=wi, pdf=pdf, delta=delta, vis_maxt=vis_maxt)


def pdf(scene: SceneData, light_id, p, n, wi):
    """light->Pdf(p, n, wi): 0 for delta lights, |n.wi|/2pi for infinite
    lights (lights/infinite.cpp:117-120)."""
    kind = scene.lights.kind[light_id]
    return torch.where(kind == LIGHT_INFINITE,
                       vm.absdot(n, wi) * mc.INV_TWOPI, 0.0)
