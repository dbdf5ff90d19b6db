"""Volume integrators: emission only and single scattering (port of
tpuprt/integrators/volume.py; pbrt-v1 integrators/emission.cpp and
single.cpp), as fixed-step marches over the ray's clip to the regions'
union box:

  * emission: Li = sum of Tr Lve dt (emission.cpp:60-95);
  * single: that plus, at each step, the in-scattered light of one light
    picked uniformly, Tr sigma_s p(w, w') Ld (single.cpp:57-116).

Each draw is keyed by (pixel hash, sample, step, purpose) with tpuprt's
purposes 0x70-0x75, so the steps are independent: the steps' points are
evaluated together, and the 32 steps' shadow rays go to the traversal in
one call. Only the running optical depth is summed step by step, in
tpuprt's order.
"""
from __future__ import annotations

import torch

from ..accel import intersect as isect
from ..core import mc, rng, vecmath as vm
from ..lights import lights as lt
from ..scene.data import SceneData
from ..volumes import regions as vr

_EPS = vm.RAY_EPSILON


def transmittance(scene: SceneData, o, d, mint, maxt, u):
    return vr.transmittance(scene.volumes, o, d, mint, maxt, u)


def _steps(vol, o, d, mint, maxt, u):
    """The march's points: (any, dt f32[N], points f32[S, N, 3], density
    f32[S*N, R]) for S = vr._MARCH_STEPS steps jittered by u."""
    t0, t1, any_hit = vr.segment(vol, o, d, mint, maxt)
    dt, tmids = vr.march(t0, t1, u)
    pts = o[None] + torch.stack(tmids)[..., None] * d[None]
    return any_hit, dt, pts, vr.density(vol, pts.reshape(-1, 3))


def _weighted(dens, coeff, shape):
    """sum over the regions of density x coeff f32[R, 3], as f32[S, N, 3]."""
    return torch.sum(dens[..., None] * coeff[None], dim=1).reshape(shape)


def _emission_terms(vol, dens, dt, shape):
    """Per step: (Tr to the step's midpoint, Tr Lve dt) f32[S, N, 3]; the
    optical depth accumulated step by step."""
    st = _weighted(dens, vol.sigma_a + vol.sigma_s, shape)
    le = _weighted(dens, vol.le, shape)
    tau_acc = torch.zeros(shape[1:], dtype=torch.float32,
                          device=dens.device)
    trs, ems = [], []
    for i in range(shape[0]):
        tau_acc = tau_acc + st[i] * dt[..., None]
        tr = torch.exp(-tau_acc)
        trs.append(tr)
        ems.append(tr * le[i] * dt[..., None])
    return trs, ems


def li_emission(scene: SceneData, o, d, mint, maxt, u_jitter):
    """Emission-only Li (emission.cpp:60-95)."""
    vol = scene.volumes
    if not vr.present(vol):
        return torch.zeros(o.shape[:-1] + (3,), dtype=torch.float32,
                           device=o.device)
    any_hit, dt, pts, dens = _steps(vol, o, d, mint, maxt, u_jitter)
    _, ems = _emission_terms(vol, dens, dt, pts.shape)
    L = torch.zeros_like(o)
    for e in ems:
        L = L + e
    return torch.where(any_hit[..., None], L, 0.0)


def li_single(scene: SceneData, o, d, mint, maxt, px_hash, s_idx, seed=0):
    """Single-scattering Li (single.cpp:57-116): at each step the emission
    and one light's in-scattered light, its shadow ray and its
    transmittance to the light, weighted by the Henyey-Greenstein phase of
    the density-weighted g."""
    vol = scene.volumes
    if not vr.present(vol) or scene.lights.count == 0:
        return li_emission(scene, o, d, mint, maxt,
                           rng.uniform(px_hash, s_idx, 0x70))
    n_lights = scene.lights.count
    u_jit = rng.uniform(px_hash, s_idx, 0x71)
    any_hit, dt, pts, dens = _steps(vol, o, d, mint, maxt, u_jit)
    S, N = pts.shape[0], pts.shape[1]
    trs, ems = _emission_terms(vol, dens, dt, pts.shape)
    # Every step's light sample, shadow ray and transmittance at once,
    # lanes step-major.
    rep = lambda x: x.repeat((S,) + (1,) * (x.dim() - 1))
    step = torch.arange(S, device=o.device).repeat_interleave(N)
    ph, si = rep(px_hash), rep(s_idx)
    u_n = rng.uniform(ph, si, step, 0x72)
    lid = torch.clamp((u_n * n_lights).to(torch.int32), max=n_lights - 1)
    p, dd = pts.reshape(-1, 3), rep(d)
    sm = lt.sample(scene, lid, p, -dd, rng.uniform(ph, si, step, 0x73),
                   rng.uniform(ph, si, step, 0x74),
                   rng.uniform(ph, si, step, 0x75))
    occ = isect.occluded(scene, p, sm["wi"], torch.full_like(u_n, _EPS),
                         sm["vis_maxt"])
    tr_light = vr.transmittance(vol, p, sm["wi"], torch.zeros_like(u_n),
                                sm["vis_maxt"], rep(u_jit))
    ss = _weighted(dens, vol.sigma_s, (S * N, 3))
    w = torch.sum(dens, dim=1)
    g = torch.sum(dens * vol.g[None], dim=1)
    g = torch.where(w > 0, g / torch.clamp(w, min=1e-9), 0.0)
    ph_val = mc.hg_pdf(vm.dot(-dd, sm["wi"]), g)
    ok = (~occ & (sm["pdf"] > 0)).reshape(S, N, 1)
    wgt = (ph_val * n_lights / torch.clamp(sm["pdf"], min=1e-12)).reshape(
        S, N, 1)
    ss, tr_light, Li = (x.reshape(S, N, 3) for x in (ss, tr_light, sm["Li"]))
    L = torch.zeros_like(o)
    for i in range(S):
        L = L + ems[i]
        contrib = trs[i] * ss[i] * wgt[i] * tr_light[i] * Li[i] * \
            dt[..., None]
        L = L + torch.where(ok[i], contrib, 0.0)
    return torch.where(any_hit[..., None], L, 0.0)
