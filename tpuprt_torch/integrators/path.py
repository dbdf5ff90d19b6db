"""Path integrator, the scan form (port of tpuprt/integrators/path.py:
32-149; pbrt-v1 integrators/path.cpp:58-145) on a chunk of camera rays: at
each bounce the live lanes' nearest hit, Le on the first vertex and after
a specular bounce only (escaped rays' infinite lights and area lights
alike), one light sampled with MIS (common.direct_ld "one"), the full BSDF
continuation (purposes 20, 21) and Russian roulette with probability 0.5
from bounce 3 on. The live lanes are compacted after the hit and after
the continuation, which changes no sample's value. With volumes, each
segment after the camera's is attenuated by its transmittance (path.py:
53-64; the camera segment's is the driver's, render.compose_volumes). The
pool's mode "path" computes the same samples."""
from __future__ import annotations

import torch

from ..accel import intersect as isect
from ..bsdf import bsdf as B
from ..core import rng, vecmath as vm
from ..lights import lights as lt
from ..samplers import samplers as smp
from ..scene.data import SceneData
from ..utils.stats import span
from ..volumes import regions as vr
from . import common

SALT = 0xBA5E    # the per-pixel hash's salt (path.py:39)
RR_START = 3     # Russian roulette from this bounce on (path.cpp:135)


def li(scene: SceneData, o, d, mint, maxt, cfg, px, py, s_idx,
       max_depth: int = 5, seed: int = 0, rx=None, ry=None):
    """(L, alpha, t_first) of camera rays (o, d, mint, maxt) with ids (px,
    py, s_idx); rx, ry: the +x/+y differential rays (o, d) or None,
    applied at the first hit."""
    n, dev = o.shape[0], o.device
    ph = rng.hash_u32(px, py, seed, SALT)
    has_lights = scene.lights.count > 0
    L = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    alpha = torch.zeros(n, dtype=torch.float32, device=dev)
    t_first = maxt.clone()
    idx = torch.arange(n, device=dev)
    ro, rd, tp = o, d, torch.ones_like(o)
    specular = torch.zeros(n, dtype=torch.bool, device=dev)
    for bounce in range(max_depth + 1):
        first = bounce == 0
        live = torch.ones(ro.shape[0], dtype=torch.bool, device=dev)
        t, pid, hit = isect.intersect_ids(
            scene, ro, rd, *((mint, maxt) if first else
                             common.live_window(live)))
        if first:
            t_first = torch.where(hit, t, maxt)
        elif vr.present(scene.volumes):
            # The segment to the hit, or to the window's end on a miss.
            tp = tp * vr.transmittance(
                scene.volumes, ro, rd, torch.full_like(t, vm.RAY_EPSILON),
                torch.where(hit, t, 1e30),
                rng.uniform(ph[idx], s_idx[idx], bounce, 0x77))
        if scene.lights.infinite_meta:
            take_le = ~hit & (first | specular)
            Lesc = lt.le_escaped(scene, rd)
            L.index_add_(0, idx, torch.where(take_le[..., None], tp * Lesc,
                                             0.0))
            if first:
                alpha = torch.where(take_le & torch.any(Lesc > 0, -1), 1.0,
                                    alpha)
        with span("sync"):
            keep = torch.nonzero(hit).squeeze(1)
        if first:
            # index_fill_ takes 1.0 as a kernel argument, where an indexed
            # write would copy it from the host and wait for the device.
            alpha.index_fill_(0, keep, 1.0)
        idx, ro, rd, tp, t, pid, specular = (
            x[keep] for x in (idx, ro, rd, tp, t, pid, specular))
        if idx.numel() == 0:
            break
        live = live[keep]
        dg = isect.hit_geometry(scene, pid, ro, rd, t)
        if first and rx is not None:
            dg = isect.compute_differentials(
                dg, rx[0][idx], rx[1][idx], ry[0][idx], ry[1][idx], live)
        wo = -rd
        px_l, py_l, s_l, ph_l = px[idx], py[idx], s_idx[idx], ph[idx]
        if has_lights:
            Le = lt.area_emission(scene, dg["area_light"], dg["nn"], wo)
            L.index_add_(0, idx, torch.where((first | specular)[..., None],
                                             tp * Le, 0.0))
        bsdf = common.make_bsdf_at(scene, dg)
        p, ns = dg["p"], bsdf.nn
        if has_lights:
            with span("light"):
                L.index_add_(0, idx, tp * common.direct_ld(
                    scene, cfg, "one", None, p, ns, wo, bsdf, ph_l, px_l,
                    py_l, s_l, bounce, seed, live))
        if bounce >= max_depth:
            break
        c1, c2 = smp.integrator_2d(cfg, px_l, py_l, s_l, bounce, 20, seed)
        c3 = smp.integrator_1d(cfg, px_l, py_l, s_l, bounce, 21, seed)
        bs = B.sample_f(bsdf, wo, c1, c2, c3, B.ALL)
        cont = bs["valid"] & (bs["pdf"] > 0.0) & \
            ~torch.all(bs["f"] == 0.0, dim=-1)
        tp = tp * (bs["f"] * (vm.absdot(bs["wi"], ns) /
                              torch.clamp(bs["pdf"], min=1e-20))[..., None])
        # Russian roulette (path.cpp:135-142).
        if bounce >= RR_START:
            cont = cont & (rng.uniform(ph_l, s_l, bounce, 30) < 0.5)
            tp = tp / 0.5
        with span("sync"):
            keep = torch.nonzero(cont).squeeze(1)
        idx, ro, rd, tp = idx[keep], p[keep], bs["wi"][keep], tp[keep]
        specular = bs["specular"][keep]
        if idx.numel() == 0:
            break
    return L, alpha, t_first
