"""Irradiance caching (port of tpuprt/integrators/irradiancecache.py;
irradiancecache.cpp:213-362).

tpuprt fills the cache up front, where the reference fills it lazily on a
miss:
- the probe pass (probe_points): camera rays through the centre of every
  probe_stride-th pixel, their first hit and the hits along one specular
  chain, each a probe where its BSDF has a diffuse or glossy lobe;
- the estimate (estimate_irradiance): nsamples cosine-distributed mini
  path traces a probe (the inner loop of irradiancecache.cpp:225-291:
  one light's direct lighting at every vertex, emission only after a
  specular bounce, maxindirectdepth vertices, Russian roulette after the
  fourth), E their mean times pi, maxDist the harmonic mean of the first
  hits' distances clamped to [0.001, 0.125] V^(1/3) times maxerror
  (irradiancecache.cpp:292-308);
- the probes in a PointGrid of cell maxDist's largest value.
li interpolates with the reference's weights (irradiancecache.cpp:
340-362) and falls back to the least-error sample where none qualifies
(tpuprt's documented divergence).

tpuprt scans the samples one after another over all probes. Here the
(sample, probe) pairs are the lanes, in blocks of samples sized from free
memory, and each probe's E and 1/d are summed in sample order. A probe's
streams hang on its index among the compacted probes (concatenated by
depth, then the invalid ones dropped).

The lookups read all 27 cells at each bucket slot (tpuprt's order when its
query count times 27 is at most 2^20): the least-error fallback keeps the
first least error in (slot, cell) order, a later slot replacing it only
when strictly less, at every width.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..accel import intersect as isect
from ..accel.photon_grid import (PointGrid, block_rows, build_point_grid,
                                 gather_points)
from ..bsdf import bsdf as B
from ..cameras import cameras as cam_mod
from ..core import mc, rng, vecmath as vm
from ..lights import lights as lt
from ..scene.data import SceneData, to_device
from . import common

_EPS = vm.RAY_EPSILON
# Bytes one mini-path lane holds at its peak (its hit record, BSDF, one
# light's samples and their rays).
_MINI_BYTES = 4096


class IrradParams(NamedTuple):
    """CreateSurfaceIntegrator's defaults (irradiancecache.cpp:363-370)."""
    maxerror: float = 0.2
    maxspeculardepth: int = 5
    maxindirectdepth: int = 3
    nsamples: int = 4096
    probe_stride: int = 4      # a probe every probe_stride-th pixel
    probe_depth: int = 2       # the first hit and the specular chain's


def mini_path_radiance(scene: SceneData, o, d, max_depth: int, ph, tag):
    """The estimate's path trace (irradiancecache.cpp:236-291; tpuprt
    irradiancecache.py:54-100) from o along d: (L f32[N, 3], the first
    hit's distance f32[N], 1e30 on a miss). Streams rng.uniform(ph, tag,
    depth, k)."""
    n, dev = o.shape[0], o.device
    L = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    tp = torch.ones((n, 3), dtype=torch.float32, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    spec = torch.zeros(n, dtype=torch.bool, device=dev)
    d_first = torch.full((n,), 1e30, dtype=torch.float32, device=dev)
    ro, rd = o, d
    for depth in range(max_depth):
        t, pid, hit = isect.intersect_ids(scene, ro, rd,
                                          *common.live_window(alive))
        if depth == 0:
            d_first = torch.where(hit, t, d_first)
        if scene.lights.infinite_meta:
            L = L + torch.where((~hit & alive)[..., None],
                                tp * lt.le_escaped(scene, rd), 0.0)
        alive = alive & hit
        dg = isect.hit_geometry(scene, pid, ro, rd, t)
        Le = lt.area_emission(scene, dg["area_light"], dg["nn"], -rd)
        L = L + torch.where((alive & spec)[..., None], tp * Le, 0.0)
        bsdf = common.make_bsdf_at(scene, dg)
        p, nrm = dg["p"], bsdf.nn
        u = [rng.uniform(ph, tag, depth, k) for k in range(10)]
        Ld = common.uniform_sample_one_light(scene, p, nrm, -rd, bsdf,
                                             *u[:7], alive)
        L = L + torch.where(alive[..., None], tp * Ld, 0.0)
        bs = B.sample_f(bsdf, -rd, *u[7:], B.ALL)
        ok = bs["valid"] & (bs["pdf"] > 0.0) & torch.any(bs["f"] > 0.0, -1)
        spec = bs["specular"]
        tp = torch.where(ok[..., None], tp * bs["f"] * (
            vm.absdot(bs["wi"], nrm) /
            torch.clamp(bs["pdf"], min=1e-20))[..., None], tp)
        cont = (depth <= 3) | (rng.uniform(ph, tag, depth, 0xEE) <= 0.5)
        if depth > 3:
            tp = torch.where(cont[..., None], tp * 2.0, tp)
        alive = alive & ok & cont & (depth + 1 < max_depth)
        ro, rd = p, bs["wi"]
    return L, d_first


def probe_points(scene: SceneData, prm: IrradParams, xres: int, yres: int,
                 seed: int = 0):
    """The probe pass (tpuprt irradiancecache.py:122-155): for each of
    probe_depth depths, the hit points, normals turned toward the ray's
    origin, and valid bool (a hit with a diffuse or glossy lobe), of the
    rays through the probe pixels' centres (x-major), concatenated by
    depth: f32[D * n, 3], f32[D * n, 3], bool[D * n]."""
    dev = scene.lights.kind.device
    stride = max(1, prm.probe_stride)
    PX, PY = np.meshgrid(np.arange(stride // 2, xres, stride),
                         np.arange(stride // 2, yres, stride), indexing="ij")
    px = torch.from_numpy(PX.reshape(-1).astype(np.int32)).to(dev)
    py = torch.from_numpy(PY.reshape(-1).astype(np.int32)).to(dev)
    ph = rng.hash_u32(px, py, seed, 0x1CAC)
    # The lens at its centre and the shutter at its opening
    # (irradiancecache.py:122-126).
    half = torch.full(px.shape, 0.5, dtype=torch.float32, device=dev)
    ro, rd, mint, maxt, _ = cam_mod.generate_rays(
        scene.camera, px.to(torch.float32) + 0.5,
        py.to(torch.float32) + 0.5, half, half, torch.zeros_like(half),
        xres, yres)
    alive = torch.ones(px.shape, dtype=torch.bool, device=dev)
    pts, nrms, valids = [], [], []
    for depth in range(prm.probe_depth):
        if depth:
            mint, maxt = common.live_window(alive)
        t, pid, hit = isect.intersect_ids(scene, ro, rd, mint, maxt)
        alive = alive & hit
        dg = isect.hit_geometry(scene, pid, ro, rd, t)
        bsdf = common.make_bsdf_at(scene, dg)
        ng = dg["nn"]
        ng = torch.where(vm.dot(-rd, ng)[..., None] < 0.0, -ng, ng)
        has_diffuse = B.num_components(bsdf, B.REFLECTION | B.TRANSMISSION |
                                       B.DIFFUSE | B.GLOSSY) > 0
        pts.append(dg["p"])
        nrms.append(ng)
        valids.append(alive & has_diffuse)
        bs = B.sample_f(bsdf, -rd, *(rng.uniform(ph, depth, k)
                                     for k in (0x51, 0x52, 0x53)),
                        B.SPECULAR | B.REFLECTION | B.TRANSMISSION)
        alive = alive & bs["valid"] & (bs["pdf"] > 0.0)
        ro, rd = dg["p"], bs["wi"]
    return torch.cat(pts), torch.cat(nrms), torch.cat(valids)


def estimate_irradiance(scene: SceneData, prm: IrradParams, pts, nrms,
                        seed: int = 0):
    """E f32[P, 3] and the harmonic-mean distance f32[P] at the compacted
    probes (tpuprt irradiancecache.py:171-197): probe i's sample s takes
    its directions from ld_shuffled_1d(s, hash(i, seed, 0x1E5), 0 and 1)
    and its path's streams from hash(that, s, 0x7)."""
    npr, dev = pts.shape[0], pts.device
    ns = max(4, prm.nsamples)
    phh = rng.hash_u32(torch.arange(npr, device=dev), seed, 0x1E5)
    _, v1, v2 = vm.coordinate_system(nrms)
    E = torch.zeros((npr, 3), dtype=torch.float32, device=dev)
    inv_d = torch.zeros(npr, dtype=torch.float32, device=dev)
    sb = max(1, block_rows(dev, _MINI_BYTES, 1 << 16) // npr)
    for s0 in range(0, ns, sb):
        nb = min(sb, ns - s0)
        s = torch.arange(s0, s0 + nb, device=dev).repeat_interleave(npr)
        phs = phh.repeat(nb)
        w = mc.cosine_sample_hemisphere(rng.ld_shuffled_1d(s, phs, 0),
                                        rng.ld_shuffled_1d(s, phs, 1))
        wd = w[..., 0:1] * v1.repeat(nb, 1) + w[..., 1:2] * v2.repeat(nb, 1) \
            + torch.abs(w[..., 2:3]) * nrms.repeat(nb, 1)
        L, d_first = mini_path_radiance(scene, pts.repeat(nb, 1), wd,
                                        prm.maxindirectdepth,
                                        rng.hash_u32(phs, s, 0x7), 0)
        L = L.view(nb, npr, 3)
        inv = (1.0 / torch.clamp(d_first, min=1e-6)).view(nb, npr)
        for k in range(nb):
            E = E + L[k]
            inv_d = inv_d + inv[k]
    E = E * (math.pi / ns)
    return E, torch.full_like(inv_d, float(ns)) / torch.clamp(inv_d,
                                                               min=1e-12)


def build_cache(scene: SceneData, prm: IrradParams, xres: int, yres: int,
                seed: int = 0, stats: dict = None) -> PointGrid:
    """The cache on the scene's device (tpuprt irradiancecache.py:103-203).
    stats, when given, receives the probes and the cell size."""
    dev = scene.lights.kind.device
    pts, nrms, valid = probe_points(scene, prm, xres, yres, seed)
    pts, nrms = pts[valid], nrms[valid]
    npr = pts.shape[0]
    wb = (scene.world_bound_hi - scene.world_bound_lo).cpu().numpy()
    vol_cbrt = float(np.abs(wb.prod())) ** (1.0 / 3.0)
    min_max, max_max = 0.001 * vol_cbrt, 0.125 * vol_cbrt
    if stats is not None:
        stats.update(probes=npr, probe_rays=int(valid.numel()))
    if npr == 0:
        z = np.zeros((0, 3), np.float32)
        return to_device(build_point_grid(z, (z, z, np.zeros(
            (0,), np.float32)), max(max_max * prm.maxerror, 1e-4)), dev)
    E, max_dist = estimate_irradiance(scene, prm, pts, nrms, seed)
    md = np.clip(max_dist.cpu().numpy(), min_max, max_max) * prm.maxerror
    cell = float(max(md.max(), 1e-4))
    if stats is not None:
        stats.update(cell=cell)
    return to_device(build_point_grid(
        pts.cpu().numpy(), (nrms.cpu().numpy(), E.cpu().numpy(),
                            md.astype(np.float32)), cell), dev)


def interpolate_irradiance(cache: PointGrid, p, n_shading, active):
    """E at points p f32[N, 3] with shading normals n_shading
    (irradiancecache.cpp:340-362; tpuprt irradiancecache.py:206-243), 0 on
    lanes not `active`: the (1 - err)^2-weighted mean over the samples with
    n.ni >= 0.01, d <= maxDist, in front and err = d / (maxDist n.ni) < 1;
    where none qualifies, the least-error sample's E."""
    zero3 = torch.zeros_like(p)
    if cache.count == 0:
        return zero3
    step = block_rows(p.device)
    out = []
    for a in range(0, p.shape[0], step):
        pb, nb = p[a:a + step], n_shading[a:a + step]
        pq, nq = pb[:, None, :], nb[:, None, :]

        def accum(carry, sp, payload, in_bucket):
            Ew, sw, bestE, bestErr = carry
            sn, sE, smax = payload
            ndot = vm.dot(nq, sn)
            d2 = vm.length_sq(sp - pq)
            front = vm.dot(pq - sp, sn + nq) >= -0.01
            ok = in_bucket & (ndot >= 0.01) & (d2 <= smax * smax) & front
            err = torch.sqrt(d2) / torch.clamp(smax * ndot, min=1e-12)
            e1 = 1.0 - err
            wt = torch.where(ok & (err < 1.0), e1 * e1, 0.0)
            Ew = Ew + (wt[..., None] * sE).sum(1)
            sw = sw + wt.sum(1)
            err_f = torch.where(in_bucket & (ndot >= 0.01) & front, err,
                                1e30)
            cand_err, jbest = err_f.min(1)
            cand_E = sE[torch.arange(sE.shape[0], device=sE.device), jbest]
            better = cand_err < bestErr
            return (Ew, sw, torch.where(better[..., None], cand_E, bestE),
                    torch.minimum(bestErr, cand_err))
        z = zero3[a:a + step]
        out.append(gather_points(cache, pb, accum, (
            z, z[:, 0], z, torch.full_like(z[:, 0], 1e30))))
    Ew, sw, bestE, bestErr = (torch.cat(x) for x in zip(*out))
    E = torch.where((sw > 0.0)[..., None],
                    Ew / torch.clamp(sw, min=1e-20)[..., None],
                    torch.where((bestErr < 1e29)[..., None], bestE, 0.0))
    return torch.where(active[..., None], E, 0.0)


def li(scene: SceneData, cache: PointGrid, o, d, mint, maxt, cfg, px, py,
       s_idx, max_depth: int = 5, seed: int = 0,
       prm: IrradParams = IrradParams(), rx=None, ry=None):
    """Li (irradiancecache.cpp:309-362; tpuprt irradiancecache.py:246-316)
    for a chunk of camera rays: all lights' direct lighting plus rho / pi
    times the interpolated irradiance on each side at every vertex of the
    specular chain. Returns (L, alpha, t_first)."""
    del cfg  # every stream is a hash
    ph = rng.hash_u32(px, py, seed, 0x1CA)
    inv_pi = 1.0 / math.pi

    def shade(depth, idx, ph_l, s_l, dg, bsdf, wo, tp):
        live = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
        p = dg["p"]
        Ld = common.uniform_sample_all_lights(
            scene, p, bsdf.nn, wo, bsdf,
            lambda i, k: rng.uniform2(ph_l, s_l, depth, i, k), live)
        # Indirect = rho / pi E(p, ng facing wo) (irradiancecache.cpp:
        # 190-202, 315), and through a transmitting lobe E behind.
        ng = dg["nn"]
        ng = torch.where(vm.dot(wo, ng)[..., None] < 0.0, -ng, ng)
        E = interpolate_irradiance(cache, p, ng, live)
        Lind = B.rho_approx(bsdf, B.REFLECTION | B.DIFFUSE | B.GLOSSY) * E \
            * inv_pi
        rho_t = B.rho_approx(bsdf, B.TRANSMISSION | B.DIFFUSE | B.GLOSSY)
        has_t = torch.any(rho_t > 0.0, -1)
        if bool(has_t.any()):
            Et = interpolate_irradiance(cache, p, -ng, has_t)
            Lind = Lind + rho_t * Et * inv_pi
        return tp * Ld, tp * Lind
    return common.scan_li(scene, o, d, mint, maxt, rx, ry, ph, s_idx,
                          max_depth + 1, max_depth, shade)
