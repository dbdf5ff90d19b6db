"""Extended photon mapping (port of tpuprt/integrators/exphotonmap.py;
exphotonmap.cpp).

- build_aux (the preprocess, exphotonmap.cpp:295-492): the three photon
  maps and the radiance photons (photonmap.build_maps with
  collect_radiance), each radiance photon's Lo = E(+n) rho_r / pi +
  E(-n) rho_t / pi from Epanechnikov-kernel irradiance estimates over the
  three maps (_estimate_e, exphotonmap.cpp:464-489), kept in a PointGrid
  of radius 4 x maxdist.
- li (exphotonmap.cpp:494-707): emission, all lights' direct lighting,
  the caustic map's kernel estimate, and the two-strategy final gather:
  gather rays from the BSDF and from cones around the directions of the
  indirect photons near the point, combined by the power heuristic; at a
  gather ray's hit the nearest same-side radiance photon within the grid's
  radius gives Lo. Then the specular-only continuation (common.scan_li).

tpuprt's redesigns are kept: the in-radius indirect photons stand for the
reference's nearest 50 (the cone direction comes from a uniform draw among
them by reservoir sampling, the cone pdf averages over them), and the
radiance lookup is nearest within the grid's radius.

The reservoir draw is one pass here, where tpuprt steps through every
(bucket slot, cell) in turn: the candidates in slot-major, then cell order,
the running count their cumulative sum (exact: small integers in f32),
candidate k taken where u_k count_k < 1 with u_k = rng.uniform(ph, s_idx,
depth, gather sample, slot * 32 + cell, 0x9E), and the draw the last one
taken: what the sequential loop keeps. The cells are numbered 0..26 at
every query width, as tpuprt numbers them whenever its query count times
27 is at most 2^20 (always in its own renders, whose chunk it caps at
4096 lanes). The final gather runs a lane per (ray, gather sample) for
as many samples at once as free memory takes, each lane's contributions
added in sample order; the lookups run in blocks of points.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..accel import intersect as isect
from ..accel.photon_grid import (PhotonGrid, PointGrid, build_point_grid,
                                 block_rows, gather_photons, gather_points)
from ..bsdf import bsdf as B
from ..core import mc, rng, vecmath as vm
from ..scene.data import SceneData, to_device
from . import common
from .photonmap import (GLOSSY_LOBE_KINDS, PhotonMaps, PhotonParams,
                        build_maps, gather_width, lphoton)

# Bytes one query point's reservoir draw holds per candidate (its mask,
# direction, count and the stream's hash temporaries).
_CAND_BYTES = 64


class ExPhotonParams(NamedTuple):
    """CreateSurfaceIntegrator's defaults (exphotonmap.cpp:709-727)."""
    caustic: int = 20000
    indirect: int = 100000
    direct: int = 100000
    max_dist: float = 0.1
    final_gather: bool = True
    gather_samples: int = 32
    gather_angle: float = 10.0          # degrees
    max_specular_depth: int = 5
    shoot_depth: int = 8
    batch: int = 16384
    max_shot: int = 500000


@dataclasses.dataclass
class ExPhotonAux:
    """The preprocess's state: the maps, the radiance photons' grid
    (payload: normal f32[N, 3], Lo f32[N, 3]) and cos(gatherangle) f32[]."""
    maps: PhotonMaps = None
    radiance: PointGrid = None
    cos_gather: torch.Tensor = None


def _kernel(grid: PhotonGrid, device):
    """The Epanechnikov-style kernel 3 / (pi md2) (1 - d2 / md2)^2 of
    exphotonmap.cpp:70-75, md2 = radius^2, as a function of d2 (tpuprt's
    f32 constants; md2 a tensor, so the card divides as the CPU does)."""
    md2 = np.float32(grid.radius * grid.radius)
    c = float(np.float32(3.0) / (np.float32(math.pi) * md2))
    md2_t = torch.tensor(float(md2), dtype=torch.float32, device=device)

    def k(d2):
        s = 1.0 - d2 / md2_t
        return c * s * s
    return k


def _blocks(p, *rest, step=None):
    """Slices of query points p (and of per-point tensors `rest`) in blocks
    of block_rows' size, or `step`."""
    step = step or block_rows(p.device)
    for a in range(0, p.shape[0], step):
        yield (p[a:a + step],) + tuple(x[a:a + step] for x in rest)


def _estimate_e(grid: PhotonGrid, p, n):
    """estimateE (exphotonmap.cpp:464-489): the kernel-weighted power of
    the photons within the radius whose arrival direction lies on n's
    side, over n_paths, f32[N, 3]."""
    zero3 = torch.zeros_like(p)
    if grid.count == 0:
        return zero3
    kern = _kernel(grid, p.device)
    out = []
    for pb, nb in _blocks(p, n):
        nq = nb[:, None, :]

        def accum(E, wi_b, alpha_b, w, d2):
            ok = w & (vm.dot(wi_b, nq) > 0.0)
            return E + torch.where(ok[..., None], alpha_b * kern(d2)[
                ..., None], 0.0).sum(1)
        out.append(gather_photons(grid, pb, accum, torch.zeros_like(pb),
                                  with_d2=True))
    return torch.cat(out) / grid.n_paths


def radiance_lo(maps: PhotonMaps, p, n, rho_r, rho_t):
    """The radiance photons' outgoing radiance (exphotonmap.cpp:464-489;
    tpuprt exphotonmap.py:90-119): E(+n) rho_r / pi + E(-n) rho_t / pi,
    each E the sum of the direct, indirect and caustic maps' kernel
    estimates, f32[R, 3]."""
    inv_pi = 1.0 / math.pi
    E_f = _estimate_e(maps.direct, p, n) + \
        _estimate_e(maps.indirect, p, n) + _estimate_e(maps.caustic, p, n)
    E_b = _estimate_e(maps.direct, p, -n) + \
        _estimate_e(maps.indirect, p, -n) + _estimate_e(maps.caustic, p, -n)
    return E_f * inv_pi * rho_r + E_b * inv_pi * rho_t


def build_aux(scene: SceneData, prm: ExPhotonParams, seed: int = 0,
              stats: dict = None) -> ExPhotonAux:
    """The preprocess (tpuprt exphotonmap.py:72-129) on the scene's device;
    stats as photonmap.build_maps fills it, with the radiance photons'
    count."""
    dev = scene.lights.kind.device
    pp = PhotonParams(caustic=prm.caustic, direct=prm.direct,
                      indirect=prm.indirect, max_dist=prm.max_dist,
                      shoot_depth=prm.shoot_depth, batch=prm.batch,
                      max_shot=prm.max_shot)
    maps, rad = build_maps(scene, pp, seed, stats=stats,
                           collect_radiance=True)
    Lo = radiance_lo(maps, *(torch.from_numpy(rad[k]).to(dev)
                             for k in ("p", "n", "rho_r", "rho_t")))
    if stats is not None:
        stats.update(radiance_photons=len(rad["p"]))
    radiance = build_point_grid(rad["p"], (rad["n"], Lo.cpu().numpy()),
                                radius=prm.max_dist * 4.0)
    return ExPhotonAux(maps=maps, radiance=to_device(radiance, dev),
                       cos_gather=torch.tensor(
                           math.cos(math.radians(prm.gather_angle)),
                           dtype=torch.float32, device=dev))


def _radiance_lookup(grid: PointGrid, p, ng):
    """The nearest radiance photon within the grid's radius whose normal
    lies on ng's side: its Lo, else 0 (RadiancePhotonProcess,
    exphotonmap.cpp:53-69). The first least distance in (slot, cell)
    order wins; a later slot only when strictly nearer."""
    zero3 = torch.zeros_like(p)
    if grid.count == 0:
        return zero3
    r2 = float(np.float32(grid.radius * grid.radius))
    out = []
    for pb, nb in _blocks(p, ng):
        pq, nq = pb[:, None, :], nb[:, None, :]

        def accum(carry, pp, payload, in_bucket):
            best_d2, best_lo = carry
            n_b, lo_b = payload
            d2 = vm.length_sq(pp - pq)
            ok = in_bucket & (vm.dot(n_b, nq) > 0.0) & (d2 < r2)
            cand_d2, j = torch.where(ok, d2, 1e30).min(-1)
            cand_lo = lo_b[torch.arange(j.shape[0], device=j.device), j]
            upd = cand_d2 < best_d2
            return (torch.where(upd, cand_d2, best_d2),
                    torch.where(upd[..., None], cand_lo, best_lo))
        out.append(gather_points(grid, pb, accum, (
            torch.full_like(pb[:, 0], 1e30), torch.zeros_like(pb)))[1])
    return torch.cat(out)


def _photon_dir_pdf(grid: PhotonGrid, p, wi, cos_ga):
    """The photon-cone distribution's pdf at wi (exphotonmap.cpp:570-577):
    UniformConePdf(cos_ga) times the share of the in-radius photons whose
    direction lies within the cone around wi; (pdf f32[N], photons f32[N])."""
    cone_pdf = mc.uniform_cone_pdf(cos_ga)
    zero = torch.zeros_like(p[:, 0])
    if grid.count == 0:
        return zero, zero
    lim = 0.999 * cos_ga
    out = []
    for pb, wb in _blocks(p, wi):
        wq = wb[:, None, :]

        def accum(carry, wi_b, _alpha_b, w):
            aligned, total = carry
            a = w & (vm.dot(wi_b, wq) > lim)
            return (aligned + a.to(torch.float32).sum(-1),
                    total + w.to(torch.float32).sum(-1))
        z = torch.zeros_like(pb[:, 0])
        out.append(gather_photons(grid, pb, accum, (z, z)))
    aligned, total = (torch.cat(x) for x in zip(*out))
    return torch.where(total > 0, cone_pdf * aligned /
                       torch.clamp(total, min=1.0), 0.0), total


def _reservoir_photon_dir(grid: PhotonGrid, p, ph, s_idx, depth: int, gi):
    """A uniform draw among the in-radius photons' arrival directions by
    reservoir sampling (exphotonmap.cpp:588-596, tpuprt exphotonmap.py:
    180-203), in one pass (module docstring); gi: the lanes' gather sample
    indices. Returns (direction f32[N, 3], found bool[N])."""
    dirs = torch.zeros_like(p)
    found = torch.zeros(p.shape[0], dtype=torch.bool, device=p.device)
    if grid.count == 0 or grid.bucket_cap == 0:
        return dirs, found
    n_cand = grid.bucket_cap * 27
    step = block_rows(p.device, n_cand * _CAND_BYTES, 1 << 12)
    out = []
    for pb, phb, sb, gb in _blocks(p, ph, s_idx, gi, step=step):
        def accum(carry, wi_b, _alpha_b, w):
            return carry + [(wi_b, w)]
        got = gather_photons(grid, pb, accum, [])
        wi_all = torch.stack([x[0] for x in got], 1).flatten(1, 2)
        w = torch.stack([x[1] for x in got], 1).flatten(1)   # [b, slot*27]
        cnt = torch.cumsum(w.to(torch.float32), 1)
        lane, k = torch.nonzero(w, as_tuple=True)
        u = rng.uniform(phb[lane], sb[lane], depth, gb[lane],
                        (k // 27) * 32 + k % 27, 0x9E)
        take = u * cnt[lane, k] < 1.0
        last = torch.full((pb.shape[0],), -1, dtype=torch.int64,
                          device=p.device)
        last.scatter_reduce_(0, lane[take], k[take], "amax")
        sel = wi_all[torch.arange(pb.shape[0], device=p.device),
                     last.clamp(min=0)]
        out.append((torch.where((last >= 0)[..., None], sel, 0.0),
                    cnt[:, -1] > 0))
    dirs, found = (torch.cat(x) for x in zip(*out))
    return dirs, found


def lphoton_kernel(grid: PhotonGrid, bsdf, wo, p, active,
                   may_glossy: bool = True):
    """LPhoton with the Epanechnikov kernel (exphotonmap.cpp:70-75,
    200-245) in place of photonmap's flat 1 / (pi r^2): kernel-weighted
    flux sums per hemisphere times rho on diffuse lanes, the per-photon f
    on glossy ones (none when the scene has no glossy lobe kind); 0 on
    lanes not `active`."""
    zero3 = torch.zeros_like(p)
    if grid.count == 0:
        return zero3
    kern = _kernel(grid, p.device)
    nf = torch.where(vm.dot(wo, bsdf.nn)[..., None] < 0.0, -bsdf.nn,
                     bsdf.nn)
    step = block_rows(p.device) // (8 if may_glossy else 1)
    sums = []
    for a in range(0, p.shape[0], step):
        sl = slice(a, a + step)
        nf_b = nf[sl][:, None, :]
        if may_glossy:
            bsdf_b = common.map_bsdf(bsdf, lambda x: x[sl][:, None])
            wo_b = wo[sl][:, None, :]

        def accum(carry, wi_b, alpha_b, w, d2):
            Lr, Lt, Lg = carry
            ka = alpha_b * kern(d2)[..., None]
            front = vm.dot(wi_b, nf_b) > 0.0
            Lr = Lr + torch.where((w & front)[..., None], ka, 0.0).sum(1)
            Lt = Lt + torch.where((w & ~front)[..., None], ka, 0.0).sum(1)
            if may_glossy:
                Lg = Lg + torch.where(w[..., None], B.f(bsdf_b, wo_b, wi_b)
                                      * ka, 0.0).sum(1)
            return Lr, Lt, Lg
        z = zero3[sl]
        sums.append(gather_photons(grid, p[sl], accum, (z, z, z),
                                   with_d2=True))
    Lr, Lt, Lg = (torch.cat(x) for x in zip(*sums))
    L = (Lr * B.rho_approx(bsdf, B.ALL_REFLECTION) +
         Lt * B.rho_approx(bsdf, B.ALL_TRANSMISSION)) / math.pi
    if may_glossy:
        glossy = B.num_components(
            bsdf, B.REFLECTION | B.TRANSMISSION | B.GLOSSY) > 0
        L = torch.where(glossy[..., None], Lg, L)
    return torch.where(active[..., None], L / grid.n_paths, 0.0)


def _at_hits(scene, aux: ExPhotonAux, ok, pid, o, wi, t):
    """Lo f32[N, 3] of the nearest radiance photon at the `ok` lanes' hits
    (the normal turned against wi), 0 elsewhere."""
    Lind = torch.zeros_like(o)
    sel = torch.nonzero(ok).squeeze(1)
    if sel.numel():
        dg = isect.hit_geometry_light(scene, pid[sel], o[sel], wi[sel],
                                      t[sel])
        ng = torch.where(vm.dot(dg["nn"], wi[sel])[..., None] > 0,
                         -dg["nn"], dg["nn"])
        Lind[sel] = _radiance_lookup(aux.radiance, dg["p"], ng)
    return Lind


def final_gather(scene: SceneData, aux: ExPhotonAux, bsdf, wo, p, ns, ph,
                 s_idx, depth: int, gs: int):
    """The two-strategy final gather (exphotonmap.cpp:517-634; tpuprt
    exphotonmap.py:284-357): the sum over gather samples g of the BSDF
    strategy's and the photon-cone strategy's MIS-weighted contributions,
    streams rng.uniform(ph, s_idx, depth, g, 0x61..0x63, 0x72, 0x73),
    f32[N, 3] (before the 1 / gs)."""
    n, dev = p.shape[0], p.device
    ind, cos_ga = aux.maps.indirect, aux.cos_gather
    acc = torch.zeros_like(p)
    if n == 0:
        return acc
    Gb = gather_width(n, gs, dev)

    def rep(x):
        return x.repeat_interleave(Gb, 0)
    bsdfG = common.map_bsdf(bsdf, rep)
    phG, sG, woG, pG, nsG = rep(ph), rep(s_idx), rep(wo), rep(p), rep(ns)
    g_base = torch.arange(Gb, dtype=torch.int32, device=dev).repeat(n)
    for blk in range(gs // Gb):
        gi = g_base + blk * Gb
        # Strategy 1: a BSDF-sampled gather ray (exphotonmap.cpp:544-583).
        bs = B.sample_f(bsdfG, woG, *(rng.uniform(phG, sG, depth, gi, k)
                                      for k in (0x61, 0x62, 0x63)),
                        B.ALL & ~B.SPECULAR)
        ok1 = bs["valid"] & (bs["pdf"] > 0.0) & torch.any(bs["f"] > 0.0, -1)
        t1, pid1, hit1 = isect.intersect_ids(scene, pG, bs["wi"],
                                             *common.live_window(ok1))
        ok1 = ok1 & hit1
        Lind1 = _at_hits(scene, aux, ok1, pid1, pG, bs["wi"], t1)
        ppdf1 = torch.zeros_like(t1)
        sel = torch.nonzero(ok1).squeeze(1)
        ppdf1[sel] = _photon_dir_pdf(ind, pG[sel], bs["wi"][sel], cos_ga)[0]
        wt1 = mc.power_heuristic(gs, bs["pdf"], gs, ppdf1)
        c1 = bs["f"] * Lind1 * (vm.absdot(bs["wi"], nsG) * wt1 / torch.clamp(
            bs["pdf"], min=1e-20))[..., None]
        # Strategy 2: a ray in a cone around a nearby indirect photon's
        # direction (exphotonmap.cpp:585-634).
        pdir, has_p = _reservoir_photon_dir(ind, pG, phG, sG, depth, gi)
        _, vx, vy = vm.coordinate_system(pdir)
        wi2 = mc.uniform_sample_cone_frame(
            rng.uniform(phG, sG, depth, gi, 0x72),
            rng.uniform(phG, sG, depth, gi, 0x73), cos_ga, vx, vy, pdir)
        f2 = B.f(bsdfG, woG, wi2)
        ppdf2 = torch.zeros_like(t1)
        sel = torch.nonzero(has_p).squeeze(1)
        ppdf2[sel] = _photon_dir_pdf(ind, pG[sel], wi2[sel], cos_ga)[0]
        ok2 = has_p & (ppdf2 > 0.0) & torch.any(f2 > 0.0, -1)
        t2, pid2, hit2 = isect.intersect_ids(scene, pG, wi2,
                                             *common.live_window(ok2))
        ok2 = ok2 & hit2
        Lind2 = _at_hits(scene, aux, ok2, pid2, pG, wi2, t2)
        wt2 = mc.power_heuristic(gs, ppdf2, gs, B.pdf(
            bsdfG, woG, wi2, B.ALL & ~B.SPECULAR))
        c2 = f2 * Lind2 * (vm.absdot(wi2, nsG) * wt2 / torch.clamp(
            ppdf2, min=1e-20))[..., None]
        c1 = torch.where(ok1[..., None], c1, 0.0).view(n, Gb, 3)
        c2 = torch.where(ok2[..., None], c2, 0.0).view(n, Gb, 3)
        for g in range(Gb):
            acc = acc + c1[:, g]
            acc = acc + c2[:, g]
    return acc


def li(scene: SceneData, aux: ExPhotonAux, o, d, mint, maxt, cfg, px, py,
       s_idx, max_depth: int = 5, seed: int = 0,
       prm: ExPhotonParams = ExPhotonParams(), rx=None, ry=None):
    """Li (exphotonmap.cpp:494-707; tpuprt exphotonmap.py:247-383) for a
    chunk of camera rays: (L, alpha, t_first)."""
    del cfg  # every stream is a hash
    ph = rng.hash_u32(px, py, seed, 0xE9B)
    mg = any(k in GLOSSY_LOBE_KINDS for k in scene.materials.lobe_kinds)
    maps, gs = aux.maps, prm.gather_samples
    gather = prm.final_gather and maps.indirect.count > 0 and \
        aux.radiance.count > 0

    def shade(depth, idx, ph_l, s_l, dg, bsdf, wo, tp):
        live = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
        p, ns = dg["p"], bsdf.nn
        Ld = common.uniform_sample_all_lights(
            scene, p, ns, wo, bsdf,
            lambda i, k: rng.uniform2(ph_l, s_l, depth, i, k), live)
        Lc = lphoton_kernel(maps.caustic, bsdf, wo, p, live, may_glossy=mg)
        if gather:
            Lg = final_gather(scene, aux, bsdf, wo, p, ns, ph_l, s_l, depth,
                              gs)
            return tp * Ld, tp * Lc, tp * Lg / float(gs)
        return tp * Ld, tp * Lc, tp * lphoton(maps.indirect, bsdf, wo, p,
                                              live, may_glossy=mg)
    return common.scan_li(scene, o, d, mint, maxt, rx, ry, ph, s_idx,
                          min(max_depth, prm.max_specular_depth) + 1,
                          prm.max_specular_depth, shade)
