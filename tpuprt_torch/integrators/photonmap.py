"""Photon mapping (port of tpuprt/integrators/photonmap.py: PhotonParams,
PhotonMaps, shoot_batch, build_maps, lphoton and photon_radiance;
photonmap.cpp).

- Shooting (photonmap.cpp:147-298): batches of photon paths, path i's
  emission from radical inverses of its global id i + 1 (bases 2, 3, 5, 7
  and 11 for the light), its bounces from hash streams of that id; a
  path deposits at each non-specular hit: the first hit into the direct
  map, an all-specular prefix into the caustic map, else the indirect
  map. The host keeps shooting until each map reaches its target,
  exactly as tpuprt's loop does, so the two packages keep the same
  photons.
- Storage: the grid-hash buckets of accel/photon_grid.py.
- LPhoton (photonmap.cpp:433-483): the fixed-radius estimate sum f(wo,
  wi_p) alpha_p / (n_paths pi r^2), with the reference's diffuse
  shortcut (flux sums per hemisphere, one rho multiply outside) and the
  per-photon f only where a lane has a glossy lobe, skipped when the
  scene has no glossy lobe kind.
- photon_radiance: Li's non-recursive core (photonmap.cpp:315-364): all
  lights' direct lighting (or the direct map), the caustic map, and the
  indirect map or the final gather; the pool's mode "photonmap" calls it
  at every vertex (integrators/path_wavefront.py), and so does li, the
  scan form of the chunked driver (photonmap.py:469-528).

The gather's width (lanes x
gather samples at once) and the lookup's point blocks are sized from the
device's free memory; tpuprt's TPU caps on both change no result, as every
stream is keyed by (pixel, sample, depth, gather index).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import NamedTuple

import numpy as np
import torch

from ..accel import intersect as isect
from ..accel.photon_grid import (PhotonGrid, build_photon_grid,
                                 gather_photons, block_rows)
from ..bsdf import bsdf as B
from ..core import rng, vecmath as vm
from ..lights import emission
from ..scene.data import SceneData
from ..volumes import regions as vr
from . import common

_EPS = vm.RAY_EPSILON
MAPS = ("direct", "caustic", "indirect")     # classes 0, 1, 2
GLOSSY_LOBE_KINDS = (B.BX_MICROFACET, B.BX_FRESNELBLEND)
# Gather lanes (rays x gather samples at once) a gigabyte of free device
# memory takes: a lane's rays, hit record, BSDF and photon lookups hold
# a few kilobytes of temporaries.
_GATHER_LANES_PER_GB = 1 << 17


class PhotonParams(NamedTuple):
    """CreateSurfaceIntegrator's defaults (photonmap.cpp:511-524); the
    parser reads finalgather as true when a file leaves it out."""
    caustic: int = 20000
    direct: int = 100000
    indirect: int = 100000
    max_dist: float = 0.1
    final_gather: bool = False
    gather_samples: int = 32
    direct_with_photons: bool = False
    shoot_depth: int = 8          # bounces a photon path may take
    batch: int = 65536            # paths per shooting batch
    max_shot: int = 500000


@dataclasses.dataclass
class PhotonMaps:
    caustic: PhotonGrid
    direct: PhotonGrid
    indirect: PhotonGrid


# ---------------------------------------------------------------------------
# Shooting (Preprocess)
# ---------------------------------------------------------------------------

def shoot_batch(scene: SceneData, base: int, n: int, depth_bound: int,
                seed: int, radiance: bool = False):
    """Trace photon paths base .. base + n - 1 on the scene's device.
    Returns per-depth stacked tensors [D, n]: pos, wi (toward where the
    photon came from), alpha, cls (0 direct, 1 caustic, 2 indirect) and
    valid (a deposit); with `radiance` also exphotonmap's radiance-photon
    candidates (photonmap.py:121-127, exphotonmap.cpp:410-421): the hit's
    normal turned against the photon's direction, rho_r and rho_t (the
    reflected and transmitted rho), and the pick, probability 1/8 by the
    path's stream rng.uniform(ph, depth, 0xAD)."""
    dev = scene.lights.kind.device
    idx = torch.arange(n, dtype=torch.int64, device=dev) + (base + 1)
    u = [rng.radical_inverse(idx, b) for b in (2, 3, 5, 7, 11)]
    ph = rng.hash_u32(idx, seed, 0x9107)
    lid, light_pdf = emission.pick_light_uniform(scene, u[4])
    # The mesh emitter's triangle pick (photonmap.py:94).
    em = emission.sample_emission(scene, lid, *u[:4],
                                  rng.uniform(ph, 0, 0x51))
    alpha = em["Le"] / torch.clamp(em["pdf"] * light_pdf,
                                   min=1e-20)[..., None]
    alive = (em["pdf"] > 0.0) & torch.any(alpha > 0.0, -1)
    o, d = em["o"], em["d"]
    spec_path = torch.zeros(n, dtype=torch.bool, device=dev)
    mint = torch.full((n,), _EPS, dtype=torch.float32, device=dev)
    maxt = torch.full((n,), 1e30, dtype=torch.float32, device=dev)
    outs = []
    for depth in range(depth_bound):
        t, pid, hit = isect.intersect_ids(scene, o, d, mint, maxt)
        alive = alive & hit
        dg = isect.hit_geometry(scene, pid, o, d, t)
        if vr.present(scene.volumes):
            # The photon's power attenuated along the segment
            # (photonmap.py:109-114).
            alpha = alpha * vr.transmittance(
                scene.volumes, o, d, mint, t, rng.uniform(ph, depth, 0x7A))
        bsdf = common.make_bsdf_at(scene, dg)
        nspec = B.num_components(bsdf, B.SPECULAR | B.REFLECTION |
                                 B.TRANSMISSION)
        has_nonspec = B.num_components(bsdf, B.ALL) > nspec
        cls = torch.full_like(pid, 0) if depth == 0 else \
            torch.where(spec_path, 1, 2).to(pid.dtype)
        out = (dg["p"], -d, alpha, cls, alive & has_nonspec)
        if radiance:
            nn_f = torch.where(vm.dot(dg["nn"], d)[..., None] > 0.0,
                               -dg["nn"], dg["nn"])
            out = out + (nn_f, B.rho_approx(bsdf, B.ALL_REFLECTION),
                         B.rho_approx(bsdf, B.ALL_TRANSMISSION),
                         rng.uniform(ph, depth, 0xAD) < 0.125)
        outs.append(out)
        # Continuation (photonmap.cpp:262-292): radical inverses at the
        # first bounce, hash streams after.
        if depth == 0:
            c = [rng.radical_inverse(idx, b) for b in (13, 17, 19)]
        else:
            c = [rng.uniform(ph, depth, k) for k in (1, 2, 3)]
        bs = B.sample_f(bsdf, -d, *c, B.ALL)
        ok = bs["valid"] & (bs["pdf"] > 0.0) & torch.any(bs["f"] > 0.0, -1)
        spec_path = ((depth == 0) | spec_path) & bs["specular"]
        alpha = alpha * (bs["f"] * (vm.absdot(bs["wi"], bsdf.nn) /
                                    torch.clamp(bs["pdf"],
                                                min=1e-20))[..., None])
        # Russian roulette after the 4th intersection.
        cont = torch.ones_like(alive)
        if depth >= 3:
            cont = rng.uniform(ph, depth, 0xEE) <= 0.5
            alpha = torch.where(cont[..., None], alpha * 2.0, alpha)
        alive = alive & ok & cont
        o, d = dg["p"], bs["wi"]
    return tuple(torch.stack(x) for x in zip(*outs))


def _shoot_packed(scene: SceneData, base: int, n: int, depth_bound: int,
                  seed: int, radiance: bool = False):
    """shoot_batch, then the valid deposits compacted on the device,
    path-major (photonmap.py:149-175: a stable sort of the invalid last;
    here the valid rows' ascending indices), so the host copies only
    those rows, in global path order. Returns numpy (pos, wi, alpha, cls,
    path id int64), with `radiance` then the picked valid deposits' (pos,
    normal, rho_r, rho_t), compacted the same way."""
    outs = shoot_batch(scene, base, n, depth_bound, seed, radiance)
    pos, wi, al, cls, valid = outs[:5]

    def pm(x):
        return x.transpose(0, 1).reshape((n * depth_bound,) + x.shape[2:])

    keep = torch.nonzero(pm(valid)).squeeze(1)
    pid = keep // depth_bound + base
    got = (pm(pos)[keep], pm(wi)[keep], pm(al)[keep], pm(cls)[keep], pid)
    if radiance:
        nn_f, rho_r, rho_t, pick = outs[5:]
        rkeep = torch.nonzero(pm(valid & pick)).squeeze(1)
        got += tuple(pm(x)[rkeep] for x in (pos, nn_f, rho_r, rho_t))
    return tuple(x.cpu().numpy() for x in got)


def build_maps(scene: SceneData, prm: PhotonParams, seed: int = 0,
               stats: dict = None, collect_radiance: bool = False):
    """The reference's Preprocess loop (photonmap.cpp:163-296, tpuprt's
    photonmap.py:178-301): batches of prm.batch paths until every map
    reaches its target, or prm.max_shot paths, or, from 8 batches on,
    every unfilled map has found nothing or fewer than one photon per 1024
    paths. Each map keeps its first `target` photons; its n_paths is the
    path count up to and including the one that filled it (the photons'
    path ids make that exact), else every path shot. The maps are built
    on the host and copied to the scene's device.

    stats, when given, receives per batch the seconds of the device's
    shooting and copy (`shoot_s`) and of the host's collection (`host_s`),
    and per map its photons, those the grid stores (photon_grid's thinning),
    n_paths, the batch that filled it, its buckets and bucket cap.

    With `collect_radiance` it returns (maps, rad): rad holds exphotonmap's
    radiance photons as numpy p, n, rho_r, rho_t f32[R, 3], every picked
    deposit of every batch shot, in path order (photonmap.py:239-244,
    301-305)."""
    dev = scene.lights.kind.device
    targets = {"direct": prm.direct, "caustic": prm.caustic,
               "indirect": prm.indirect}
    coll = {k: [] for k in MAPS}
    have = {k: 0 for k in MAPS}
    filled = {k: None for k in MAPS}
    rad = []
    shoot_s, host_s = [], []
    shot = 0
    while scene.lights.count and any(targets.values()) and \
            shot < prm.max_shot:
        t0 = time.perf_counter()
        P, W, A, C, I, *R = _shoot_packed(scene, shot, prm.batch,
                                          prm.shoot_depth, seed,
                                          collect_radiance)
        t1 = time.perf_counter()
        rad.append(R)
        shot += prm.batch
        for ci, k in enumerate(MAPS):
            if have[k] < targets[k]:
                m = C == ci
                coll[k].append((P[m], W[m], A[m], I[m]))
                have[k] += int(m.sum())
                if have[k] >= targets[k]:
                    filled[k] = shot // prm.batch
        host_s.append(time.perf_counter() - t1)
        shoot_s.append(t1 - t0)
        if all(have[k] >= targets[k] for k in MAPS):
            break
        # The "unsuccessful" bail (photonmap.cpp:139-144, 165-177).
        if shot >= 8 * prm.batch and all(
                have[k] >= targets[k] or have[k] == 0 or
                have[k] < shot // 1024 for k in MAPS):
            break

    grids = {}
    for k in MAPS:
        if coll[k]:
            pos, wi, al, pid = (np.concatenate(x) for x in zip(*coll[k]))
        else:
            pos = wi = al = np.zeros((0, 3), np.float32)
            pid = np.zeros((0,), np.int64)
        tgt = targets[k]
        if len(pid) > tgt:
            n_paths = float(pid[tgt - 1] + 1)
            pos, wi, al = pos[:tgt], wi[:tgt], al[:tgt]
        else:
            n_paths = float(shot)
        grids[k] = _to(build_photon_grid(pos, wi, al, prm.max_dist, n_paths),
                       dev)
        if stats is not None:
            stats[k] = dict(photons=len(pos), stored=grids[k].count,
                            target=tgt,
                            n_paths=n_paths, filled_at_batch=filled[k],
                            buckets=grids[k].n_buckets,
                            bucket_cap=grids[k].bucket_cap)
    if stats is not None:
        stats.update(batches=len(shoot_s), paths_shot=shot, shoot_s=shoot_s,
                     host_s=host_s)
    maps = PhotonMaps(**grids)
    if not collect_radiance:
        return maps
    cols = [np.concatenate(x) if x else np.zeros((0, 3), np.float32)
            for x in zip(*rad)] or [np.zeros((0, 3), np.float32)] * 4
    return maps, dict(zip(("p", "n", "rho_r", "rho_t"), cols))


def _to(grid: PhotonGrid, device) -> PhotonGrid:
    return dataclasses.replace(grid, packed=grid.packed.to(device),
                               start=grid.start.to(device),
                               n_paths=grid.n_paths.to(device))


# ---------------------------------------------------------------------------
# Density estimation (LPhoton)
# ---------------------------------------------------------------------------

def lphoton(grid: PhotonGrid, bsdf: B.BsdfBatch, wo, p, active,
            may_glossy: bool = True):
    """The fixed-radius photon radiance estimate at points p f32[N, 3]
    (photonmap.py:310-356), 0 on lanes not `active`; the lookup runs in
    blocks of points (photon_grid.block_rows)."""
    zero3 = torch.zeros(p.shape[:-1] + (3,), dtype=torch.float32,
                        device=p.device)
    if grid.count == 0:
        return zero3
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

        def accum(carry, wi_b, alpha_b, w):
            Lr, Lt, Lg = carry
            front = vm.dot(wi_b, nf_b) > 0.0
            Lr = Lr + torch.where((w & front)[..., None], alpha_b, 0.0).sum(1)
            Lt = Lt + torch.where((w & ~front)[..., None], alpha_b,
                                  0.0).sum(1)
            if may_glossy:
                f_val = B.f(bsdf_b, wo_b, wi_b)
                Lg = Lg + torch.where(w[..., None], f_val * alpha_b,
                                      0.0).sum(1)
            return Lr, Lt, Lg

        z = zero3[sl]
        sums.append(gather_photons(grid, p[sl], accum, (z, z, z)))
    Lr, Lt, Lg = (torch.cat(x) for x in zip(*sums))
    scale = 1.0 / (grid.n_paths * math.pi * grid.radius * grid.radius)
    L = (Lr * B.rho_approx(bsdf, B.ALL_REFLECTION) +
         Lt * B.rho_approx(bsdf, B.ALL_TRANSMISSION)) / math.pi
    if may_glossy:
        glossy = B.num_components(
            bsdf, B.REFLECTION | B.TRANSMISSION | B.GLOSSY) > 0
        L = torch.where(glossy[..., None], Lg, L)
    return torch.where(active[..., None], L * scale, 0.0)


# ---------------------------------------------------------------------------
# Li's radiance core
# ---------------------------------------------------------------------------

def gather_width(n_rays: int, G: int, device) -> int:
    """Gather samples traced at once: the largest divisor of G whose n_rays
    x width lanes fit the device's free memory (a fixed budget on the
    CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        lanes = free / 2 ** 30 * _GATHER_LANES_PER_GB
    else:
        lanes = 1 << 16
    Gb = int(max(1, min(G, lanes // max(n_rays, 1))))
    while G % Gb:
        Gb -= 1
    return Gb


def photon_radiance(scene: SceneData, maps: PhotonMaps, prm: PhotonParams,
                    bsdf, wo, p, ns, alive, ph, s_idx, depth):
    """Li's non-recursive radiance at shading points (photonmap.py:
    363-466; photonmap.cpp:315-364), 0 on lanes not `alive`: all lights'
    direct lighting (streams rng.uniform2(ph, s_idx, depth, light,
    purpose)) or the direct map, the caustic map, and the indirect map or
    the final gather (gather sample g's streams rng.uniform(ph, s_idx,
    depth, g, 0x61..0x63), its three maps at the gather ray's hit). depth
    is the lanes' bounce i32[N]."""
    n_rays = p.shape[0]
    mg = any(k in GLOSSY_LOBE_KINDS for k in scene.materials.lobe_kinds)
    if prm.direct_with_photons:
        Ld = lphoton(maps.direct, bsdf, wo, p, alive, may_glossy=mg)
    else:
        def sample_fn(light_i, purpose):
            return rng.uniform2(ph, s_idx, depth, light_i, purpose)
        Ld = common.uniform_sample_all_lights(scene, p, ns, wo, bsdf,
                                              sample_fn, alive)
    Lsum = torch.where(alive[..., None], Ld, 0.0)
    Lsum = Lsum + lphoton(maps.caustic, bsdf, wo, p, alive, may_glossy=mg)
    if not (prm.final_gather and maps.indirect.count > 0):
        return Lsum + lphoton(maps.indirect, bsdf, wo, p, alive,
                              may_glossy=mg)

    # The final gather (photonmap.cpp:327-364): lane i * Gb + g carries
    # ray i's gather sample g of the block.
    G = prm.gather_samples
    Gb = gather_width(n_rays, G, p.device)

    def rep(x):
        return x.repeat_interleave(Gb, 0)

    bsdfG = common.map_bsdf(bsdf, rep)
    phG, sG, dG = rep(ph), rep(s_idx), rep(depth)
    woG, pG, nsG, aliveG = rep(wo), rep(p), rep(ns), rep(alive)
    g_base = torch.arange(Gb, dtype=torch.int32,
                          device=p.device).repeat(n_rays)
    Lg = torch.zeros_like(p)
    for blk in range(G // Gb):
        gi = g_base + blk * Gb
        g1, g2, g3 = (rng.uniform(phG, sG, dG, gi, k)
                      for k in (0x61, 0x62, 0x63))
        bs = B.sample_f(bsdfG, woG, g1, g2, g3, B.ALL & ~B.SPECULAR)
        gok = aliveG & bs["valid"] & (bs["pdf"] > 0.0) & \
            torch.any(bs["f"] > 0.0, -1)
        # Provably-zero lanes carry empty windows.
        gt, gpid, ghit = isect.intersect_ids(
            scene, pG, bs["wi"], torch.where(gok, _EPS, 1.0),
            torch.where(gok, 1e30, -1.0))
        gok = gok & ghit
        gdg = isect.hit_geometry(scene, gpid, pG, bs["wi"], gt)
        gbsdf = common.make_bsdf_at(scene, gdg)
        gwo = -bs["wi"]
        Lind = (lphoton(maps.direct, gbsdf, gwo, gdg["p"], gok,
                        may_glossy=mg) +
                lphoton(maps.indirect, gbsdf, gwo, gdg["p"], gok,
                        may_glossy=mg) +
                lphoton(maps.caustic, gbsdf, gwo, gdg["p"], gok,
                        may_glossy=mg))
        contrib = bs["f"] * Lind * (vm.absdot(bs["wi"], nsG) / torch.clamp(
            bs["pdf"], min=1e-20))[..., None]
        Lg = Lg + torch.where(gok[..., None], contrib, 0.0).reshape(
            n_rays, Gb, 3).sum(1)
    return Lsum + Lg / float(G)


def li(scene: SceneData, maps: PhotonMaps, o, d, mint, maxt, cfg, px, py,
       s_idx, max_depth: int = 5, seed: int = 0,
       prm: PhotonParams = PhotonParams(), rx=None, ry=None):
    """Li's scan form (photonmap.py:469-528; photonmap.cpp:299-431) through
    the chunked driver's loop (common.scan_li): Le at every hit,
    photon_radiance at every vertex, the specular-only continuation.
    Returns (L, alpha, t_first)."""
    ph = rng.hash_u32(px, py, seed, 0x9B1)

    def shade(depth, idx, ph_l, s_l, dg, bsdf, wo, tp):
        live = torch.ones_like(s_l, dtype=torch.bool)
        yield tp * photon_radiance(scene, maps, prm, bsdf, wo, dg["p"],
                                   bsdf.nn, live, ph_l, s_l,
                                   torch.full_like(s_l, depth))

    return common.scan_li(scene, o, d, mint, maxt, rx, ry, ph, s_idx,
                          max_depth + 1, max_depth, shade)
