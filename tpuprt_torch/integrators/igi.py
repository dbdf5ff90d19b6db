"""Instant global illumination (port of tpuprt/integrators/igi.py;
igi.cpp:93-276).

- build_virtual_lights (the preprocess, igi.cpp:93-166): nsets x npaths
  light paths, the light picked from the power CDF, the emission from
  each set's scrambled (0,2)-sequence, luminance-ratio Russian roulette;
  a virtual light with Le = alpha rho / pi at every vertex. tpuprt traces
  one set a call; here every (set, path) lane goes at once, the same
  streams.
- li: at each vertex all lights' direct lighting, then the camera
  sample's one set of virtual lights (picked per sample, igi.cpp:190-191),
  each with the SmoothStep distance screen, its own shadow ray and the
  weak-contribution Russian roulette (igi.cpp:195-215), and the
  specular-only continuation (common.scan_li).

tpuprt's divergences are kept: the light path's length is bounded
(depth_bound), rho is the lobes' R sum, and the contributions are divided
by the light paths of a set (n_paths) where the reference divides by the
virtual lights' count, the estimator pbrt-v2 corrected.

tpuprt scans the virtual lights one at a time, one shadow launch each.
Here a block of (lane, light) pairs goes at once, sized from free memory:
the shadow rays of the pairs that need one are compacted into one any-hit
call, and each lane's contributions are added in light order. A set's
lights are read in index order with the invalid ones left out (they add
nothing); each keeps its index for its stream rng.uniform(ph, s_idx,
depth, light, 0xA7).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..accel import intersect as isect
from ..accel.photon_grid import block_rows
from ..bsdf import bsdf as B
from ..core import rng, spectrum as spec, vecmath as vm
from ..lights import emission, lights as lt
from ..scene.data import SceneData
from ..volumes import regions as vr
from . import common

_EPS = vm.RAY_EPSILON
# Bytes one (lane, virtual light) pair holds at its peak: its light, the
# BSDF's per-lobe values and the stream's hash temporaries.
_PAIR_BYTES = 1536


class IgiParams(NamedTuple):
    """CreateSurfaceIntegrator's defaults (igi.cpp:288-295); counts rounded
    up to powers of two as the constructor does (igi.cpp:66-67)."""
    nlights: int = 64          # light paths per set
    nsets: int = 4
    mindist: float = 0.1
    rrthreshold: float = 0.05
    indirectscale: float = 1.0
    depth_bound: int = 8       # vertices a light path may have


@dataclasses.dataclass
class VirtualLights:
    """Per set s and light m (vertex-major: m = depth * n_paths + path):
    position, normal, Le f32[S, M, 3] and valid bool[S, M]; n_paths f32[]
    the light paths of a set (the estimator's normalizer)."""
    p: torch.Tensor = None
    n: torch.Tensor = None
    Le: torch.Tensor = None
    valid: torch.Tensor = None
    n_paths: torch.Tensor = None
    nsets: int = 1
    max_vl: int = 1


def _pow2(x: int) -> int:
    return 1 << max(0, math.ceil(math.log2(max(x, 1))))


def build_virtual_lights(scene: SceneData, prm: IgiParams,
                         seed: int = 0) -> VirtualLights:
    """The preprocess (igi.cpp:93-166; tpuprt igi.py:62-157) on the
    scene's device."""
    dev = scene.lights.kind.device
    npaths, nsets = _pow2(prm.nlights), _pow2(prm.nsets)
    if scene.lights.count == 0:
        z = torch.zeros((1, 1, 3), dtype=torch.float32, device=dev)
        return VirtualLights(p=z, n=z, Le=z, valid=torch.zeros(
            (1, 1), dtype=torch.bool, device=dev), n_paths=torch.ones(
                (), device=dev))
    # The power CDF (igi.cpp:103-117): Distribution1D over luminance.
    func = spec.luminance(lt.power(scene))
    nl = scene.lights.count
    cdf = torch.cat([torch.zeros(1, device=dev), torch.cumsum(func / nl, 0)])
    func_int = cdf[-1]
    cdf = cdf / torch.clamp(func_int, min=1e-20)
    # Lane set * npaths + i traces path i of its set.
    n = nsets * npaths
    set_id = torch.arange(nsets, device=dev).repeat_interleave(npaths)
    i = torch.arange(npaths, device=dev).repeat(nsets)
    sh = rng.hash_u32(set_id, seed, 0x161)
    u_num = rng.ld_shuffled_1d(i, sh, 0)
    l0x, l0y = rng.ld_shuffled_2d(i, sh, 1)
    l1x, l1y = rng.ld_shuffled_2d(i, sh, 2)
    lid = torch.clamp(torch.searchsorted(cdf, u_num, right=True) - 1, 0,
                      nl - 1)
    light_pdf = func[lid] / torch.clamp(func_int, min=1e-20)
    em = emission.sample_emission(scene, lid.to(torch.int32), l0x, l0y,
                                  l1x, l1y, rng.uniform(sh, i, 0x55))
    alpha = em["Le"] / torch.clamp(em["pdf"] * light_pdf,
                                   min=1e-20)[..., None]
    alive = (em["pdf"] > 0.0) & (light_pdf > 0.0) & \
        torch.any(alpha > 0.0, -1)
    o, d = em["o"], em["d"]
    outs = []
    for depth in range(prm.depth_bound):
        t, pid, hit = isect.intersect_ids(scene, o, d,
                                          *common.live_window(alive))
        alive = alive & hit & torch.any(alpha > 0.0, -1)
        dg = isect.hit_geometry(scene, pid, o, d, t)
        if vr.present(scene.volumes):
            # The path's power attenuated along the segment (igi.py:93-97).
            alpha = alpha * vr.transmittance(
                scene.volumes, o, d, torch.full_like(t, _EPS), t,
                rng.uniform(sh, i, depth, 0x7A))
        bsdf = common.make_bsdf_at(scene, dg)
        # VirtualLight(p, nn, alpha * rho / pi) (igi.cpp:135-141).
        outs.append((dg["p"], dg["nn"],
                     alpha * B.rho_approx(bsdf) * (1.0 / math.pi), alive))
        c = [rng.uniform(sh, i, depth, k) for k in (1, 2, 3)]
        bs = B.sample_f(bsdf, -d, *c, B.ALL)
        ok = bs["valid"] & (bs["pdf"] > 0.0) & torch.any(bs["f"] > 0.0, -1)
        anew = alpha * bs["f"] * (vm.absdot(bs["wi"], bsdf.nn) / torch.clamp(
            bs["pdf"], min=1e-20))[..., None]
        # Luminance-ratio Russian roulette (igi.cpp:150-155).
        r = spec.luminance(anew) / torch.clamp(spec.luminance(alpha),
                                               min=1e-20)
        cont = rng.uniform(sh, i, depth, 0xEE) <= r
        alpha = anew / torch.clamp(r, min=1e-20)[..., None]
        alive = alive & ok & cont
        o, d = dg["p"], bs["wi"]

    def per_set(x):
        # [D, S * P, ...] -> [S, D * P, ...]
        x = x.reshape((prm.depth_bound, nsets, npaths) + x.shape[2:])
        return x.transpose(0, 1).reshape((nsets, -1) + x.shape[3:])
    p, nrm, Le, valid = (per_set(torch.stack(x)) for x in zip(*outs))
    return VirtualLights(p=p, n=nrm, Le=Le, valid=valid,
                         n_paths=torch.tensor(float(npaths), device=dev),
                         nsets=nsets, max_vl=int(p.shape[1]))


def _set_order(vls: VirtualLights):
    """Each set's valid lights' indices in order, i64[S, K] (K the most any
    set has), and which entries are real, bool[S, K]."""
    order = torch.argsort((~vls.valid).to(torch.int32), dim=1, stable=True)
    cnt = vls.valid.sum(1)
    k = max(int(cnt.max()), 1)
    real = torch.arange(k, device=cnt.device)[None, :] < cnt[:, None]
    return order[:, :k], real


def gather_lights(scene: SceneData, vls: VirtualLights, order, real, lset,
                  p, nrm, wo, bsdf, ph, s_idx, depth: int, prm: IgiParams):
    """The virtual lights' radiance at shading points p (igi.cpp:189-218;
    tpuprt igi.py:205-233), f32[N, 3]: for each lane's set lset i32[N], the
    sum in light order of f G Le / n_paths over the lights past the
    SmoothStep screen, unoccluded and not dropped by the weak-contribution
    roulette."""
    n = p.shape[0]
    acc = torch.zeros((n, 3), dtype=torch.float32, device=p.device)
    if n == 0:
        return acc
    min_d2 = prm.mindist * prm.mindist
    kb = max(1, block_rows(p.device, _PAIR_BYTES, 1 << 18) // n)
    bsdf_b = common.map_bsdf(bsdf, lambda x: x[:, None])
    wo_b, p_b, n_b = wo[:, None, :], p[:, None, :], nrm[:, None, :]
    ls = lset.long()[:, None]
    for k0 in range(0, order.shape[1], kb):
        ks = torch.arange(k0, min(k0 + kb, order.shape[1]),
                          device=p.device)[None, :]
        vi = order[ls, ks]                                   # [N, kb]
        vp, vn, vle = vls.p[ls, vi], vls.n[ls, vi], vls.Le[ls, vi]
        to_vl = vp - p_b
        d2 = torch.clamp(vm.length_sq(to_vl), min=1e-12)
        dist_scale = vm.smoothstep(0.8 * min_d2, 1.2 * min_d2, d2)
        wi = to_vl * torch.rsqrt(d2)[..., None]
        f_val = dist_scale[..., None] * B.f(bsdf_b, wo_b, wi)
        G = vm.absdot(wi, n_b) * vm.absdot(wi, vn) / d2
        Ll = prm.indirectscale * f_val * G[..., None] * vle / vls.n_paths
        need = real[ls, ks] & torch.any(f_val > 0.0, -1)
        # Weak-contribution Russian roulette (igi.cpp:206-212).
        weak = spec.luminance(Ll) < prm.rrthreshold
        skip = weak & (rng.uniform(ph[:, None], s_idx[:, None], depth, vi,
                                   0xA7) > 0.1)
        Ll = torch.where(weak[..., None], Ll / 0.1, Ll)
        need = need & ~skip
        # One any-hit call for the block's shadow rays.
        lane, col = torch.nonzero(need, as_tuple=True)
        occ = torch.zeros_like(need)
        occ[lane, col] = isect.occluded(
            scene, p[lane], wi[lane, col],
            torch.full(lane.shape, _EPS, dtype=torch.float32,
                       device=p.device),
            torch.sqrt(d2[lane, col]) * (1.0 - 1e-3))
        contrib = torch.where((need & ~occ)[..., None], Ll, 0.0)
        for k in range(contrib.shape[1]):
            acc = acc + contrib[:, k]
    return acc


def li(scene: SceneData, vls: VirtualLights, o, d, mint, maxt, cfg, px,
       py, s_idx, max_depth: int = 5, seed: int = 0,
       prm: IgiParams = IgiParams(), rx=None, ry=None):
    """Li (igi.cpp:168-276; tpuprt igi.py:160-252) for a chunk of camera
    rays: (L f32[N, 3], alpha f32[N], t_first f32[N])."""
    del cfg  # every stream is a hash
    ph = rng.hash_u32(px, py, seed, 0x161B)
    # The camera sample's set (igi.cpp:190-191).
    lset = torch.clamp((rng.uniform(ph, s_idx, 0x5E7) * vls.nsets)
                       .to(torch.int32), max=vls.nsets - 1)
    order, real = _set_order(vls)

    def shade(depth, idx, ph_l, s_l, dg, bsdf, wo, tp):
        live = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
        Ld = common.uniform_sample_all_lights(
            scene, dg["p"], bsdf.nn, wo, bsdf,
            lambda i, k: rng.uniform2(ph_l, s_l, depth, i, k), live)
        Lvl = gather_lights(scene, vls, order, real, lset[idx], dg["p"],
                            bsdf.nn, wo, bsdf, ph_l, s_l, depth, prm)
        return tp * Ld, tp * Lvl
    return common.scan_li(scene, o, d, mint, maxt, rx, ry, ph, s_idx,
                          max_depth + 1, max_depth, shade)
