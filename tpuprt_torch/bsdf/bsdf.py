"""Branchless batched BSDFs over SoA lobe tables (port of
tpuprt/bsdf/bsdf.py): every lobe kind the fourteen materials produce.

  * Fresnel dielectric/conductor and the approximate conductor of a
    reflectance (reflection.cpp:31-96, FresnelApproxEta/K),
  * Lambertian / Oren-Nayar (reflection.cpp:128-156),
  * the Torrance-Sparrow microfacet lobe with the Blinn and anisotropic
    distributions and their sampling pdfs (reflection.cpp:157-175,
    246-332),
  * specular reflection and transmission with total internal reflection
    (reflection.cpp:96-127),
  * FresnelBlend (reflection.cpp:199-218, 333-354),
  * the Lafortune lobes of the measured materials (reflection.cpp:176-198),
  * BRDFToBTDF's hemisphere flip as a per-lobe flag (reflection.h:143-167).

Mixture rules as in the reference: uniform component choice, pdf averaged
over matching non-specular components, BRDF-vs-BTDF sidedness by the
geometric normal (reflection.cpp:402-457, 480-494).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core import mc, vecmath as vm

# BxDFType bitflags (reference core/reflection.h:53-68).
REFLECTION = 1
TRANSMISSION = 2
DIFFUSE = 4
GLOSSY = 8
SPECULAR = 16
ALL_TYPES = DIFFUSE | GLOSSY | SPECULAR
ALL_REFLECTION = REFLECTION | ALL_TYPES
ALL_TRANSMISSION = TRANSMISSION | ALL_TYPES
ALL = ALL_REFLECTION | ALL_TRANSMISSION

# Lobe kinds.
BX_NONE = -1
BX_LAMBERTIAN = 0
BX_ORENNAYAR = 1
BX_SPECREFL = 2
BX_SPECTRANS = 3
BX_MICROFACET = 4
BX_FRESNELBLEND = 5
BX_LAFORTUNE = 6

# Fresnel kinds (aux0 of a specular-reflection or microfacet lobe).
FR_DIELECTRIC = 0
FR_CONDUCTOR = 1
FR_NOOP = 2

# Distribution kinds (aux1 of a microfacet or FresnelBlend lobe).
DIST_BLINN = 0
DIST_ANISO = 1
_ALL_DISTS = (DIST_BLINN, DIST_ANISO)


@dataclass
class LobeTable:
    """SoA BxDF lobes for a shading wavefront of shape [..., L]."""
    kind: torch.Tensor     # i32[...,L]
    flags: torch.Tensor    # i32[...,L] BxDFType bits
    flip: torch.Tensor     # bool[...,L] BRDFToBTDF wrapper
    R: torch.Tensor        # f32[...,L,3]
    p: torch.Tensor        # f32[...,L,2] Oren-Nayar (A, B) | exponent(s)
    eta: torch.Tensor      # f32[...,L,3] conductor eta | [etai, etat, _]
                           # (dielectric Fresnel, specular transmission)
    k: torch.Tensor        # f32[...,L,3] conductor k | FresnelBlend Rs
    aux0: torch.Tensor     # i32[...,L] Fresnel kind | Lafortune fit id
    aux1: torch.Tensor     # i32[...,L] distribution kind
    kinds_present: tuple = ()
    dist_kinds: tuple = ()


@dataclass
class BsdfBatch:
    """Shading frame + lobes (core/reflection.h BSDF)."""
    nn: torch.Tensor       # f32[...,3] shading normal
    sn: torch.Tensor
    tn: torch.Tensor
    ng: torch.Tensor       # geometric normal
    lobes: LobeTable = None


def make_frame(nn, dpdu, ng):
    sn = vm.normalize(dpdu)
    sn = vm.normalize(sn - vm.dot(sn, nn)[..., None] * nn)
    return nn, sn, vm.cross(nn, sn), ng


def world_to_local(b: BsdfBatch, v):
    return torch.stack([vm.dot(v, b.sn), vm.dot(v, b.tn), vm.dot(v, b.nn)],
                       dim=-1)


def local_to_world(b: BsdfBatch, v):
    return v[..., 0:1] * b.sn + v[..., 1:2] * b.tn + v[..., 2:3] * b.nn


# ---------------------------------------------------------------------------
# Fresnel (reflection.cpp:31-96)
# ---------------------------------------------------------------------------

def fr_diel(cosi, cost, etai, etat):
    rparl = (etat * cosi - etai * cost) / torch.clamp(
        etat * cosi + etai * cost, min=1e-12)
    rperp = (etai * cosi - etat * cost) / torch.clamp(
        etai * cosi + etat * cost, min=1e-12)
    return (rparl * rparl + rperp * rperp) * 0.5


def fr_cond(cosi, eta, k):
    cosi = torch.abs(cosi)[..., None]
    tmp = (eta * eta + k * k) * cosi * cosi
    rparl2 = (tmp - 2.0 * eta * cosi + 1.0) / torch.clamp(
        tmp + 2.0 * eta * cosi + 1.0, min=1e-12)
    tmp_f = eta * eta + k * k
    rperp2 = (tmp_f - 2.0 * eta * cosi + cosi * cosi) / torch.clamp(
        tmp_f + 2.0 * eta * cosi + cosi * cosi, min=1e-12)
    return (rparl2 + rperp2) * 0.5


def fresnel_dielectric(cosi, etai, etat):
    """Dielectric Fresnel with sidedness and total internal reflection
    (reflection.cpp:78-96)."""
    cosi = torch.clamp(cosi, -1.0, 1.0)
    entering = cosi > 0.0
    ei = torch.where(entering, etai, etat)
    et = torch.where(entering, etat, etai)
    sint = ei / et * torch.sqrt(torch.clamp(1.0 - cosi * cosi, min=1e-12))
    tir = sint >= 1.0
    cost = torch.sqrt(torch.clamp(1.0 - sint * sint, min=1e-12))
    return torch.where(tir, 1.0, fr_diel(torch.abs(cosi), cost, ei, et))


def fresnel_approx_eta(fr):
    """FresnelApproxEta: the conductor eta of a normal reflectance."""
    r = torch.clamp(fr, 0.0, 0.999)
    return (1.0 + torch.sqrt(r)) / (1.0 - torch.sqrt(r))


def fresnel_approx_k(fr):
    """FresnelApproxK: the conductor k of a normal reflectance."""
    r = torch.clamp(fr, 0.0, 0.999)
    return 2.0 * torch.sqrt(r / (1.0 - r))


def _fresnel_eval(aux0, eta, k, cosi):
    """Each lobe's Fresnel spectrum [...,3] by its Fresnel kind."""
    f_d = fresnel_dielectric(cosi, eta[..., 0], eta[..., 1])[..., None]
    f_c = fr_cond(cosi, eta, k)
    return torch.where((aux0 == FR_DIELECTRIC)[..., None], f_d,
                       torch.where((aux0 == FR_CONDUCTOR)[..., None], f_c,
                                   1.0))


# ---------------------------------------------------------------------------
# Microfacet distributions (reflection.h:311-345, reflection.cpp:246-332)
# ---------------------------------------------------------------------------

def _blinn_d(e, wh):
    costh = torch.abs(wh[..., 2])
    return (e + 2.0) * mc.INV_TWOPI * torch.pow(
        torch.clamp(costh, min=1e-7), e)


def _aniso_d(ex, ey, wh):
    costh = torch.abs(wh[..., 2])
    d = torch.clamp(1.0 - costh * costh, min=1e-8)
    e = (ex * wh[..., 0] ** 2 + ey * wh[..., 1] ** 2) / d
    return torch.sqrt((ex + 2.0) * (ey + 2.0)) * mc.INV_TWOPI * \
        torch.pow(torch.clamp(costh, min=1e-7), e)


def _dists(lo: LobeTable):
    return lo.dist_kinds or _ALL_DISTS


def _pick(aux1, dists, blinn, aniso):
    """The value of each lobe's distribution, over the kinds present."""
    if DIST_ANISO not in dists:
        return blinn()
    if DIST_BLINN not in dists:
        return aniso()
    b, a = blinn(), aniso()
    return torch.where((aux1 == DIST_BLINN).reshape(
        aux1.shape + (1,) * (b.dim() - aux1.dim())), b, a)


def _dist_d(aux1, p, wh, dists=_ALL_DISTS):
    return _pick(aux1, dists, lambda: _blinn_d(p[..., 0], wh),
                 lambda: _aniso_d(p[..., 0], p[..., 1], wh))


def _dist_pdf(aux1, p, wo, wi, dists=_ALL_DISTS):
    wh = vm.normalize(wo + wi)
    woh = vm.dot(wo, wh)
    costh = torch.abs(wh[..., 2])

    def blinn():
        e_b = p[..., 0]
        return (e_b + 1.0) * torch.pow(torch.clamp(costh, min=1e-7), e_b) / \
            (2.0 * math.pi * 4.0 * torch.clamp(woh, min=1e-7))

    def aniso():
        ex, ey = p[..., 0], p[..., 1]
        ds = torch.clamp(1.0 - costh * costh, min=1e-8)
        e_a = (ex * wh[..., 0] ** 2 + ey * wh[..., 1] ** 2) / ds
        d_a = torch.sqrt((ex + 1.0) * (ey + 1.0)) * mc.INV_TWOPI * \
            torch.pow(torch.clamp(costh, min=1e-7), e_a)
        return d_a / (4.0 * torch.clamp(woh, min=1e-7))

    return torch.where(woh <= 0.0, 0.0, _pick(aux1, dists, blinn, aniso))


def _dist_sample_wh(aux1, p, wo, u1, u2, dists=_ALL_DISTS):
    """Sample the half-vector, flipped into wo's hemisphere."""
    def blinn():
        # reflection.cpp:246-262
        e_b = p[..., 0]
        return torch.stack([
            torch.pow(torch.clamp(u1, min=1e-12), 1.0 / (e_b + 1.0)),
            u2 * 2.0 * math.pi], -1)

    def aniso():
        # First-quadrant remap (reflection.cpp:275-321).
        ex, ey = p[..., 0], p[..., 1]
        q = torch.floor(u1 * 4.0)
        u1r = torch.where(q == 0, 4.0 * u1,
                          torch.where(q == 1, 4.0 * (0.5 - u1),
                                      torch.where(q == 2, 4.0 * (u1 - 0.5),
                                                  4.0 * (1.0 - u1))))
        u1r = torch.clamp(u1r, 0.0, 1.0)
        phi_fq = torch.where(
            torch.abs(ex - ey) < 1e-6, math.pi * u1r * 0.5,
            torch.arctan(torch.sqrt((ex + 1.0) / (ey + 1.0)) *
                         torch.tan(math.pi * torch.clamp(u1r, max=0.999999)
                                   * 0.5)))
        cosphi, sinphi = torch.cos(phi_fq), torch.sin(phi_fq)
        cost = torch.pow(torch.clamp(u2, min=1e-12), 1.0 / (
            ex * cosphi * cosphi + ey * sinphi * sinphi + 1.0))
        phi = torch.where(q == 0, phi_fq,
                          torch.where(q == 1, math.pi - phi_fq,
                                      torch.where(q == 2, math.pi + phi_fq,
                                                  2.0 * math.pi - phi_fq)))
        return torch.stack([cost, phi], -1)

    cp = _pick(aux1, dists, blinn, aniso)
    cost, phi = cp[..., 0], cp[..., 1]
    sint = torch.sqrt(torch.clamp(1.0 - cost * cost, min=1e-12))
    wh = torch.stack([sint * torch.cos(phi), sint * torch.sin(phi), cost],
                     -1)
    return torch.where(((wo[..., 2] * wh[..., 2]) < 0.0)[..., None], -wh,
                       wh)


def _microfacet_g(wo, wi, wh):
    ndwh = torch.abs(wh[..., 2])
    ndwo = torch.abs(wo[..., 2])
    ndwi = torch.abs(wi[..., 2])
    wodwh = torch.clamp(vm.absdot(wo, wh), min=1e-7)
    return torch.clamp(torch.minimum(2.0 * ndwh * ndwo / wodwh,
                                     2.0 * ndwh * ndwi / wodwh), max=1.0)


_LAFORTUNE: dict = {}


def _lafortune_table(device):
    """The fits' x, y, z and exponent columns f32[4, fits, lobes, 3] on
    `device`, copied there once."""
    tab = _LAFORTUNE.get(str(device))
    if tab is None:
        from ..materials.lafortune_data import (LOBE_E, LOBE_X, LOBE_Y,
                                                LOBE_Z)
        tab = torch.from_numpy(np.stack(
            [LOBE_X, LOBE_Y, LOBE_Z, LOBE_E]).astype(np.float32)).to(device)
        _LAFORTUNE[str(device)] = tab
    return tab


def _lafortune_f(aux0, R, wo, wi):
    """The Lafortune lobes of measured fit aux0 over the diffuse term R / pi
    (reflection.cpp:176-198; fits in materials/lafortune_data.py)."""
    tab = _lafortune_table(R.device)
    mid = torch.clamp(aux0, min=0).long()
    ret = R * mc.INV_PI
    for li in range(tab.shape[2]):
        x, y, z, e = (tab[c, :, li][mid] for c in range(4))
        v = (x * (wo[..., 0] * wi[..., 0])[..., None]
             + y * (wo[..., 1] * wi[..., 1])[..., None]
             + z * (wo[..., 2] * wi[..., 2])[..., None])
        ret = ret + torch.pow(torch.clamp(v, min=0.0), e)
    return ret


def _flipped(lo: LobeTable, wi):
    """wi as each lobe sees it: a BRDFToBTDF lobe mirrors it through the
    surface (reflection.h:143-167). -> [...,L,3]"""
    return torch.where(lo.flip[..., None], torch.cat(
        [wi[..., :2], -wi[..., 2:3]], -1), wi)


def _lobes_f(lo: LobeTable, wo, wi):
    """f for every lobe: wo/wi f32[...,1,3] broadcast over L -> [...,L,3].
    Specular lobes give 0 (delta functions)."""
    wi = _flipped(lo, wi)
    kinds = lo.kinds_present
    out = torch.zeros_like(lo.R)
    if BX_LAMBERTIAN in kinds:
        out = torch.where((lo.kind == BX_LAMBERTIAN)[..., None],
                          lo.R * mc.INV_PI, out)
    if BX_ORENNAYAR in kinds:
        # Oren-Nayar (reflection.cpp:132-156); A,B precomputed in p0,p1.
        sin_i = torch.sqrt(torch.clamp(1.0 - wi[..., 2] * wi[..., 2],
                                       min=1e-12))
        sin_o = torch.sqrt(torch.clamp(1.0 - wo[..., 2] * wo[..., 2],
                                       min=1e-12))
        both = (sin_i > 1e-4) & (sin_o > 1e-4)
        inv_si = 1.0 / torch.clamp(sin_i, min=1e-7)
        inv_so = 1.0 / torch.clamp(sin_o, min=1e-7)
        cphi_i, sphi_i = wi[..., 0] * inv_si, wi[..., 1] * inv_si
        cphi_o, sphi_o = wo[..., 0] * inv_so, wo[..., 1] * inv_so
        dcos = cphi_i * cphi_o + sphi_i * sphi_o
        maxcos = torch.where(both, torch.clamp(dcos, min=0.0), 0.0)
        ci, co = torch.abs(wi[..., 2]), torch.abs(wo[..., 2])
        big_i = ci > co
        sinalpha = torch.where(big_i, sin_o, sin_i)
        tanbeta = torch.where(big_i, sin_i / torch.clamp(ci, min=1e-7),
                              sin_o / torch.clamp(co, min=1e-7))
        f_on = lo.R * mc.INV_PI * (
            lo.p[..., 0] + lo.p[..., 1] * maxcos * sinalpha * tanbeta
        )[..., None]
        out = torch.where((lo.kind == BX_ORENNAYAR)[..., None], f_on, out)
    if BX_MICROFACET in kinds or BX_FRESNELBLEND in kinds:
        wh_raw = wi + wo
        wh_ok = vm.length_sq(wh_raw) > 1e-12
        wh = vm.normalize(wh_raw)
        costh_h = vm.dot(wi, wh)
        same_h = (wo[..., 2] * wi[..., 2]) > 0.0
        d_val = _dist_d(lo.aux1, lo.p, wh, _dists(lo))
    if BX_MICROFACET in kinds:
        # Torrance-Sparrow (reflection.cpp:157-175).
        F = _fresnel_eval(lo.aux0, lo.eta, lo.k, costh_h)
        g_val = _microfacet_g(wo, wi, wh)
        denom = 4.0 * torch.clamp(torch.abs(wi[..., 2]) *
                                  torch.abs(wo[..., 2]), min=1e-7)
        f_mf = lo.R * F * (d_val * g_val / denom)[..., None]
        f_mf = torch.where((wh_ok & same_h)[..., None], f_mf, 0.0)
        out = torch.where((lo.kind == BX_MICROFACET)[..., None], f_mf, out)
    if BX_FRESNELBLEND in kinds:
        # FresnelBlend (reflection.cpp:199-218): Rd = R, Rs = k.
        rd, rs = lo.R, lo.k

        def pw(c):
            return 1.0 - torch.pow(1.0 - 0.5 * torch.abs(c), 5)
        diffuse = (28.0 / (23.0 * math.pi)) * rd * (1.0 - rs) * \
            (pw(wi[..., 2]) * pw(wo[..., 2]))[..., None]
        schlick = rs + torch.pow(torch.clamp(1.0 - costh_h, min=0.0),
                                 5)[..., None] * (1.0 - rs)
        spec = (d_val / (4.0 * torch.clamp(vm.absdot(wi, wh), min=1e-7) *
                         torch.clamp(torch.maximum(torch.abs(wi[..., 2]),
                                                   torch.abs(wo[..., 2])),
                                     min=1e-7)))[..., None] * schlick
        f_fb = diffuse + torch.where(wh_ok[..., None], spec, 0.0)
        f_fb = torch.where(same_h[..., None], f_fb, 0.0)
        out = torch.where((lo.kind == BX_FRESNELBLEND)[..., None], f_fb,
                          out)
    if BX_LAFORTUNE in kinds:
        out = torch.where((lo.kind == BX_LAFORTUNE)[..., None],
                          _lafortune_f(lo.aux0, lo.R, wo, wi), out)
    return out


def _lobes_pdf(lo: LobeTable, wo, wi):
    """pdf for every lobe -> [...,L]: the cosine pdf on wo's side for the
    diffuse and Lafortune lobes, the distribution's for the microfacet
    lobe, their mean for FresnelBlend, 0 for the specular lobes."""
    wi = _flipped(lo, wi)
    kinds = lo.kinds_present
    same_h = (wo[..., 2] * wi[..., 2]) > 0.0
    cos_pdf = torch.where(same_h, torch.abs(wi[..., 2]) * mc.INV_PI, 0.0)
    diffuse = (lo.kind == BX_LAMBERTIAN) | (lo.kind == BX_ORENNAYAR) | \
        (lo.kind == BX_LAFORTUNE)
    out = torch.where(diffuse, cos_pdf, 0.0)
    if BX_MICROFACET in kinds or BX_FRESNELBLEND in kinds:
        dpdf = _dist_pdf(lo.aux1, lo.p, wo, wi, _dists(lo))
    if BX_MICROFACET in kinds:
        out = torch.where(lo.kind == BX_MICROFACET,
                          torch.where(same_h, dpdf, 0.0), out)
    if BX_FRESNELBLEND in kinds:
        out = torch.where(lo.kind == BX_FRESNELBLEND, torch.where(
            same_h, 0.5 * (torch.abs(wi[..., 2]) * mc.INV_PI + dpdf), 0.0),
            out)
    return out


def _matches(lobe_flags, mask):
    """MatchesFlags: (type & flags) == type, and the lobe exists."""
    return ((lobe_flags & mask) == lobe_flags) & (lobe_flags > 0)


def num_components(b: BsdfBatch, mask):
    """BSDF::NumComponents(flags): the lobes matching `mask`, per lane."""
    return _matches(b.lobes.flags, mask).to(torch.int32).sum(dim=-1)


def rho_approx(b: BsdfBatch, mask=ALL & ~SPECULAR):
    """tpuprt's hemispherical reflectance (bsdf.py:502-511): the sum of R
    over the matching lobes; exact for Lambertian, tpuprt's stand-in for
    the reference's 16-sample estimate (reflection.cpp:355-392) otherwise.
    The photon map's diffuse estimate multiplies its flux sums by it."""
    match = _matches(b.lobes.flags, mask)
    return torch.where(match[..., None], b.lobes.R, 0.0).sum(dim=-2)


def f(b: BsdfBatch, wo_w, wi_w, mask=ALL):
    """BSDF::f with geometric-normal sidedness (reflection.cpp:480-494)."""
    wo = world_to_local(b, wo_w)[..., None, :]
    wi = world_to_local(b, wi_w)[..., None, :]
    reflect_side = (vm.dot(wi_w, b.ng) * vm.dot(wo_w, b.ng)) > 0.0
    side_mask = torch.where(reflect_side, mask & ~TRANSMISSION,
                            mask & ~REFLECTION)
    match = _matches(b.lobes.flags, side_mask[..., None])
    vals = _lobes_f(b.lobes, wo, wi)
    return torch.where(match[..., None], vals, 0.0).sum(dim=-2)


def pdf(b: BsdfBatch, wo_w, wi_w, mask=ALL):
    """BSDF::Pdf: mean pdf over matching components."""
    wo = world_to_local(b, wo_w)[..., None, :]
    wi = world_to_local(b, wi_w)[..., None, :]
    match = _matches(b.lobes.flags, mask)
    pdfs = _lobes_pdf(b.lobes, wo, wi)
    n = match.to(torch.float32).sum(dim=-1)
    total = torch.where(match, pdfs, 0.0).sum(dim=-1)
    return torch.where(n > 0, total / torch.clamp(n, min=1.0), 0.0)


def _lobe_sample(lo: LobeTable, sel, wo, u1, u2):
    """Sample wi for the one selected lobe per lane (sel bool[...,L], at
    most one True): (wi, pdf of that lobe, f_spec), where f_spec is the
    delta-weighted value of a specular lobe (0 for the others, whose f the
    caller recomputes). A flipped lobe samples on its own side and returns
    the mirrored wi (tpuprt/bsdf/bsdf.py:395-486)."""
    def gath(a):                                  # [...,L(,C)] -> [...(,C)]
        if a.dim() == sel.dim():
            return torch.where(sel, a, 0).sum(dim=-1, dtype=a.dtype)
        return torch.where(sel[..., None], a, 0).sum(dim=-2, dtype=a.dtype)

    kinds = lo.kinds_present
    kind = gath(lo.kind)
    is_sr, is_st = kind == BX_SPECREFL, kind == BX_SPECTRANS
    is_mf, is_fb = kind == BX_MICROFACET, kind == BX_FRESNELBLEND
    diffuseish = any(k in kinds for k in
                     (BX_LAMBERTIAN, BX_ORENNAYAR, BX_LAFORTUNE))
    glossy = BX_MICROFACET in kinds or BX_FRESNELBLEND in kinds
    if glossy:
        aux1, p = gath(lo.aux1), gath(lo.p)

    def on_wo_side(w):
        return torch.where((wo[..., 2] < 0.0)[..., None],
                           torch.cat([w[..., :2], -w[..., 2:3]], -1), w)

    def reflect(wh):
        return -wo + 2.0 * vm.dot(wo, wh)[..., None] * wh

    wi = torch.zeros_like(wo)
    if diffuseish:
        # Cosine hemisphere on wo's side (reflection.cpp:219-230).
        wi = on_wo_side(mc.cosine_sample_hemisphere(u1, u2))
    if BX_MICROFACET in kinds:
        wi = torch.where(is_mf[..., None], reflect(_dist_sample_wh(
            aux1, p, wo, u1, u2, _dists(lo))), wi)
    if BX_FRESNELBLEND in kinds:
        # Half cosine, half microfacet (reflection.cpp:333-347).
        use_cos = u1 < 0.5
        u1_fb = torch.where(use_cos, 2.0 * u1, 2.0 * (u1 - 0.5))
        wi_fb = torch.where(
            use_cos[..., None],
            on_wo_side(mc.cosine_sample_hemisphere(u1_fb, u2)),
            reflect(_dist_sample_wh(aux1, p, wo, u1_fb, u2, _dists(lo))))
        wi = torch.where(is_fb[..., None], wi_fb, wi)
    if BX_SPECREFL in kinds:
        wi = torch.where(is_sr[..., None], torch.stack(
            [-wo[..., 0], -wo[..., 1], wo[..., 2]], -1), wi)
    specular = BX_SPECREFL in kinds or BX_SPECTRANS in kinds
    if specular:
        R, eta = gath(lo.R), gath(lo.eta)
        etai, etat = eta[..., 0], eta[..., 1]
        entering = wo[..., 2] > 0.0
        ei = torch.where(entering, etai, etat)
        et = torch.where(entering, etat, etai)
    if BX_SPECTRANS in kinds:
        # Specular transmission (reflection.cpp:104-127).
        sini2 = torch.clamp(1.0 - wo[..., 2] ** 2, min=0.0)
        eta_r = ei / torch.clamp(et, min=1e-7)
        sint2 = eta_r * eta_r * sini2
        tir = sint2 >= 1.0
        cost = torch.sqrt(torch.clamp(1.0 - sint2, min=1e-12))
        cost = torch.where(entering, -cost, cost)
        wi = torch.where(is_st[..., None], torch.stack(
            [eta_r * -wo[..., 0], eta_r * -wo[..., 1], cost], -1), wi)

    # The selected lobe's pdf; specular 1, total internal reflection 0.
    pdf = torch.zeros_like(wo[..., 0])
    if diffuseish:
        pdf = torch.abs(wi[..., 2]) * mc.INV_PI
    if glossy:
        dpdf = _dist_pdf(aux1, p, wo, wi, _dists(lo))
        pdf = torch.where(is_mf, dpdf, pdf)
        pdf = torch.where(is_fb, 0.5 * (torch.abs(wi[..., 2]) * mc.INV_PI
                                        + dpdf), pdf)
        same_h = (wo[..., 2] * wi[..., 2]) > 0.0
        pdf = torch.where((is_mf | is_fb) & ~same_h, 0.0, pdf)
    if specular:
        pdf = torch.where(is_sr | is_st, 1.0, pdf)
        abs_ci = torch.clamp(torch.abs(wi[..., 2]), min=1e-7)
    if BX_SPECTRANS in kinds:
        pdf = torch.where(is_st & tir, 0.0, pdf)

    f_spec = torch.zeros_like(wo)
    if BX_SPECREFL in kinds:
        F_sr = _fresnel_eval(gath(lo.aux0), eta, gath(lo.k), wo[..., 2])
        f_spec = torch.where(is_sr[..., None],
                             F_sr * R / abs_ci[..., None], f_spec)
    if BX_SPECTRANS in kinds:
        F_st = fresnel_dielectric(wo[..., 2], etai, etat)
        f_st = ((et * et) / torch.clamp(ei * ei, min=1e-12) *
                (1.0 - F_st) / abs_ci)[..., None] * R
        f_st = torch.where(tir[..., None], 0.0, f_st)
        f_spec = torch.where(is_st[..., None], f_st, f_spec)

    # BRDFToBTDF: mirror the sampled direction.
    flip = (sel & lo.flip).any(dim=-1)
    wi = torch.where(flip[..., None], torch.cat(
        [wi[..., :2], -wi[..., 2:3]], -1), wi)
    return wi, pdf, f_spec


def sample_f(b: BsdfBatch, wo_w, u1, u2, u3, mask=ALL):
    """BSDF::Sample_f (reflection.cpp:402-457). A
    specular sample returns its lobe's delta-weighted f and pdf alone; any
    other sample adds the other matching lobes' pdfs and recomputes f over
    the matching lobes on the sampled side.

    Returns dict(wi, f, pdf, flags, specular, valid, eta): eta is the
    sampled lobe's etat / etai on a specular transmission lobe, 1 on any
    other (whitted.cpp:117 reads it for the ray differentials).
    """
    lo = b.lobes
    match = _matches(lo.flags, mask)                    # [...,L]
    ncomp = match.to(torch.int32).sum(dim=-1)
    which = torch.minimum((u3 * ncomp.to(torch.float32)).to(torch.int32),
                          torch.clamp(ncomp - 1, min=0))
    cum = torch.cumsum(match.to(torch.int32), dim=-1) - 1
    sel = match & (cum == which[..., None])
    sampled_flags = torch.where(sel, lo.flags, 0).sum(dim=-1)

    wo = world_to_local(b, wo_w)
    wi_l, pdf_sel, f_spec = _lobe_sample(lo, sel, wo, u1, u2)
    is_spec = (sampled_flags & SPECULAR) > 0
    wi_w = local_to_world(b, wi_l)

    # Overall pdf: add the other matching lobes' pdfs.
    pdfs_all = _lobes_pdf(lo, wo[..., None, :], wi_l[..., None, :])
    not_sel = match & ~sel
    pdf_total = pdf_sel + torch.where(
        is_spec, 0.0, torch.where(not_sel, pdfs_all, 0.0).sum(dim=-1))
    pdf_total = pdf_total / torch.clamp(ncomp.to(torch.float32), min=1.0)

    # f over the matching lobes on the sampled side.
    reflect_side = (vm.dot(wi_w, b.ng) * vm.dot(wo_w, b.ng)) > 0.0
    side_mask = torch.where(reflect_side, mask & ~TRANSMISSION,
                            mask & ~REFLECTION)
    match_side = _matches(lo.flags, side_mask[..., None])
    f_all = _lobes_f(lo, wo[..., None, :], wi_l[..., None, :])
    f_sum = torch.where(match_side[..., None], f_all, 0.0).sum(dim=-2)
    f_val = torch.where(is_spec[..., None], f_spec, f_sum)

    valid = (ncomp > 0) & (pdf_sel > 0.0)
    eta_cols = torch.where(sel[..., None], lo.eta, 0).sum(dim=-2)
    eta = torch.where(torch.where(sel, lo.kind, 0).sum(dim=-1) ==
                      BX_SPECTRANS,
                      eta_cols[..., 1] / torch.clamp(eta_cols[..., 0],
                                                     min=1e-6), 1.0)
    return dict(wi=wi_w, f=f_val, pdf=torch.where(valid, pdf_total, 0.0),
                flags=sampled_flags, specular=is_spec, valid=valid, eta=eta)
