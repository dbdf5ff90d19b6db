"""Branchless batched BSDFs over SoA lobe tables (port of tpuprt/bsdf/bsdf.py
for the lobes the matte material produces: Lambertian and Oren-Nayar).

Mixture rules as in the reference: uniform component choice, pdf averaged
over matching non-specular components, BRDF-vs-BTDF sidedness by the
geometric normal (reflection.cpp:402-457, 480-494).
"""
from __future__ import annotations

from dataclasses import dataclass

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
PORTED_KINDS = (BX_LAMBERTIAN, BX_ORENNAYAR)


@dataclass
class LobeTable:
    """SoA BxDF lobes for a shading wavefront of shape [..., L]."""
    kind: torch.Tensor     # i32[...,L]
    flags: torch.Tensor    # i32[...,L] BxDFType bits
    R: torch.Tensor        # f32[...,L,3]
    p: torch.Tensor        # f32[...,L,2] Oren-Nayar (A, B)
    kinds_present: tuple = ()


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


def _check_kinds(lo: LobeTable):
    missing = set(lo.kinds_present) - set(PORTED_KINDS)
    if missing:
        raise NotImplementedError(f"BxDF kinds {sorted(missing)} not ported")


def _lobes_f(lo: LobeTable, wo, wi):
    """f for every lobe: wo/wi f32[...,1,3] broadcast over L -> [...,L,3]."""
    _check_kinds(lo)
    out = torch.zeros_like(lo.R)
    if BX_LAMBERTIAN in lo.kinds_present:
        out = torch.where((lo.kind == BX_LAMBERTIAN)[..., None],
                          lo.R * mc.INV_PI, out)
    if BX_ORENNAYAR in lo.kinds_present:
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
    return out


def _lobes_pdf(lo: LobeTable, wo, wi):
    """pdf for every lobe -> [...,L]: cosine pdf on wo's side."""
    _check_kinds(lo)
    same_h = (wo[..., 2] * wi[..., 2]) > 0.0
    cos_pdf = torch.where(same_h, torch.abs(wi[..., 2]) * mc.INV_PI, 0.0)
    diffuse = (lo.kind == BX_LAMBERTIAN) | (lo.kind == BX_ORENNAYAR)
    return torch.where(diffuse, cos_pdf, 0.0)


def _matches(lobe_flags, mask):
    """MatchesFlags: (type & flags) == type, and the lobe exists."""
    return ((lobe_flags & mask) == lobe_flags) & (lobe_flags > 0)


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


def sample_f(b: BsdfBatch, wo_w, u1, u2, u3, mask=ALL):
    """BSDF::Sample_f (reflection.cpp:402-457) for diffuse lobes.

    Returns dict(wi, f, pdf, flags, specular, valid).
    """
    lo = b.lobes
    _check_kinds(lo)
    match = _matches(lo.flags, mask)                    # [...,L]
    ncomp = match.to(torch.int32).sum(dim=-1)
    which = torch.minimum((u3 * ncomp.to(torch.float32)).to(torch.int32),
                          torch.clamp(ncomp - 1, min=0))
    cum = torch.cumsum(match.to(torch.int32), dim=-1) - 1
    sel = match & (cum == which[..., None])
    sampled_flags = torch.where(sel, lo.flags, 0).sum(dim=-1)

    wo = world_to_local(b, wo_w)
    # Cosine hemisphere on wo's side (reflection.cpp:219-230).
    wi_l = mc.cosine_sample_hemisphere(u1, u2)
    wi_l = torch.where((wo[..., 2] < 0.0)[..., None],
                       torch.cat([wi_l[..., :2], -wi_l[..., 2:3]], -1), wi_l)
    pdf_sel = torch.abs(wi_l[..., 2]) * mc.INV_PI
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
    f_val = torch.where(match_side[..., None], f_all, 0.0).sum(dim=-2)

    valid = (ncomp > 0) & (pdf_sel > 0.0)
    return dict(wi=wi_w, f=f_val, pdf=torch.where(valid, pdf_total, 0.0),
                flags=sampled_flags, specular=is_spec, valid=valid)
