"""Material -> BSDF lobe assembly via build-time templates (port of
tpuprt/materials/factory.py: all fourteen materials).

`build_templates` compiles each material's lobe structure into [M, L]
op-code columns on the host; `make_lobes` assembles a shading wavefront's
LobeTable from those columns and the evaluated texture slots. Slots:
  matte:       0 = Kd, 1 = sigma (matte.cpp:46-64; sigma 0 reduces
               Oren-Nayar to exact Lambertian, A=1, B=0)
  plastic:     0 = Kd, 1 = Ks, 2 = roughness (plastic.cpp:46-68)
  glass:       0 = Kr, 1 = Kt, 2 = index (glass.cpp:46-63)
  mirror:      0 = Kr (mirror.cpp: specular reflection, no Fresnel)
  shinymetal:  0 = Ks, 1 = Kr, 2 = roughness (shinymetal.cpp:45-66)
  substrate:   0 = Kd, 1 = Ks, 2 = uroughness, 3 = vroughness
               (substrate.cpp:47-63)
  translucent: 0 = Kd, 1 = Ks, 2 = roughness, 3 = reflect, 4 = transmit
               (translucent.cpp)
  uber:        0 = Kd, 1 = Ks, 2 = Kr, 3 = roughness, 4 = opacity
               (uber.cpp:52-88)
  measured:    none (the kind names the fit: bluepaint, brushedmetal,
               clay, felt, primer, skin)

A lobe whose evaluated scale is exactly black is disabled at shading time,
as the reference adds a BxDF only for a non-black scale, so component
counts and mixture pdfs agree.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from ..bsdf import bsdf as B

MAT_MATTE = 0
MAT_PLASTIC = 1
MAT_GLASS = 2
MAT_MIRROR = 3
MAT_SHINYMETAL = 4
MAT_SUBSTRATE = 5
MAT_TRANSLUCENT = 6
MAT_UBER = 7
MAT_MEASURED_BASE = 8      # 8..13 = bluepaint..skin
NUM_MEASURED = 6
MAX_LOBES = 4

MATERIAL_KINDS = {
    "matte": MAT_MATTE, "plastic": MAT_PLASTIC, "glass": MAT_GLASS,
    "mirror": MAT_MIRROR, "shinymetal": MAT_SHINYMETAL,
    "substrate": MAT_SUBSTRATE, "translucent": MAT_TRANSLUCENT,
    "uber": MAT_UBER,
    "bluepaint": MAT_MEASURED_BASE + 0, "brushedmetal": MAT_MEASURED_BASE + 1,
    "clay": MAT_MEASURED_BASE + 2, "felt": MAT_MEASURED_BASE + 3,
    "primer": MAT_MEASURED_BASE + 4, "skin": MAT_MEASURED_BASE + 5,
}

_FL_DIFF_R = B.REFLECTION | B.DIFFUSE
_FL_GLOS_R = B.REFLECTION | B.GLOSSY
_FL_SPEC_R = B.REFLECTION | B.SPECULAR
_FL_SPEC_T = B.TRANSMISSION | B.SPECULAR
_FL_DIFF_T = B.TRANSMISSION | B.DIFFUSE
_FL_GLOS_T = B.TRANSMISSION | B.GLOSSY

# R op codes: how the lobe scale derives from slot values a, b.
R_NONE = 0          # lobe absent
R_ONE = 1           # 1
R_SLOT = 2          # clamp01(slot a)
R_PROD = 3          # clamp01(slot a) * clamp01(slot b)
R_ONE_MINUS = 4     # 1 - clamp01(slot a)
R_MEASURED = 5      # the measured fit's diffuse row (aux0)

# eta/k op codes.
E_NONE = 0          # eta = (1,1,1), k = 0
E_DIEL_15 = 1       # FresnelDielectric(1.5, 1)
E_DIEL_IDX = 2      # FresnelDielectric(1, slot a), the unclamped float
E_APPROX = 3        # FresnelConductor(FresnelApproxEta(slot a), 0)
E_KS = 4            # k = clamp01(slot a) (FresnelBlend's Rs)
E_PASS = 5          # FresnelDielectric(1, 1) (uber's opacity pass-through)

# p op codes (lobe p columns 0, 1).
P_NONE = 0
P_INV_A = 1         # p0 = 1/slot a (roughness -> Blinn exponent)
P_SIGMA_AB = 2      # Oren-Nayar A,B from sigma degrees in slot a
P_INV_AB = 3        # p0 = 1/slot a, p1 = 1/slot b (anisotropic)

_COLS = ("kind", "flags", "aux0", "aux1", "rop", "ra", "rb", "eop", "ea",
         "pop", "pa", "pb")


def build_templates(mats: List[Tuple[int, List[int], int]]):
    """Host-side: (kind, tex_slots, bump) list -> template column arrays."""
    M = len(mats)
    cols = {k: np.zeros((M, MAX_LOBES), np.int32) for k in _COLS}
    cols["kind"][:] = B.BX_NONE
    flip = np.zeros((M, MAX_LOBES), bool)

    def lobe(m, li, kind, flags, rop=R_ONE, ra=0, rb=0, fl=False, **kw):
        cols["kind"][m, li] = kind
        cols["flags"][m, li] = flags
        cols["rop"][m, li] = rop
        cols["ra"][m, li] = ra
        cols["rb"][m, li] = rb
        for k, v in kw.items():
            cols[k][m, li] = v
        flip[m, li] = fl

    for m, (kind, _slots, _bump) in enumerate(mats):
        if kind == MAT_MATTE:
            lobe(m, 0, B.BX_ORENNAYAR, _FL_DIFF_R, R_SLOT, 0,
                 pop=P_SIGMA_AB, pa=1)
        elif kind == MAT_PLASTIC:
            lobe(m, 0, B.BX_LAMBERTIAN, _FL_DIFF_R, R_SLOT, 0)
            lobe(m, 1, B.BX_MICROFACET, _FL_GLOS_R, R_SLOT, 1,
                 eop=E_DIEL_15, pop=P_INV_A, pa=2,
                 aux0=B.FR_DIELECTRIC, aux1=B.DIST_BLINN)
        elif kind == MAT_GLASS:
            lobe(m, 0, B.BX_SPECREFL, _FL_SPEC_R, R_SLOT, 0,
                 eop=E_DIEL_IDX, ea=2, aux0=B.FR_DIELECTRIC)
            lobe(m, 1, B.BX_SPECTRANS, _FL_SPEC_T, R_SLOT, 1,
                 eop=E_DIEL_IDX, ea=2)
        elif kind == MAT_MIRROR:
            lobe(m, 0, B.BX_SPECREFL, _FL_SPEC_R, R_SLOT, 0, aux0=B.FR_NOOP)
        elif kind == MAT_SHINYMETAL:
            lobe(m, 0, B.BX_MICROFACET, _FL_GLOS_R, R_ONE,
                 eop=E_APPROX, ea=0, pop=P_INV_A, pa=2,
                 aux0=B.FR_CONDUCTOR, aux1=B.DIST_BLINN)
            lobe(m, 1, B.BX_SPECREFL, _FL_SPEC_R, R_ONE,
                 eop=E_APPROX, ea=1, aux0=B.FR_CONDUCTOR)
        elif kind == MAT_SUBSTRATE:
            lobe(m, 0, B.BX_FRESNELBLEND, _FL_GLOS_R, R_SLOT, 0,
                 eop=E_KS, ea=1, pop=P_INV_AB, pa=2, pb=3,
                 aux1=B.DIST_ANISO)
        elif kind == MAT_TRANSLUCENT:
            lobe(m, 0, B.BX_LAMBERTIAN, _FL_DIFF_R, R_PROD, 3, 0)
            lobe(m, 1, B.BX_LAMBERTIAN, _FL_DIFF_T, R_PROD, 4, 0, fl=True)
            lobe(m, 2, B.BX_MICROFACET, _FL_GLOS_R, R_PROD, 3, 1,
                 eop=E_DIEL_15, pop=P_INV_A, pa=2,
                 aux0=B.FR_DIELECTRIC, aux1=B.DIST_BLINN)
            lobe(m, 3, B.BX_MICROFACET, _FL_GLOS_T, R_PROD, 4, 1,
                 eop=E_DIEL_15, pop=P_INV_A, pa=2,
                 aux0=B.FR_DIELECTRIC, aux1=B.DIST_BLINN, fl=True)
        elif kind == MAT_UBER:
            lobe(m, 0, B.BX_SPECTRANS, _FL_SPEC_T, R_ONE_MINUS, 4,
                 eop=E_PASS)
            lobe(m, 1, B.BX_LAMBERTIAN, _FL_DIFF_R, R_PROD, 4, 0)
            lobe(m, 2, B.BX_MICROFACET, _FL_GLOS_R, R_PROD, 4, 1,
                 eop=E_DIEL_15, pop=P_INV_A, pa=3,
                 aux0=B.FR_DIELECTRIC, aux1=B.DIST_BLINN)
            lobe(m, 3, B.BX_SPECREFL, _FL_SPEC_R, R_PROD, 4, 2,
                 eop=E_DIEL_15, aux0=B.FR_DIELECTRIC)
        elif kind >= MAT_MEASURED_BASE:
            lobe(m, 0, B.BX_LAFORTUNE, _FL_DIFF_R, R_MEASURED,
                 aux0=min(kind - MAT_MEASURED_BASE, NUM_MEASURED - 1))
        else:
            raise NotImplementedError(f"material kind {kind} is unknown")
    cols["flags"][cols["kind"] == B.BX_NONE] = 0
    kinds, aux1 = cols["kind"].ravel(), cols["aux1"].ravel()
    out = {f"t_{k}": v for k, v in cols.items()}
    out.update(t_flip=flip,
               lobe_kinds=tuple(sorted({int(k) for k in kinds
                                        if k != B.BX_NONE})),
               dist_kinds=tuple(sorted({
                   int(d) for k, d in zip(kinds, aux1)
                   if k in (B.BX_MICROFACET, B.BX_FRESNELBLEND)})))
    return out


_DIFFUSE: dict = {}


def _measured_diffuse(device):
    """The measured fits' diffuse rows f32[6, 3] on `device`."""
    tab = _DIFFUSE.get(str(device))
    if tab is None:
        from .lafortune_data import DIFFUSE
        tab = torch.from_numpy(np.asarray(DIFFUSE, np.float32)).to(device)
        _DIFFUSE[str(device)] = tab
    return tab


def make_lobes(materials, mat_id, tex_vals) -> B.LobeTable:
    """Assemble the wavefront LobeTable from templates + texture values.

    mat_id: i32[N]; tex_vals: f32[Ntex, N, 3].
    """
    n = mat_id.shape[0]
    mid = torch.clamp(mat_id, min=0).long()
    kind = materials.t_kind[mid]
    flags = materials.t_flags[mid]
    aux0 = materials.t_aux0[mid]
    rop = materials.t_rop[mid]
    eop, pop = materials.t_eop[mid], materials.t_pop[mid]
    tex_ids = materials.tex[mid].long()                  # [N, 8]
    if tex_vals.shape[0]:
        lanes = torch.arange(n, device=mat_id.device)[:, None]
        sv_raw = torch.where((tex_ids >= 0)[..., None],
                             tex_vals[torch.clamp(tex_ids, min=0), lanes],
                             0.0)                        # [N, 8, 3]
        sv = torch.clamp(sv_raw, 0.0, 1.0)
    else:
        # No texture at all (tpuprt's defaults for an empty roster).
        sv_raw = torch.ones(tex_ids.shape + (3,), device=mat_id.device)
        sv = torch.zeros_like(sv_raw)

    def slot(col, table=sv):          # col: [N, L] -> value [N, L, 3]
        return torch.gather(table, 1,
                            col[mid].long()[..., None].expand(-1, -1, 3))

    sa, sb = slot(materials.t_ra), slot(materials.t_rb)
    meas = _measured_diffuse(sa.device)[
        torch.clamp(aux0, 0, NUM_MEASURED - 1).long()]
    R = torch.where((rop == R_SLOT)[..., None], sa,
        torch.where((rop == R_PROD)[..., None], sa * sb,
        torch.where((rop == R_ONE_MINUS)[..., None], 1.0 - sa,
        torch.where((rop == R_MEASURED)[..., None], meas,
        torch.where((rop == R_ONE)[..., None], 1.0, 0.0)))))

    # eta and k. E_DIEL_IDX reads the unclamped slot: an index of
    # refraction is above 1; E_NONE and E_PASS keep eta (1, 1, 1), k 0.
    ea = slot(materials.t_ea)
    eta = torch.ones_like(R)
    eta[..., 0] = torch.where(eop == E_DIEL_15, 1.5, 1.0)
    eta[..., 1] = torch.where(eop == E_DIEL_IDX,
                              slot(materials.t_ea, sv_raw)[..., 0], 1.0)
    eta = torch.where((eop == E_APPROX)[..., None],
                      B.fresnel_approx_eta(ea), eta)
    k = torch.where((eop == E_KS)[..., None], ea, 0.0)

    pa = slot(materials.t_pa)[..., 0]
    pb = slot(materials.t_pb)[..., 0]
    sig = pa * (math.pi / 180.0)
    sig2 = sig * sig
    on = pop == P_SIGMA_AB
    inv_a = 1.0 / torch.clamp(pa, min=1e-5)
    p0 = torch.where((pop == P_INV_A) | (pop == P_INV_AB), inv_a,
                     torch.where(on, 1.0 - sig2 / (2.0 * (sig2 + 0.33)),
                                 0.0))
    p1 = torch.where(on, 0.45 * sig2 / (sig2 + 0.09),
                     torch.where(pop == P_INV_AB,
                                 1.0 / torch.clamp(pb, min=1e-5), 0.0))
    # Blinn exponent cap (reflection.h:313).
    p = torch.clamp(torch.stack([p0, p1], dim=-1), max=10000.0)

    # Disable exactly-black lobes (the reference's conditional Add()); a
    # FresnelBlend lobe lives while Rd or Rs is not black.
    black = torch.all(R == 0.0, dim=-1)
    dead = torch.where(kind == B.BX_FRESNELBLEND,
                       black & torch.all(k == 0.0, dim=-1), black)
    dead = dead | (kind == B.BX_NONE)
    return B.LobeTable(kind=torch.where(dead, B.BX_NONE, kind),
                       flags=torch.where(dead, 0, flags),
                       flip=materials.t_flip[mid], R=R, p=p, eta=eta, k=k,
                       aux0=aux0, aux1=materials.t_aux1[mid],
                       kinds_present=materials.lobe_kinds,
                       dist_kinds=materials.dist_kinds)
