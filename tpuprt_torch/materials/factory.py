"""Material -> BSDF lobe assembly via build-time templates (port of
tpuprt/materials/factory.py for the matte, plastic, glass and mirror
materials).

`build_templates` compiles each material's lobe structure into [M, L]
op-code columns on the host; `make_lobes` assembles a shading wavefront's
LobeTable from those columns and the evaluated texture slots. Slots:
  matte:   0 = Kd, 1 = sigma (matte.cpp:46-64; sigma 0 reduces Oren-Nayar
           to exact Lambertian, A=1, B=0)
  plastic: 0 = Kd, 1 = Ks, 2 = roughness (plastic.cpp:46-68: a Lambertian
           lobe and a microfacet lobe with dielectric Fresnel 1.5 and a
           Blinn exponent 1/roughness)
  glass:   0 = Kr, 1 = Kt, 2 = index (glass.cpp:46-63: specular
           reflection with dielectric Fresnel and specular transmission,
           both between 1 and the index)
  mirror:  0 = Kr (mirror.cpp: specular reflection, no Fresnel)
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
MAX_LOBES = 4
MATERIAL_KINDS = {"matte": MAT_MATTE, "plastic": MAT_PLASTIC,
                  "glass": MAT_GLASS, "mirror": MAT_MIRROR}

# Op codes, as in the reference: R (lobe scale), eta/k and p (lobe
# parameters).
R_SLOT = 2          # clamp01(slot a)
E_DIEL_15 = 1       # FresnelDielectric(1.5, 1)
E_DIEL_IDX = 2      # FresnelDielectric(1, slot a), the unclamped float
P_INV_A = 1         # p0 = 1/slot a (roughness -> Blinn exponent)
P_SIGMA_AB = 2      # Oren-Nayar A,B from sigma degrees in slot a


def build_templates(mats: List[Tuple[int, List[int], int]]):
    """Host-side: (kind, tex_slots, bump) list -> template column arrays."""
    M = len(mats)
    cols = {k: np.zeros((M, MAX_LOBES), np.int32) for k in
            ("kind", "flags", "aux0", "aux1", "rop", "ra", "rb",
             "eop", "ea", "pop", "pa", "pb")}
    cols["kind"][:] = B.BX_NONE

    def lobe(m, li, kind, flags, ra, **kw):
        cols["kind"][m, li] = kind
        cols["flags"][m, li] = flags
        cols["rop"][m, li] = R_SLOT
        cols["ra"][m, li] = ra
        for k, v in kw.items():
            cols[k][m, li] = v

    for m, (kind, _slots, _bump) in enumerate(mats):
        if kind == MAT_MATTE:
            lobe(m, 0, B.BX_ORENNAYAR, B.REFLECTION | B.DIFFUSE, 0,
                 pop=P_SIGMA_AB, pa=1)
        elif kind == MAT_PLASTIC:
            lobe(m, 0, B.BX_LAMBERTIAN, B.REFLECTION | B.DIFFUSE, 0)
            lobe(m, 1, B.BX_MICROFACET, B.REFLECTION | B.GLOSSY, 1,
                 eop=E_DIEL_15, pop=P_INV_A, pa=2, aux0=B.FR_DIELECTRIC,
                 aux1=B.DIST_BLINN)
        elif kind == MAT_GLASS:
            lobe(m, 0, B.BX_SPECREFL, B.REFLECTION | B.SPECULAR, 0,
                 eop=E_DIEL_IDX, ea=2, aux0=B.FR_DIELECTRIC)
            lobe(m, 1, B.BX_SPECTRANS, B.TRANSMISSION | B.SPECULAR, 1,
                 eop=E_DIEL_IDX, ea=2)
        elif kind == MAT_MIRROR:
            lobe(m, 0, B.BX_SPECREFL, B.REFLECTION | B.SPECULAR, 0,
                 aux0=B.FR_NOOP)
        else:
            raise NotImplementedError(f"material kind {kind} is not ported")
    kinds, aux1 = cols["kind"].ravel(), cols["aux1"].ravel()
    out = {f"t_{k}": v for k, v in cols.items()}
    out.update(t_flip=np.zeros((M, MAX_LOBES), bool),
               lobe_kinds=tuple(sorted({int(k) for k in kinds
                                        if k != B.BX_NONE})),
               dist_kinds=tuple(sorted({int(d) for k, d in zip(kinds, aux1)
                                        if k == B.BX_MICROFACET})))
    return out


def make_lobes(materials, mat_id, tex_vals) -> B.LobeTable:
    """Assemble the wavefront LobeTable from templates + texture values.

    mat_id: i32[N]; tex_vals: f32[Ntex, N, 3].
    """
    n = mat_id.shape[0]
    mid = torch.clamp(mat_id, min=0).long()
    kind = materials.t_kind[mid]
    flags = materials.t_flags[mid]
    rop, c_ra = materials.t_rop[mid], materials.t_ra[mid]
    pop, c_pa = materials.t_pop[mid], materials.t_pa[mid]
    eop, c_ea = materials.t_eop[mid], materials.t_ea[mid]
    tex_ids = materials.tex[mid].long()                  # [N, 8]
    lanes = torch.arange(n, device=mat_id.device)[:, None]
    sv_raw = torch.where((tex_ids >= 0)[..., None],
                         tex_vals[torch.clamp(tex_ids, min=0), lanes],
                         0.0)                            # [N, 8, 3]
    sv = torch.clamp(sv_raw, 0.0, 1.0)

    def slot(col, table=sv):          # col: [N, L] -> value [N, L, 3]
        return torch.gather(table, 1,
                            col.long()[..., None].expand(-1, -1, 3))

    # build_templates makes matte, plastic, glass and mirror rows only, so
    # R_SLOT, E_DIEL_15, E_DIEL_IDX, P_INV_A and P_SIGMA_AB are the only
    # ops present; absent lobes get 0 as R_NONE/P_NONE give, eta (1, 1, 1)
    # and k 0 as E_NONE. E_DIEL_IDX reads the unclamped slot: an index of
    # refraction is above 1.
    R = torch.where((rop == R_SLOT)[..., None], slot(c_ra), 0.0)
    eta = torch.ones_like(R)
    eta[..., 0] = torch.where(eop == E_DIEL_15, 1.5, 1.0)
    eta[..., 1] = torch.where(eop == E_DIEL_IDX, slot(c_ea, sv_raw)[..., 0],
                              1.0)
    pa = slot(c_pa)[..., 0]
    sig = pa * (math.pi / 180.0)
    sig2 = sig * sig
    on = pop == P_SIGMA_AB
    p0 = torch.where(pop == P_INV_A, 1.0 / torch.clamp(pa, min=1e-5),
                     torch.where(on, 1.0 - sig2 / (2.0 * (sig2 + 0.33)),
                                 0.0))
    # Blinn exponent cap (reflection.h:313).
    p0 = torch.clamp(p0, max=10000.0)
    p1 = torch.clamp(torch.where(on, 0.45 * sig2 / (sig2 + 0.09), 0.0),
                     max=10000.0)
    # Disable exactly-black lobes (the reference's conditional Add()).
    dead = torch.all(R == 0.0, dim=-1) | (kind == B.BX_NONE)
    kind = torch.where(dead, B.BX_NONE, kind)
    flags = torch.where(dead, 0, flags)
    return B.LobeTable(kind=kind, flags=flags, R=R,
                       p=torch.stack([p0, p1], dim=-1), eta=eta,
                       k=torch.zeros_like(R), aux0=materials.t_aux0[mid],
                       aux1=materials.t_aux1[mid],
                       kinds_present=materials.lobe_kinds,
                       dist_kinds=materials.dist_kinds)
