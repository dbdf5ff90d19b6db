"""Debug channel-visualizer integrator (port of tpuprt/integrators/
debug.py; pbrt-v1 integrators/debug.cpp): the RGB channels show chosen
quantities at the nearest hit (u, v, the geometric and shading normals'
components mapped to [0, 1], t, the hit mask, one, zero, the material
id)."""
from __future__ import annotations

import torch

from ..accel import intersect as isect
from ..scene.data import SceneData

CHANNELS = ("u", "v", "nx", "ny", "nz", "snx", "sny", "snz", "t", "hit",
            "one", "zero", "matid")


def li(scene: SceneData, o, d, mint, maxt, channels=("u", "v", "hit")):
    """(L f32[N,3], alpha f32[N], t_first f32[N]): the first three of
    `channels` (padded with "zero") as R, G, B; alpha the hit mask."""
    t, pid, hit = isect.intersect_ids(scene, o, d, mint, maxt)
    dg = isect.hit_geometry(scene, pid, o, d, t)
    hitf = hit.to(torch.float32)

    def chan(name):
        if name in ("u", "v"):
            return dg[name] * hitf
        if name in ("nx", "ny", "nz"):
            return (dg["nn"][..., "xyz".index(name[1])] * 0.5 + 0.5) * hitf
        if name in ("snx", "sny", "snz"):
            return (dg["sn"][..., "xyz".index(name[2])] * 0.5 + 0.5) * hitf
        if name == "t":
            return torch.where(hit, t, 0.0)
        if name == "hit":
            return hitf
        if name == "one":
            return torch.ones_like(hitf)
        if name == "zero":
            return torch.zeros_like(hitf)
        if name == "matid":
            return dg["material"].to(torch.float32) * hitf
        raise ValueError(f"unknown debug channel {name}")

    L = torch.stack([chan(c) for c in (list(channels) + ["zero"] * 3)[:3]],
                    -1)
    return L, hitf, torch.where(hit, t, maxt)
