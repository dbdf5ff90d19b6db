"""Direct-lighting integrator, the scan form (port of tpuprt/integrators/
directlighting.py:28-131; pbrt-v1 integrators/directlighting.cpp), through
the chunked driver's loop (common.scan_li): at each depth the strategy's
direct lighting (common.direct_ld: "all", "one" or "weighted", the
sampler's purposes 10-13, 16 and 100 + 4i...), then one specular
continuation picked stochastically. The pool's mode "directlighting"
computes the same samples."""
from __future__ import annotations

import torch

from ..core import rng
from ..scene.data import SceneData
from . import common

SALT = 0xD112    # the per-pixel hash's salt (directlighting.py:33)


def li(scene: SceneData, o, d, mint, maxt, cfg, px, py, s_idx,
       max_depth: int = 5, seed: int = 0, strategy: str = "all", rx=None,
       ry=None):
    """(L, alpha, t_first) of camera rays (o, d, mint, maxt) with ids (px,
    py, s_idx); rx, ry: the +x/+y differential rays (o, d) or None.
    "weighted" builds its light distribution once a call."""
    ph = rng.hash_u32(px, py, seed, SALT)
    sel = common.weighted_selection(scene) \
        if strategy == "weighted" and scene.lights.count else None

    def shade(depth, idx, ph_l, s_l, dg, bsdf, wo, tp):
        if scene.lights.count:
            yield tp * common.direct_ld(
                scene, cfg, strategy, sel, dg["p"], bsdf.nn, wo, bsdf, ph_l,
                px[idx], py[idx], s_l, depth, seed,
                torch.ones_like(s_l, dtype=torch.bool))

    return common.scan_li(scene, o, d, mint, maxt, rx, ry, ph, s_idx,
                          max_depth + 1, max_depth, shade)
