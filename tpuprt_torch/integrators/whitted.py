"""Whitted integrator, the scan form (port of tpuprt/integrators/
whitted.py:28-137; pbrt-v1 integrators/whitted.cpp:44-140), through the
chunked driver's loop (common.scan_li): at each depth every light with one
sample and no MIS (common.whitted_ld), then one specular continuation
picked stochastically, which carries the ray differentials, so texture
filtering through mirrors and glass keeps its footprint. The pool's mode
"whitted" computes the same samples."""
from __future__ import annotations

import torch

from ..core import rng
from ..scene.data import SceneData
from . import common

SALT = 0x817    # the per-pixel hash's salt (whitted.py:36)


def li(scene: SceneData, o, d, mint, maxt, cfg, px, py, s_idx,
       max_depth: int = 5, seed: int = 0, rx=None, ry=None):
    """(L, alpha, t_first) of camera rays (o, d, mint, maxt) with ids (px,
    py, s_idx); rx, ry: the +x/+y differential rays (o, d) or None."""
    ph = rng.hash_u32(px, py, seed, SALT)

    def shade(depth, idx, ph_l, s_l, dg, bsdf, wo, tp):
        live = torch.ones_like(s_l, dtype=torch.bool)
        yield tp * common.whitted_ld(scene, dg["p"], bsdf.nn, wo, bsdf, ph_l,
                                     s_l, depth, live)

    return common.scan_li(scene, o, d, mint, maxt, rx, ry, ph, s_idx,
                          max_depth + 1, max_depth, shade,
                          carry_differentials=True)
