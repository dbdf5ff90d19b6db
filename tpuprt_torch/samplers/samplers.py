"""Deterministic, order-invariant samples (port of
tpuprt/samplers/samplers.py: the stratified, random, lowdiscrepancy and
bestcandidate samplers).

Every sample dimension is a pure function of (pixel, sample index,
bounce, purpose), from counter-based hashes (core/rng.py, uint32 emulated
in int64) or per-pixel scrambled (0,2)-sequences, so a sample here equals
the JAX package's bit for bit:
  stratified     -- jittered xs x ys strata (samplers/stratified.cpp),
                    no power-of-two rounding;
  random         -- hash uniforms (samplers/random.cpp);
  lowdiscrepancy -- scrambled (0,2)-sequences (lowdiscrepancy.cpp:76-128);
  bestcandidate  -- the baked 4096-entry table (``bc_table.npy``, a copy
                    of tpuprt's): the image tiles into squares the whole
                    table covers, a pixel's s-th sample is the s-th entry
                    landing in it, and cells the table left short fall
                    back to the (0,2)-sequences.
Each draws the image position, the lens sample and the shutter time.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core import rng
from . import bc_gen

KINDS = ("stratified", "random", "lowdiscrepancy", "bestcandidate")


class SamplerConfig(NamedTuple):
    kind: str = "lowdiscrepancy"
    xsamples: int = 2
    ysamples: int = 2
    jitter: bool = True
    pixelsamples: int = 4


def check(cfg: SamplerConfig):
    if cfg.kind not in KINDS:
        raise NotImplementedError(f'sampler "{cfg.kind}" is not ported')


def round_size(cfg: SamplerConfig, n: int) -> int:
    """Sampler::RoundSize: the (0,2)-sequence samplers round to a power of
    two (lowdiscrepancy.cpp:44-46)."""
    if cfg.kind in ("lowdiscrepancy", "bestcandidate"):
        p = 1
        while p < n:
            p *= 2
        return p
    return n


def samples_per_pixel(cfg: SamplerConfig) -> int:
    check(cfg)
    if cfg.kind == "stratified":
        return cfg.xsamples * cfg.ysamples
    return round_size(cfg, cfg.pixelsamples)


def _pixel_hash(px, py, seed=0):
    return rng.hash_u32(px, py, seed, 0xC0FFEE)


_BC_CACHE: dict = {}


def bc_tables(spp: int, device):
    """(tile width, cell -> entry map i32[tw*tw, spp], fallback mask,
    table f32[4096, 5]) for the best-candidate sampler at spp
    (tpuprt/samplers/samplers.py:156-183)."""
    key = (spp, str(device))
    got = _BC_CACHE.get(key)
    if got is not None:
        return got
    t = bc_gen.load_table()
    n = len(t)
    tw = max(int(round(math.sqrt(n / max(spp, 1)))), 1)
    cells = np.minimum((t[:, 0:2] * tw).astype(np.int64), tw - 1)
    cell_id = cells[:, 1] * tw + cells[:, 0]
    emap = np.zeros((tw * tw, spp), np.int32)
    efall = np.ones((tw * tw, spp), bool)
    fill = np.zeros(tw * tw, np.int32)
    for e, c in enumerate(cell_id):
        k = fill[c]
        if k < spp:
            emap[c, k] = e
            efall[c, k] = False
            fill[c] += 1
    got = (tw, torch.from_numpy(emap).to(device),
           torch.from_numpy(efall).to(device),
           torch.from_numpy(t.astype(np.float32)).to(device))
    _BC_CACHE[key] = got
    return got


def _strat_shuffled(ph, s_idx, n, dim):
    """A hash-keyed permutation of s_idx within [0, n), keyed on (pixel,
    dim) (samplers.py:186-194): three rounds of add and multiply mod n,
    each sum and product wrapping mod 2^32 first, as tpuprt's uint32 do."""
    k = rng.hash_u32(ph, dim, 0x5EED)
    m = max(n, 1)
    # hash_u32(k, r) for the three rounds, sharing its first mix of k.
    h = rng.hash_u32(k)
    x = rng.u32(s_idx)
    for r in range(3):
        x = ((x + k) & rng._M32) % m
        # x < m, so x * 2654435761 stays inside int64.
        x = ((x * 2654435761 + rng._mix((r + h) & rng._M32)) & rng._M32) % m
    return x.to(torch.float32)


def camera_samples(cfg: SamplerConfig, px, py, s_idx, seed=0):
    """Camera-sample dimensions of (pixel, sample index): dict(image_x,
    image_y, lens_u, lens_v, time)."""
    check(cfg)
    ph = _pixel_hash(px, py, seed)
    fx = px.to(torch.float32)
    fy = py.to(torch.float32)
    if cfg.kind == "stratified":
        xs, ys = cfg.xsamples, cfg.ysamples
        sx = (s_idx % xs).to(torch.float32)
        sy = torch.div(s_idx, xs, rounding_mode="floor").to(torch.float32)
        half = torch.full(px.shape, 0.5, dtype=torch.float32,
                          device=px.device)
        if cfg.jitter:
            jx = rng.uniform(ph, s_idx, 0)
            jy = rng.uniform(ph, s_idx, 1)
        else:
            jx = jy = half
        # Lens and time: per-pixel shuffled strata, decorrelated from the
        # image strata (stratified.cpp:51-131).
        n = xs * ys
        perm_l = _strat_shuffled(ph, s_idx, n, 2)
        perm_t = _strat_shuffled(ph, s_idx, n, 3)
        ju, jv, jt = ((rng.uniform(ph, s_idx, 4), rng.uniform(ph, s_idx, 5),
                       rng.uniform(ph, s_idx, 6)) if cfg.jitter
                      else (half, half, half))
        return dict(image_x=fx + (sx + jx) / xs, image_y=fy + (sy + jy) / ys,
                    lens_u=(perm_l + ju) / n, lens_v=(perm_t + jv) / n,
                    time=(perm_l + jt) / n)
    if cfg.kind == "random":
        return dict(image_x=fx + rng.uniform(ph, s_idx, 0),
                    image_y=fy + rng.uniform(ph, s_idx, 1),
                    lens_u=rng.uniform(ph, s_idx, 2),
                    lens_v=rng.uniform(ph, s_idx, 3),
                    time=rng.uniform(ph, s_idx, 4))
    ix, iy = rng.ld_shuffled_2d(s_idx, ph, 0)
    lu, lv = rng.ld_shuffled_2d(s_idx, ph, 1)
    tm = rng.ld_shuffled_1d(s_idx, ph, 2)
    if cfg.kind == "lowdiscrepancy":
        return dict(image_x=fx + ix, image_y=fy + iy, lens_u=lu, lens_v=lv,
                    time=tm)
    # Best candidate: the entry's position inside its tile and its time and
    # lens shifted toroidally per tile (bestcandidate.cpp:121-136), unless
    # the table left this (cell, sample) short: then the (0,2)-sequences.
    tw, emap, efall, tab = bc_tables(samples_per_pixel(cfg), px.device)
    cx = px % tw
    cy = py % tw
    cell = (cy * tw + cx).long()
    si = torch.clamp(s_idx, 0, emap.shape[1] - 1).long()
    row = tab[emap[cell, si].long()]
    fall = efall[cell, si]
    th = rng.hash_u32(torch.div(px, tw, rounding_mode="floor"),
                      torch.div(py, tw, rounding_mode="floor"), seed, 0xBC)

    def wrap(col, k):
        v = row[..., col] + rng.uniform(th, 0, k)
        return torch.where(v > 1.0, v - 1.0, v)
    ex = (px - cx).to(torch.float32) + row[..., 0] * tw
    ey = (py - cy).to(torch.float32) + row[..., 1] * tw
    return dict(image_x=torch.where(fall, fx + ix, ex),
                image_y=torch.where(fall, fy + iy, ey),
                lens_u=torch.where(fall, lu, wrap(3, 1)),
                lens_v=torch.where(fall, lv, wrap(4, 2)),
                time=torch.where(fall, tm, wrap(2, 0)))


def integrator_1d(cfg: SamplerConfig, px, py, s_idx, bounce, purpose, seed=0):
    """One integrator-requested 1D sample (Sample::oneD analogue)."""
    check(cfg)
    ph = _pixel_hash(px, py, seed)
    dim = rng.hash_u32(bounce, purpose, 0x1D)
    if cfg.kind == "random":
        return rng.uniform(ph, s_idx, dim)
    return rng.ld_shuffled_1d(s_idx, ph, dim)


def integrator_2d(cfg: SamplerConfig, px, py, s_idx, bounce, purpose, seed=0):
    """One integrator-requested 2D sample (Sample::twoD analogue)."""
    check(cfg)
    ph = _pixel_hash(px, py, seed)
    dim = rng.hash_u32(bounce, purpose, 0x2D)
    if cfg.kind == "random":
        return rng.uniform(ph, s_idx, dim, 0), rng.uniform(ph, s_idx, dim, 1)
    return rng.ld_shuffled_2d(s_idx, ph, dim)
