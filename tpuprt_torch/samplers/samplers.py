"""Deterministic, order-invariant samples (port of
tpuprt/samplers/samplers.py for the lowdiscrepancy sampler).

Every sample dimension is a pure function of (pixel, sample index,
bounce, purpose): per-pixel scrambled (0,2)-sequences
(samplers/lowdiscrepancy.cpp:76-128), so a sample here equals the JAX
package's bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import rng


class SamplerConfig(NamedTuple):
    kind: str = "lowdiscrepancy"
    xsamples: int = 2
    ysamples: int = 2
    jitter: bool = True
    pixelsamples: int = 4


def check(cfg: SamplerConfig):
    if cfg.kind != "lowdiscrepancy":
        raise NotImplementedError(
            f'sampler "{cfg.kind}" is not ported (lowdiscrepancy only)')


def samples_per_pixel(cfg: SamplerConfig) -> int:
    """Sampler::RoundSize — LD rounds to a power of two
    (lowdiscrepancy.cpp:44-46)."""
    check(cfg)
    p = 1
    while p < cfg.pixelsamples:
        p *= 2
    return p


def _pixel_hash(px, py, seed=0):
    return rng.hash_u32(px, py, seed, 0xC0FFEE)


def camera_samples(cfg: SamplerConfig, px, py, s_idx, seed=0):
    """Image-plane position of (pixel, sample index): dict(image_x,
    image_y). The lens and time dimensions feed only features the port
    does not have (thin lens, motion), so they are not drawn."""
    check(cfg)
    ix, iy = rng.ld_shuffled_2d(s_idx, _pixel_hash(px, py, seed), 0)
    return dict(image_x=px.to(torch.float32) + ix,
                image_y=py.to(torch.float32) + iy)


def integrator_1d(cfg: SamplerConfig, px, py, s_idx, bounce, purpose, seed=0):
    """One integrator-requested 1D sample (Sample::oneD analogue)."""
    check(cfg)
    dim = rng.hash_u32(bounce, purpose, 0x1D)
    return rng.ld_shuffled_1d(s_idx, _pixel_hash(px, py, seed), dim)


def integrator_2d(cfg: SamplerConfig, px, py, s_idx, bounce, purpose, seed=0):
    """One integrator-requested 2D sample (Sample::twoD analogue)."""
    check(cfg)
    dim = rng.hash_u32(bounce, purpose, 0x2D)
    return rng.ld_shuffled_2d(s_idx, _pixel_hash(px, py, seed), dim)
