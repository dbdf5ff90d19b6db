"""Counter-based sample streams: every value is a pure function of integer
counters (pixel, sample index, bounce, purpose).

uint32 arithmetic runs in int64 masked to 32 bits. The streams are the
renderer's stated sampling semantics: a 32-bit avalanche hash over the
counters, pbrt-v1's scrambled (0,2)-sequence (van der Corput x Sobol')
for the low-discrepancy sampler (core/sampling.h), scrambled per pixel
and dimension.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
ONE_MINUS_EPS = 0.9999999403953552          # the largest f32 below 1


def as_u32(x):
    if isinstance(x, int):
        return x & M32
    return x.to(torch.int64) & M32


def mul32(x, c: int):
    """(x * c) mod 2^32 for x < 2^32 without leaving int64: c in halves."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def avalanche(x):
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def hash32(*counters):
    h = GOLDEN
    for c in counters:
        h = avalanche((as_u32(c) + h) & M32)
    return h


def uniform(*counters):
    """f32 in [0, 1): the top 24 bits of the hash."""
    bits = hash32(*counters)
    return torch.clamp((bits >> 8).to(torch.float32) * (1.0 / (1 << 24)),
                       max=ONE_MINUS_EPS)


def _unit(bits):
    return torch.clamp(bits.to(torch.float32) * 2.0 ** -32,
                       max=ONE_MINUS_EPS)


def _bit_reverse(n):
    out = torch.zeros_like(n)
    for i in range(32):
        out = out | (((n >> i) & 1) << (31 - i))
    return out


def _sobol_dir(i: int) -> int:
    v = 1 << 31
    for _ in range(i):
        v ^= v >> 1
    return v


def _sobol2(n):
    out = torch.zeros_like(n)
    top = int(n.max()) if n.numel() else 0
    for i in range(top.bit_length()):
        out = out ^ (((n >> i) & 1) * _sobol_dir(i))
    return out


def vdc(n, scramble):
    return _unit(_bit_reverse(as_u32(n)) ^ as_u32(scramble))


def sobol(n, scramble):
    return _unit(_sobol2(as_u32(n)) ^ as_u32(scramble))


def ld1(s_idx, pixel_hash, dim):
    return vdc(s_idx, hash32(pixel_hash, dim, 0x1D1D1D1D))


def ld2(s_idx, pixel_hash, dim):
    return (vdc(s_idx, hash32(pixel_hash, dim, 0x2D2D2D2D)),
            sobol(s_idx, hash32(pixel_hash, dim, 0x3D3D3D3D)))


def pixel_hash(px, py, seed):
    return hash32(px, py, seed, 0xC0FFEE)


def camera_sample(px, py, s_idx, seed):
    """(image_x, image_y) of the low-discrepancy sampler: the pixel's
    corner plus its scrambled (0,2) sample of dimension 0."""
    ph = pixel_hash(px, py, seed)
    jx, jy = ld2(s_idx, ph, 0)
    return px.to(torch.float32) + jx, py.to(torch.float32) + jy


def sample1(px, py, s_idx, bounce, purpose, seed):
    """One integrator dimension (Sample::oneD) at (bounce, purpose)."""
    return ld1(s_idx, pixel_hash(px, py, seed), hash32(bounce, purpose, 0x1D))


def sample2(px, py, s_idx, bounce, purpose, seed):
    """One integrator pair (Sample::twoD) at (bounce, purpose)."""
    return ld2(s_idx, pixel_hash(px, py, seed), hash32(bounce, purpose, 0x2D))
