"""The threefry-2x32 draws of jax.random that the boundary estimators make
(diff/silhouette.py), bit for bit as JAX gives them with its default
``jax_threefry_partitionable=True``: PRNGKey, split and uniform of f32.

A key is an int64 tensor [2] holding two uint32 words, as JAX's legacy
uint32[2] key. torch has few uint32 ops, so the words run in int64 masked to
32 bits (as core/rng.py does); no intermediate leaves int64's range.

- PRNGKey(seed): the words (seed >> 32, seed & 0xFFFFFFFF) of the seed as
  an int32, whose high word is 0.
- split(key, num): threefry2x32(key, counters) over the 64-bit counters
  0..num-1 split into a high word (0 here) and a low word; the new keys
  are the two output words of each counter.
- uniform(key, (M,)): the same hash over counters 0..M-1, bits1 ^ bits2
  (the partitionable layout's 32-bit draw), the top 23 bits as the
  mantissa of a float in [1, 2), minus 1.
"""
from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 block cipher of 20 rounds (Salmon et al. 2011) as
    jax._src.prng's threefry2x32 computes it: key words k1, k2 (int64
    scalars or tensors of uint32 values), counter words x0, x1."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def PRNGKey(seed: int, device="cpu"):
    """jax.random.PRNGKey(seed) for a seed in int32's range."""
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed {seed} is outside int32")
    return torch.tensor([0, seed & _M32], dtype=torch.int64, device=device)


def _hash_iota(key, n: int):
    """threefry2x32 of `key` over the counters 0..n-1 (high words 0)."""
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)


def split(key, num: int = 2):
    """jax.random.split(key, num): int64 [num, 2]."""
    b1, b2 = _hash_iota(key, num)
    return torch.stack([b1, b2], dim=-1)


def uniform(key, shape):
    """jax.random.uniform(key, shape) of f32 in [0, 1)."""
    n = math.prod(shape)
    b1, b2 = _hash_iota(key, n)
    bits = ((b1 ^ b2) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(f, min=0.0).reshape(shape)
