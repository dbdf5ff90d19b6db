"""Counter-based random and quasi-random numbers (port of tpuprt/core/rng.py).

Every random decision is a pure function of integer counters (pixel, sample
index, bounce, purpose), so a sample computes the same value here as in the
JAX package, bit for bit. torch has few uint32 ops, so the uint32 arithmetic
runs in int64 masked to 32 bits; products are split into 16-bit halves so no
intermediate leaves int64's range.
"""
from __future__ import annotations

import functools
import operator

import numpy as np
import torch

_M32 = 0xFFFFFFFF
ONE_MINUS_EPS = 0.9999999403953552  # largest float < 1


def u32(x):
    """Counter(s) as int64 holding the uint32 bit pattern (int32 -1 ->
    0xFFFFFFFF, as JAX's astype(uint32) gives). Python ints stay ints, so
    constant counters never pin a result to the CPU."""
    if isinstance(x, int):
        return x & _M32
    return x.to(torch.int64) & _M32


def _mul32(x, c: int):
    """(x * c) mod 2^32 for x < 2^32, without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix(x):
    """xxhash/PCG-style 32-bit avalanche (rng.py:25-33)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def hash_u32(*counters):
    """Combine integer counters into one well-mixed uint32 (as int64)."""
    h = 0x9E3779B9
    for c in counters:
        h = _mix((u32(c) + h) & _M32)
    return h


def uniform(*counters) -> torch.Tensor:
    """f32 uniform in [0,1) keyed purely on the given integer counters."""
    bits = hash_u32(*counters)
    return torch.clamp((bits >> 8).to(torch.float32) * (1.0 / (1 << 24)),
                       max=ONE_MINUS_EPS)


def _reverse_bits32(n):
    n = ((n << 16) | (n >> 16)) & _M32
    n = ((n & 0x00FF00FF) << 8) | ((n & 0xFF00FF00) >> 8)
    n = ((n & 0x0F0F0F0F) << 4) | ((n & 0xF0F0F0F0) >> 4)
    n = ((n & 0x33333333) << 2) | ((n & 0xCCCCCCCC) >> 2)
    n = ((n & 0x55555555) << 1) | ((n & 0xAAAAAAAA) >> 1)
    return n


def _to_unit(bits):
    return torch.clamp(bits.to(torch.float32) * 2.3283064365386963e-10,
                       max=ONE_MINUS_EPS)


def van_der_corput(n, scramble=0):
    """Base-2 radical inverse with bit-XOR scramble (core/sampling.h:131-141)."""
    n = u32(n)
    return _to_unit(_reverse_bits32(n) ^ u32(scramble))


def _sobol2_dirs():
    dirs = []
    v = 1 << 31
    for _ in range(32):
        dirs.append(v)
        v ^= v >> 1
    return tuple(dirs)


_SOBOL2_DIRS = _sobol2_dirs()
# The XOR of the direction numbers of each byte's set bits, byte k of n
# at row k: sobol2's 32-step loop as four table lookups, bit for bit.
_SOBOL2_BYTES = np.asarray(
    [[functools.reduce(operator.xor, [_SOBOL2_DIRS[8 * k + i]
                                      for i in range(8) if b >> i & 1], 0)
      for b in range(256)] for k in range(4)], np.int64)
_SOBOL2_TABLES: dict = {}


def sobol2(n, scramble=0):
    """Second dimension of the Sobol' (0,2)-sequence (core/sampling.h:142-152)."""
    n = u32(n)
    tab = _SOBOL2_TABLES.get(str(n.device))
    if tab is None:
        tab = torch.from_numpy(_SOBOL2_BYTES).to(n.device)
        _SOBOL2_TABLES[str(n.device)] = tab
    out = tab[0][n & 0xFF]
    for k in range(1, 4):
        out = out ^ tab[k][(n >> (8 * k)) & 0xFF]
    return _to_unit(out ^ u32(scramble))


def sample02(n, scramble_x=0, scramble_y=0):
    """(0,2)-sequence sample: VdC x Sobol' (core/sampling.h:109-117)."""
    return van_der_corput(n, scramble_x), sobol2(n, scramble_y)


def ld_shuffled_1d(sample_idx, pixel_hash, dim):
    """LDShuffleScrambled1D semantics: per-(pixel,dim) scrambled VdC."""
    return van_der_corput(sample_idx, hash_u32(pixel_hash, dim, 0x1D1D1D1D))


def ld_shuffled_2d(sample_idx, pixel_hash, dim):
    """LDShuffleScrambled2D semantics: per-(pixel,dim) scrambled (0,2)-seq."""
    sx = hash_u32(pixel_hash, dim, 0x2D2D2D2D)
    sy = hash_u32(pixel_hash, dim, 0x3D3D3D3D)
    return sample02(sample_idx, sx, sy)


def uniform2(*counters):
    """Two decorrelated uniforms from one counter set (rng.py:52-54)."""
    return uniform(*counters, 0x55AA55AA), uniform(*counters, 0x33CC33CC)


def radical_inverse(n, base: int) -> torch.Tensor:
    """RadicalInverse(n, base) (core/sampling.h:83-94; rng.py:61-75): n an
    int tensor holding uint32 ids below 2^31, a digit loop in f32 in the
    reference's order (val += d * inv_bi; inv_bi *= inv_base)."""
    n = n.to(torch.int64)
    inv_base = torch.tensor(float(np.float32(1.0 / base)),
                            dtype=torch.float32, device=n.device)
    val = torch.zeros(n.shape, dtype=torch.float32, device=n.device)
    inv_bi = inv_base.expand(n.shape)
    for _ in range(int(np.ceil(32 / np.log2(base)))):
        val = val + (n % base).to(torch.float32) * inv_bi
        n = n // base
        inv_bi = inv_bi * inv_base
    return val
