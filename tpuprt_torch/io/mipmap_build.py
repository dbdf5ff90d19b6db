"""Host-side MIP pyramid construction (port of tpuprt/io/mipmap_build.py;
MIPMap's constructor, core/mipmap.h:93-161): an image whose sides are not
powers of two is resampled up to the next ones with the Lanczos-windowed
sinc (core/mipmap.h:115-141), then reduced by 2x2 boxes down to 1x1.
Plain numpy with the reference's exact operations, so a pyramid equals
tpuprt's bit for bit; it runs once at scene build.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def lanczos_np(x, tau=2.0):
    """Windowed sinc for host-side resampling (core/texture.cpp:241-249)."""
    x = np.abs(x)
    s = np.where(x < 1e-5, 1.0, np.sin(np.pi * x * tau) /
                 np.maximum(np.pi * x * tau, 1e-9))
    lanc = np.where(x < 1e-5, 1.0, np.sin(np.pi * x) /
                    np.maximum(np.pi * x, 1e-9))
    return np.where(x > 1.0, 0.0, s * lanc)


def _round_up_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def _resample_axis(img: np.ndarray, new_n: int, axis: int) -> np.ndarray:
    """1D Lanczos resample along `axis`: filter width 2, the reference's
    4-tap ResampleWeights."""
    old_n = img.shape[axis]
    if old_n == new_n:
        return img
    filterwidth = 2.0
    center = (np.arange(new_n) + 0.5) * old_n / new_n
    first = np.floor(center - filterwidth + 0.5).astype(np.int64)
    idx = first[:, None] + np.arange(4)[None, :]          # [new_n, 4]
    w = lanczos_np((idx + 0.5 - center[:, None]) / filterwidth)
    w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-8)
    idx = np.clip(idx, 0, old_n - 1)
    taps = np.moveaxis(img, axis, 0)[idx]                 # [new_n, 4, ...]
    extra = (1,) * (taps.ndim - 2)
    res = (taps * w.reshape(w.shape + extra)).sum(axis=1)
    return np.moveaxis(res, 0, axis)


def build_pyramid(rgb: np.ndarray) -> Tuple[np.ndarray, ...]:
    """f32[h,w,3] -> the tuple of power-of-two levels down to 1x1. An axis
    already at 1 stops reducing (nLevels = 1 + log2(max(w, h)))."""
    img = np.asarray(rgb, np.float32)
    h, w = img.shape[:2]
    ph, pw = _round_up_pow2(h), _round_up_pow2(w)
    if (ph, pw) != (h, w):
        img = _resample_axis(img, pw, 1)
        img = _resample_axis(img, ph, 0)
    levels = [img]
    while img.shape[0] > 1 or img.shape[1] > 1:
        fh = 2 if img.shape[0] > 1 else 1
        fw = 2 if img.shape[1] > 1 else 1
        nh, nw = img.shape[0] // fh, img.shape[1] // fw
        img = img[: nh * fh, : nw * fw].reshape(nh, fh, nw, fw, -1).mean(
            (1, 3))
        levels.append(img.astype(np.float32))
    return tuple(levels)
