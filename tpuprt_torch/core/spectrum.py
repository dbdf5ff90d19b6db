"""RGB spectra as ``f32[..., 3]`` tensors (port of tpuprt/core/spectrum.py):
the XYZ weights (reference core/color.cpp:35-43) and FromXYZ
(core/color.cpp:44-50), Spectrum::y(), IsBlack and the element-wise
Sqrt, Exp and Clamp."""
from __future__ import annotations

import math

import numpy as np
import torch

# The rows of the RGB -> XYZ weights (core/color.cpp:35-43), as f32.
XWEIGHT, YWEIGHT, ZWEIGHT = (tuple(float(w) for w in np.float32(r)) for r in (
    [0.412453, 0.357580, 0.180423], [0.212671, 0.715160, 0.072169],
    [0.019334, 0.119193, 0.950227]))
# The FromXYZ matrix (core/color.cpp:44-50), as f32 rows.
XYZ_TO_RGB = tuple(tuple(float(w) for w in np.float32(r)) for r in (
    [3.240479, -1.537150, -0.498535], [-0.969256, 1.875991, 0.041556],
    [0.055648, -0.204043, 1.057311]))


def _rows(m, v):
    """Each row of m dotted with v's last axis, summed left to right."""
    return torch.stack([v[..., 0] * r[0] + v[..., 1] * r[1] +
                        v[..., 2] * r[2] for r in m], dim=-1)


def to_xyz(rgb):
    """Spectrum::XYZ (core/color.h)."""
    return _rows((XWEIGHT, YWEIGHT, ZWEIGHT), rgb)


def from_xyz(xyz):
    """Spectrum::FromXYZ (core/color.cpp:44-50)."""
    return _rows(XYZ_TO_RGB, xyz)


def luminance(rgb):
    """Spectrum::y(), summed left to right."""
    return rgb[..., 0] * YWEIGHT[0] + rgb[..., 1] * YWEIGHT[1] + \
        rgb[..., 2] * YWEIGHT[2]


def is_black(rgb):
    return torch.all(rgb == 0.0, dim=-1)


def safe_sqrt(rgb):
    return torch.sqrt(torch.clamp(rgb, min=0.0))


def exp(rgb):
    return torch.exp(rgb)


def clamp(rgb, lo=0.0, hi=math.inf):
    return torch.clamp(rgb, lo, hi)
