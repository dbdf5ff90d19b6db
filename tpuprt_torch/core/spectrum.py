"""RGB spectra as ``f32[..., 3]`` tensors (port of tpuprt/core/spectrum.py,
the parts the port uses): Spectrum::y(), the luminance channel of XYZ
(reference core/color.cpp:35-43), and IsBlack."""
from __future__ import annotations

import numpy as np
import torch

# The Y row of the RGB -> XYZ weights (core/color.cpp:35-43), as f32.
YWEIGHT = tuple(float(w) for w in np.float32([0.212671, 0.715160,
                                              0.072169]))


def luminance(rgb):
    """Spectrum::y(), summed left to right."""
    return rgb[..., 0] * YWEIGHT[0] + rgb[..., 1] * YWEIGHT[1] + \
        rgb[..., 2] * YWEIGHT[2]


def is_black(rgb):
    return torch.all(rgb == 0.0, dim=-1)
