"""Reconstruction filters as batched Evaluate(x, y) (port of
tpuprt/filters/filters.py: box, triangle, gaussian, mitchell, sinc;
reference filters/*.cpp)."""
from __future__ import annotations

import math

import torch

FILTER_BOX = "box"
FILTER_TRIANGLE = "triangle"
FILTER_GAUSSIAN = "gaussian"
FILTER_MITCHELL = "mitchell"
FILTER_SINC = "sinc"

DEFAULT_WIDTHS = {
    FILTER_BOX: (0.5, 0.5),
    FILTER_TRIANGLE: (2.0, 2.0),
    FILTER_GAUSSIAN: (2.0, 2.0),
    FILTER_MITCHELL: (2.0, 2.0),
    FILTER_SINC: (4.0, 4.0),
}


# The filters' shape parameters, at the defaults tpuprt renders with
# whatever the file says (tpuprt/render.py:158-160 passes none; pbrt-v1
# reads "alpha", "B", "C" and "tau").
GAUSSIAN_ALPHA = 2.0
MITCHELL_B = MITCHELL_C = 1.0 / 3.0
SINC_TAU = 3.0


def evaluate(kind: str, x, y, xwidth: float, ywidth: float):
    """Filter::Evaluate(x, y); x, y are offsets from the sample."""
    if kind == FILTER_BOX:
        return torch.ones_like(x)
    if kind == FILTER_TRIANGLE:
        return (torch.clamp(xwidth - torch.abs(x), min=0.0) *
                torch.clamp(ywidth - torch.abs(y), min=0.0))
    if kind == FILTER_GAUSSIAN:
        # e^{-a d^2} - e^{-a w^2}, clamped (filters/gaussian.cpp:48-55),
        # the constant term taken in f32, as tpuprt takes it.
        a = GAUSSIAN_ALPHA
        expx = float(torch.exp(torch.tensor(-a * xwidth * xwidth)))
        expy = float(torch.exp(torch.tensor(-a * ywidth * ywidth)))
        gx = torch.clamp(torch.exp(-a * x * x) - expx, min=0.0)
        gy = torch.clamp(torch.exp(-a * y * y) - expy, min=0.0)
        return gx * gy
    if kind == FILTER_MITCHELL:
        return _mitchell1d(x / xwidth) * _mitchell1d(y / ywidth)
    if kind == FILTER_SINC:
        return _sinc1d(x / xwidth) * _sinc1d(y / ywidth)
    # Another name loads (the parser keeps it with widths (2, 2)) and
    # fails here, at the render's first splat, as tpuprt's does.
    raise ValueError(f"unknown filter {kind}")


def _mitchell1d(x, b=MITCHELL_B, c=MITCHELL_C):
    """filters/mitchell.cpp:48-57."""
    x = torch.abs(2.0 * x)
    big = ((-b - 6 * c) * x * x * x + (6 * b + 30 * c) * x * x +
           (-12 * b - 48 * c) * x + (8 * b + 24 * c)) * (1.0 / 6.0)
    small = ((12 - 9 * b - 6 * c) * x * x * x +
             (-18 + 12 * b + 6 * c) * x * x + (6 - 2 * b)) * (1.0 / 6.0)
    return torch.where(x > 2.0, 0.0, torch.where(x > 1.0, big, small))


def _sinc1d(x, tau=SINC_TAU):
    """Lanczos-windowed sinc (filters/sinc.cpp:41-56)."""
    x = torch.abs(x)
    s = torch.sin(math.pi * x * tau) / torch.clamp(math.pi * x * tau,
                                                   min=1e-9)
    lanczos = torch.sin(math.pi * x) / torch.clamp(math.pi * x, min=1e-9)
    val = torch.where(x < 1e-5, 1.0, s * lanczos)
    return torch.where(x > 1.0, 0.0, val)
