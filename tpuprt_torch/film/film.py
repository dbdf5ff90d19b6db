"""Image film (port of tpuprt/film/film.py): filtered sample splatting into
one f32[yres, xres, 5] accumulator (R, G, B, weighted alpha, weight sum)
and WriteImage's normalization (film/image.cpp:103-212)."""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..filters import filters as ftr
from ..utils.stats import span


@dataclass
class Film:
    data: torch.Tensor            # f32[yres, xres, 5]
    xres: int = 0
    yres: int = 0
    crop: tuple = (0.0, 1.0, 0.0, 1.0)


def make_film(xres, yres, crop=(0.0, 1.0, 0.0, 1.0), device="cuda") -> Film:
    """An empty film on `device` (the card unless the caller asks for the
    CPU; without a CUDA device, torch raises)."""
    return Film(data=torch.zeros((yres, xres, 5), dtype=torch.float32,
                                 device=device),
                xres=xres, yres=yres, crop=tuple(crop))


def from_planes(pixels, alpha, weight_sum, xres, yres,
                crop=(0.0, 1.0, 0.0, 1.0), device="cuda") -> Film:
    """A film on `device` from its separate planes (tpuprt/film/film.py:
    61-68): pixels [H,W,3], alpha and weight sum [H,W], as a checkpoint
    holds them."""
    data = torch.cat([torch.as_tensor(pixels, dtype=torch.float32),
                      torch.as_tensor(alpha, dtype=torch.float32)[..., None],
                      torch.as_tensor(weight_sum,
                                      dtype=torch.float32)[..., None]],
                     dim=-1)
    return Film(data=data.to(device), xres=xres, yres=yres,
                crop=tuple(crop))


def pixel_extent(film: Film):
    """Crop-window pixel bounds (xstart, xcount, ystart, ycount)."""
    x0, x1, y0, y1 = film.crop
    xstart = math.ceil(film.xres * x0)
    xcount = max(1, math.ceil(film.xres * x1) - xstart)
    ystart = math.ceil(film.yres * y0)
    ycount = max(1, math.ceil(film.yres * y1) - ystart)
    return xstart, xcount, ystart, ycount


def add_samples(film: Film, image_x, image_y, L, alpha,
                filter_kind: str, xwidth: float, ywidth: float):
    """Splat a sample batch, in place (film/image.cpp:103-147 semantics:
    discrete pixel coordinates are continuous - 0.5).

    A half-pixel box touches exactly the sample's own pixel floor(image_x),
    so the splat is one index_add_ of a [N, 5] payload. As in tpuprt, a
    sample at an exactly integral image_x credits only floor(image_x)
    (documented divergence from image.cpp, measure-zero for these
    samplers). Any other filter splats over the floor(2w)+1 pixels a side
    that a filter of width w can reach (tpuprt/film/film.py:112-137): one
    index_add_ of every (sample, window pixel) pair's weighted payload,
    the filter evaluated exactly (no 16x16 table).
    """
    H, W = film.data.shape[0], film.data.shape[1]
    flat = film.data.view(H * W, 5)
    if filter_kind == ftr.FILTER_BOX and xwidth <= 0.5 and ywidth <= 0.5:
        px = torch.floor(image_x).to(torch.int64)
        py = torch.floor(image_y).to(torch.int64)
        inside = (px >= 0) & (px < W) & (py >= 0) & (py < H)
        w = torch.where(inside, 1.0, 0.0)
        idx = torch.clamp(py, 0, H - 1) * W + torch.clamp(px, 0, W - 1)
        payload = torch.cat([w[..., None] * L, (w * alpha)[..., None],
                             w[..., None]], dim=-1)
        flat.index_add_(0, idx, payload)
        return film
    dx = image_x - 0.5
    dy = image_y - 0.5
    x0 = torch.ceil(dx - xwidth).to(torch.int64)
    y0 = torch.ceil(dy - ywidth).to(torch.int64)
    # Integers in [d - w, d + w] number at most floor(2w) + 1.
    nx = int(math.floor(2.0 * xwidth)) + 1
    ny = int(math.floor(2.0 * ywidth)) + 1
    dev = image_x.device
    ox = torch.arange(nx, device=dev).repeat(ny)          # window x offsets
    oy = torch.arange(ny, device=dev).repeat_interleave(nx)
    px = x0[:, None] + ox                                  # [N, nx*ny]
    py = y0[:, None] + oy
    fx = px.to(torch.float32) - dx[:, None]
    fy = py.to(torch.float32) - dy[:, None]
    w = ftr.evaluate(filter_kind, fx, fy, xwidth, ywidth)
    inside = (torch.abs(fx) <= xwidth) & (torch.abs(fy) <= ywidth) & \
        (px >= 0) & (px < W) & (py >= 0) & (py < H)
    w = torch.where(inside, w, 0.0)
    idx = torch.clamp(py, 0, H - 1) * W + torch.clamp(px, 0, W - 1)
    payload = torch.cat([w[..., None] * L[:, None, :],
                         (w * alpha[:, None])[..., None], w[..., None]],
                        dim=-1)
    flat.index_add_(0, idx.reshape(-1), payload.reshape(-1, 5))
    return film


def develop(film: Film):
    """Weight-normalized (rgb f32[H,W,3], alpha f32[H,W])
    (film/image.cpp:157-212)."""
    w = torch.clamp(film.data[..., 4], min=1e-10)[..., None]
    rgb = film.data[..., 0:3] / w
    alpha = torch.clamp(film.data[..., 3:4] / w, 0.0, 1.0)[..., 0]
    return rgb, alpha


def to_half(rgb, alpha):
    """Clip-to-f16 quantization of the developed image, matching the HALF
    pixels of the reference's EXR output (core/exrio.cpp)."""
    return (torch.clamp(rgb, 0.0, 65504.0).to(torch.float16),
            alpha.to(torch.float16))


def readback(x):
    """x as a float32 numpy array on the host: a copy that waits for the
    device, so a span "sync"."""
    with span("sync"):
        return x.to(torch.float32).cpu().numpy()
