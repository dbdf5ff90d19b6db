"""Tone-mapping operators and the imaging pipeline (port of
tpuprt/tonemaps/tonemaps.py), plain torch on the image's device.

The reference's tonemaps/*.cpp and ApplyImagingPipeline (core/film.cpp:
30-136). ToneMap::Map's contract: the input is y = 683 * luminance
f32[h, w], the output a per-pixel scale applied to RGB (core/film.cpp:
90-115). The box blurs are direct convolutions with zero padding, as
tpuprt's "SAME" convolutions; the bloom's is the same sum through an FFT.
"""
from __future__ import annotations


import torch
import torch.nn.functional as F

from ..core import rng, spectrum as spec


def _log_mean(y):
    """exp of the mean of log y over the pixels, 0 counted for y <= 0."""
    return torch.exp(torch.mean(torch.where(
        y > 0, torch.log(torch.clamp(y, min=1e-12)), 0.0)))


def contrast(y, max_display_y=100.0, display_adaptation_y=50.0):
    """TVI contrast-preserving scale (tonemaps/contrast.cpp:37-52)."""
    s = ((1.219 + display_adaptation_y ** 0.4) /
         (1.219 + torch.pow(_log_mean(y), 0.4))) ** 2.5
    return torch.broadcast_to(s, y.shape)


def maxwhite(y, max_display_y=100.0):
    """scale = maxDisplayY / maxY (tonemaps/maxwhite.cpp:30-41)."""
    my = torch.max(y)
    return torch.broadcast_to(torch.where(my > 0, max_display_y / my, 1.0),
                              y.shape)


def nonlinear(y, max_display_y=100.0, max_y=0.0):
    """Reinhard's operator (tonemaps/nonlinear.cpp:32-50)."""
    if max_y <= 0.0:
        ywa = _log_mean(y) / 683.0
        inv_y2 = 1.0 / torch.clamp(ywa * ywa, min=1e-12)
    else:
        inv_y2 = 1.0 / max(max_y * max_y, 1e-12)
    ys = y / 683.0
    return (max_display_y / 683.0) * (1.0 + ys * inv_y2) / (1.0 + ys)


def _jnd_c(y):
    """The just-noticeable-difference curve C() (tonemaps/highcontrast.cpp)."""
    lg = lambda v: torch.log10(torch.clamp(y, min=1e-9) / v)
    return torch.where(
        y < 0.0034, y / 0.0014,
        torch.where(y < 1.0, 2.4483 + lg(0.0034) / 0.4027,
                    torch.where(y < 7.2444, 16.563 + (y - 1.0) / 0.4027,
                                32.0693 + lg(7.2444) / 0.0556)))


def _box_blur(img, radius):
    """A separable (2r+1)^2 box blur, rows then columns, zero padded."""
    r = max(1, int(radius))
    k = torch.full((2 * r + 1,), 1.0 / (2 * r + 1), dtype=img.dtype,
                   device=img.device)
    out = F.conv2d(img[None, None], k.view(1, 1, -1, 1), padding=(r, 0))
    return F.conv2d(out, k.view(1, 1, 1, -1), padding=(0, r))[0, 0]


def highcontrast(y, max_display_y=100.0, n_widths=8):
    """Local adaptation (tonemaps/highcontrast.cpp:51-110): the first of
    a ladder of box-blur widths (up to 32 pixels) whose local contrast
    against the next exceeds 0.5 gives a pixel's adaptation luminance, as
    tpuprt evaluates the reference's growing lookup radius."""
    cy_min = _jnd_c(torch.min(y))
    cy_max = _jnd_c(torch.max(y))
    widths = [max(1, int(32 * (i + 1) / n_widths)) for i in range(n_widths)]
    blurs = [_box_blur(y, w) for w in widths]
    yadapt = blurs[-1]
    chosen = torch.zeros_like(y, dtype=torch.bool)
    for b0, b1 in zip(blurs[:-1], blurs[1:]):
        lc = torch.abs((b0 - b1) / torch.clamp(b0, min=1e-9))
        take = (lc > 0.5) & ~chosen
        yadapt = torch.where(take, b0, yadapt)
        chosen = chosen | take
    t_val = max_display_y * (_jnd_c(yadapt) - cy_min) / \
        torch.clamp(cy_max - cy_min, min=1e-9)
    return t_val / torch.clamp(yadapt, min=1e-9)


TONEMAPS = {"contrast": contrast, "maxwhite": maxwhite,
            "nonlinear": nonlinear, "highcontrast": highcontrast}


def bloom(rgb, radius=0.2, weight=0.1):
    """The bloom pass (core/film.cpp:38-89): a (1 - d/r)^8 weighted splat
    of radius `radius` of the image's larger side, the zero-padded
    convolution tpuprt takes directly, here through an FFT in float64
    (exact to f32; a direct 205^2 convolution of a 512^2 image takes
    about 35 s on an 8-core host)."""
    h, w = rgb.shape[:2]
    br = max(1, int(radius * max(h, w)))
    ax = torch.arange(-br, br + 1, dtype=torch.float32, device=rgb.device)
    dist = torch.sqrt(ax[:, None] ** 2 + ax[None, :] ** 2)
    kern = torch.clamp(1.0 - dist / br, min=0.0) ** 8
    kern = (kern / torch.sum(kern)).double()
    # The full linear convolution, then its centre (the kernel is
    # symmetric, so convolution and correlation agree).
    size = (h + 2 * br, w + 2 * br)
    full = torch.fft.irfft2(
        torch.fft.rfft2(rgb.permute(2, 0, 1).double(), size) *
        torch.fft.rfft2(kern, size), size)
    blurred = full[:, br:br + h, br:br + w].permute(1, 2, 0).float()
    return (1.0 - weight) * rgb + weight * blurred


def apply_imaging_pipeline(rgb, tonemap: str | None = None,
                           max_display_y=100.0, bloom_radius=0.0,
                           bloom_weight=0.2, gamma=1.0, dither=0.5,
                           max_display_value=255.0, seed=0, **tm_kwargs):
    """ApplyImagingPipeline (core/film.cpp:30-136) on an image f32[h, w,
    3] (a tensor, on its device, or a numpy array, on the CPU): bloom, the
    tone map's scale of 683 luminance, gamut desaturation, gamma, the
    display scale and dither keyed by (row, column, seed). Returns f32 in
    [0, max_display_value] on the image's device."""
    out = torch.as_tensor(rgb, dtype=torch.float32)
    if bloom_radius > 0.0:
        out = bloom(out, bloom_radius, bloom_weight)
    if tonemap is not None:
        y = spec.luminance(out) * 683.0
        scale = TONEMAPS[tonemap](y, max_display_y, **tm_kwargs)
        # To the [0, 1] display range (film.cpp:108-115).
        out = out * scale[..., None] * (683.0 / max_display_y)
    # Out of gamut: scaled down by its largest channel (film.cpp:116-122).
    m = torch.amax(out, dim=-1, keepdim=True)
    out = torch.where(m > 1.0, out / torch.clamp(m, min=1e-9), out)
    if gamma != 1.0:
        out = torch.pow(torch.clamp(out, min=0.0), 1.0 / gamma)
    out = out * max_display_value
    if dither > 0.0:
        h, w = out.shape[:2]
        ys = torch.arange(h, device=out.device)[:, None].expand(h, w)
        xs = torch.arange(w, device=out.device)[None, :].expand(h, w)
        noise = rng.uniform(ys, xs, seed) * 2.0 - 1.0
        out = out + dither * noise[..., None]
    return torch.clamp(out, 0.0, max_display_value)
