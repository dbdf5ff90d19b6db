"""Render driver (port of tpuprt/render.py: RenderOptions and the routing
to the regenerating wavefront pool)."""
from __future__ import annotations

from typing import NamedTuple

from .integrators import path_wavefront
from .samplers import samplers as smp
from .scene.data import SceneData, to_device


class RenderOptions(NamedTuple):
    xres: int = 256
    yres: int = 256
    sampler: smp.SamplerConfig = smp.SamplerConfig()
    filter_kind: str = "box"
    filter_xwidth: float = 0.5
    filter_ywidth: float = 0.5
    integrator: str = "directlighting"
    max_depth: int = 5
    crop: tuple = (0.0, 1.0, 0.0, 1.0)
    seed: int = 0
    chunk_size: int = 1 << 16          # wavefront lane-pool size
    filename: str = "pbrt.exr"         # film/image.cpp:213-216
    # Quantize the developed image to f16 on the device before the host
    # copy, as the reference's EXR writer stores HALF pixels anyway.
    half_readback: bool = False


def render(scene: SceneData, opts: RenderOptions, device="cpu"):
    """Full-frame render on `device` ("cpu" runs the traversal's plain
    version, "cuda" its kernel). Returns (rgb f32[yres,xres,3], alpha
    f32[yres,xres]) as numpy arrays."""
    return path_wavefront.render(to_device(scene, device), opts, device)
