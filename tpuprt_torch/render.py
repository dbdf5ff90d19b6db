"""Render driver (port of tpuprt/render.py: RenderOptions and the routing
to the regenerating wavefront pool, photon mapping included).

The port has no volumes (the parser raises on a Volume statement), so
every photonmap scene goes to the pool, as tpuprt routes a volume-free
one."""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .integrators import path_wavefront
from .ops import bvh_cuda, mt_cuda
from .samplers import samplers as smp
from .scene.data import BvhAccel, SceneData, to_device


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
    photon: tuple = ()                 # PhotonParams when photonmap


def render(scene: SceneData, opts: RenderOptions, device="cuda",
           maps=None):
    """Full-frame render on `device`: the card by default (the traversal
    kernels), or "cpu" on request (their plain versions). Without a CUDA
    device a render that did not ask for the CPU raises. Returns (rgb
    f32[yres,xres,3], alpha f32[yres,xres]) as numpy arrays. A photonmap
    render shoots its photons and builds its maps on `device` before the
    pool starts (tpuprt/render.py:262-267), unless `maps`
    (integrators.photonmap.PhotonMaps) are given."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("render(): no CUDA device; pass device=\"cpu\" "
                           "to render with the plain versions")
    if isinstance(scene.accel, BvhAccel):
        # Copy to the card only the BVH format the front end walks.
        scene = dataclasses.replace(scene,
                                    accel=bvh_cuda.walked_only(scene.accel))
    elif scene.accel is None and scene.triangles.count:
        # Brute force: the dense kernel's triangles, packed once.
        scene = dataclasses.replace(
            scene, tris_packed=mt_cuda.pack_table(scene.triangles))
    kw = {} if maps is None else {"maps": to_device(maps, device)}
    return path_wavefront.render(to_device(scene, device), opts, device,
                                 **kw)
