"""Perspective camera rays (port of tpuprt/cameras/cameras.py for the
perspective camera without a lens).

The raster->camera matrix chain is assembled on the host (build_projective,
core/camera.cpp:60-78); `generate_rays` is batched tensor math over f32[N]
raster coordinates.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import transform as tf, vecmath as vm
from ..scene.data import CAMERA_PERSPECTIVE, CameraData


def default_screen_window(xres: int, yres: int, frameaspect=None):
    """Screen window from frame aspect ratio (core/api.cpp camera defaults)."""
    aspect = frameaspect if frameaspect is not None else xres / yres
    if aspect > 1.0:
        return [-aspect, aspect, -1.0, 1.0]
    return [-1.0, 1.0, -1.0 / aspect, 1.0 / aspect]


def build_projective(kind, cam2world, cam2screen, screen, xres, yres,
                     hither=1e-3, yon=1e30, shutteropen=0.0, shutterclose=1.0,
                     lensradius=0.0, focaldistance=1e30) -> CameraData:
    """Host-side matrix chain mirroring core/camera.cpp:60-78."""
    if kind != CAMERA_PERSPECTIVE:
        raise NotImplementedError("only the perspective camera is ported")
    if lensradius > 0.0:
        raise NotImplementedError("thin-lens depth of field is not ported")
    s0, s1, s2, s3 = screen
    screen2raster = (
        np.diag([xres, yres, 1.0, 1.0]) @
        np.diag([1.0 / (s1 - s0), 1.0 / (s2 - s3), 1.0, 1.0]) @
        np.array([[1, 0, 0, -s0], [0, 1, 0, -s3], [0, 0, 1, 0], [0, 0, 0, 1.0]])
    ).astype(np.float32)
    raster2screen = np.linalg.inv(screen2raster)
    raster2cam = np.linalg.inv(np.asarray(cam2screen)) @ raster2screen
    c2w = np.asarray(cam2world, np.float32)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    return CameraData(
        kind=kind, cam2world=f32(c2w),
        world2cam=f32(np.linalg.inv(c2w)),
        raster2cam=f32(raster2cam), cam2screen=f32(cam2screen),
        lens_radius=f32(lensradius), focal_distance=f32(focaldistance),
        shutter_open=f32(shutteropen), shutter_close=f32(shutterclose),
        cliphither=float(hither), clipyon=float(yon))


def generate_rays(cam: CameraData, image_x, image_y, xres: int, yres: int):
    """Batched GenerateRay. Returns world-space (o, d, mint, maxt).
    image_x/image_y are continuous raster coordinates (pixel + jitter)."""
    n = image_x.shape[0]
    zeros = torch.zeros((n,), dtype=torch.float32, device=image_x.device)
    p_cam = tf.apply_point(cam.raster2cam,
                           torch.stack([image_x, image_y, zeros], dim=-1))
    d_cam = vm.normalize(p_cam)
    dz = torch.where(torch.abs(d_cam[..., 2]) < 1e-12, 1e-12, d_cam[..., 2])
    maxt = (min(cam.clipyon, 1e30) - cam.cliphither) / dz
    o_w = tf.apply_point(cam.cam2world, torch.zeros_like(d_cam))
    d_w = tf.apply_vector(cam.cam2world, d_cam)
    return o_w, d_w, zeros, maxt
