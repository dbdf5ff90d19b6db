"""Camera rays (port of tpuprt/cameras/cameras.py): the perspective camera
with thin-lens depth of field, the orthographic camera and the environment
camera.

The raster->camera matrix chain is assembled on the host (build_projective,
core/camera.cpp:60-78); `generate_rays` is batched tensor math over f32[N]
raster coordinates and the sampler's lens and time samples. A ray's
weight is always 1 (cameras/perspective.cpp:81).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import mc, transform as tf, vecmath as vm
from ..scene.data import (CAMERA_ENVIRONMENT, CAMERA_ORTHOGRAPHIC,
                          CAMERA_PERSPECTIVE, CameraData)


def default_screen_window(xres: int, yres: int, frameaspect=None):
    """Screen window from frame aspect ratio (core/api.cpp camera defaults)."""
    aspect = frameaspect if frameaspect is not None else xres / yres
    if aspect > 1.0:
        return [-aspect, aspect, -1.0, 1.0]
    return [-1.0, 1.0, -1.0 / aspect, 1.0 / aspect]


def _f32(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def build_projective(kind, cam2world, cam2screen, screen, xres, yres,
                     hither=1e-3, yon=1e30, shutteropen=0.0, shutterclose=1.0,
                     lensradius=0.0, focaldistance=1e30) -> CameraData:
    """Host-side matrix chain mirroring core/camera.cpp:60-78, for the
    perspective and the orthographic camera."""
    if kind not in (CAMERA_PERSPECTIVE, CAMERA_ORTHOGRAPHIC):
        raise ValueError(f"camera kind {kind} is not projective")
    s0, s1, s2, s3 = screen
    screen2raster = (
        np.diag([xres, yres, 1.0, 1.0]) @
        np.diag([1.0 / (s1 - s0), 1.0 / (s2 - s3), 1.0, 1.0]) @
        np.array([[1, 0, 0, -s0], [0, 1, 0, -s3], [0, 0, 1, 0], [0, 0, 0, 1.0]])
    ).astype(np.float32)
    raster2screen = np.linalg.inv(screen2raster)
    raster2cam = np.linalg.inv(np.asarray(cam2screen)) @ raster2screen
    c2w = np.asarray(cam2world, np.float32)
    return CameraData(
        kind=kind, cam2world=_f32(c2w),
        world2cam=_f32(np.linalg.inv(c2w)),
        raster2cam=_f32(raster2cam), cam2screen=_f32(cam2screen),
        lens_radius=_f32(lensradius), focal_distance=_f32(focaldistance),
        shutter_open=_f32(shutteropen), shutter_close=_f32(shutterclose),
        cliphither=float(hither), clipyon=float(yon),
        thin_lens=lensradius > 0.0)


def build_environment(cam2world, hither=1e-3, yon=1e30, shutteropen=0.0,
                      shutterclose=1.0) -> CameraData:
    """The environment camera (cameras/environment.cpp): no projection,
    no lens; generate_rays maps the film's rows and columns to theta and
    phi."""
    c2w = np.asarray(cam2world, np.float32)
    eye = np.eye(4, dtype=np.float32)
    return CameraData(
        kind=CAMERA_ENVIRONMENT, cam2world=_f32(c2w),
        world2cam=_f32(np.linalg.inv(c2w)), raster2cam=_f32(eye),
        cam2screen=_f32(eye), lens_radius=_f32(0.0),
        focal_distance=_f32(1e30), shutter_open=_f32(shutteropen),
        shutter_close=_f32(shutterclose), cliphither=float(hither),
        clipyon=float(yon))


def generate_rays(cam: CameraData, image_x, image_y, lens_u, lens_v, time_u,
                  xres: int, yres: int):
    """Batched GenerateRay. Returns world-space (o, d, mint, maxt, time).
    image_x/image_y are continuous raster coordinates (pixel + jitter);
    lens_u/lens_v the lens sample, time_u the shutter sample."""
    n = image_x.shape[0]
    zeros = torch.zeros((n,), dtype=torch.float32, device=image_x.device)
    if cam.kind == CAMERA_ENVIRONMENT:
        # cameras/environment.cpp:47-61: y up, theta from the film's rows.
        theta = math.pi * image_y / yres
        phi = 2.0 * math.pi * image_x / xres
        st, ct = torch.sin(theta), torch.cos(theta)
        d_cam = torch.stack([st * torch.cos(phi), ct, st * torch.sin(phi)],
                            dim=-1)
        o_w = tf.apply_point(cam.cam2world, torch.zeros_like(d_cam))
        d_w = tf.apply_vector(cam.cam2world, d_cam)
        mint = torch.full((n,), cam.cliphither, dtype=torch.float32,
                          device=image_x.device)
        maxt = torch.full((n,), min(cam.clipyon, 1e30), dtype=torch.float32,
                          device=image_x.device)
    else:
        p_cam = tf.apply_point(cam.raster2cam,
                               torch.stack([image_x, image_y, zeros], dim=-1))
        if cam.kind == CAMERA_PERSPECTIVE:
            o_cam = torch.zeros_like(p_cam)
            d_cam = p_cam
        else:   # orthographic (cameras/orthographic.cpp:48-79)
            o_cam = p_cam
            d_cam = torch.zeros_like(p_cam)
            d_cam[..., 2] = 1.0
        if cam.thin_lens:
            # Thin lens (cameras/perspective.cpp:60-77): the point on the
            # plane of focus, seen from the lens sample; selected where the
            # radius is positive, as tpuprt does (no host read of it).
            lu, lv = mc.concentric_sample_disk(lens_u, lens_v)
            lu = lu * cam.lens_radius
            lv = lv * cam.lens_radius
            dz = torch.where(torch.abs(d_cam[..., 2]) < 1e-12, 1e-12,
                             d_cam[..., 2])
            ft = (cam.focal_distance - cam.cliphither) / dz
            p_focus = o_cam + ft[..., None] * d_cam
            scale = (cam.focal_distance - cam.cliphither) / torch.clamp(
                cam.focal_distance, min=1e-12)
            o_lens = o_cam + torch.stack([lu * scale, lv * scale, zeros],
                                         dim=-1)
            has_lens = cam.lens_radius > 0.0
            d_cam = torch.where(has_lens, p_focus - o_lens, d_cam)
            o_cam = torch.where(has_lens, o_lens, o_cam)
        d_cam = vm.normalize(d_cam)
        dz = torch.where(torch.abs(d_cam[..., 2]) < 1e-12, 1e-12,
                         d_cam[..., 2])
        mint = zeros
        maxt = (min(cam.clipyon, 1e30) - cam.cliphither) / dz
        o_w = tf.apply_point(cam.cam2world, o_cam)
        d_w = tf.apply_vector(cam.cam2world, d_cam)
    time = (1.0 - time_u) * cam.shutter_open + time_u * cam.shutter_close
    return o_w, d_w, mint, maxt, time
