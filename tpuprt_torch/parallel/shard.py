"""The loss and the parameter split of inverse rendering (port of
tpuprt/parallel/shard.py:90-121, render_loss_fn and split_float_params).

render_loss_fn runs on `device`, the card unless the caller asks for the
CPU: render.on_device puts the scene's tables there as the renderer walks
them, a copy that keeps autograd, so a loss of a CPU scene on the card
still gives its CPU tensors their gradients. Autograd differentiates the
scan form of the integrator's Li (render.li) in every float table:
texture constants and texels, light spectra, the camera's and the
instances' transforms, vertex positions. Discrete choices carry no
gradient: the traversal kernels are NonDiff calls (ops/bvh_cuda.py), the
plain walks run under no_grad, and the winners' t is recomputed from the
live tables, as tpuprt's estimator does.

render_sharded and train_step_sharded, the several-device half of
tpuprt's module, are not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import render as R
from ..cameras import cameras as cam_mod
from ..samplers import samplers as smp
from ..scene.data import SceneData


def sample_losses(scene: SceneData, opts: R.RenderOptions, px, py, s_idx,
                  target, device="cuda"):
    """The squared L2 distance f32[N] between each sample's radiance (px,
    py, s_idx i32[N]) and its pixel of `target` f32[yres, xres, 3], on
    `device` (see the module's docstring; without a CUDA device a loss
    that did not ask for the CPU raises): camera samples, camera rays
    without differentials, the scan Li."""
    R.require_device("sample_losses()", device)
    scene = R.on_device(scene, device)
    px, py, s_idx, target = (x.to(device) for x in (px, py, s_idx, target))
    cs = smp.camera_samples(opts.sampler, px, py, s_idx, opts.seed)
    o, d, mint, maxt = cam_mod.generate_rays(
        scene.camera, cs["image_x"], cs["image_y"], opts.xres, opts.yres)
    L = R.li(scene, opts, None, o, d, mint, maxt, px, py, s_idx)[0]
    diff = L - target[py.long(), px.long()]
    return torch.sum(diff * diff, dim=-1)


def render_loss_fn(scene: SceneData, opts: R.RenderOptions, px, py, s_idx,
                   target, device="cuda"):
    """The f32 mean of sample_losses (tpuprt/parallel/shard.py:90-105) on
    `device`."""
    return torch.mean(sample_losses(scene, opts, px, py, s_idx, target,
                                    device))


def _map_tensors(obj, fn):
    """obj with fn(t) in place of each tensor t of its nested table
    dataclasses and plain tuples, in field order."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if type(obj) is tuple:
        return tuple(_map_tensors(x, fn) for x in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _map_tensors(getattr(obj, f.name), fn)
            for f in dataclasses.fields(obj)})
    return obj


def split_float_params(scene: SceneData):
    """(params, rebuild) (tpuprt/parallel/shard.py:108-121): params the
    tuple of the scene's floating-point tensors in field order, rebuild(p)
    the scene with p's tensors in their places. Integer and boolean tables
    (topology, ids, masks) stay as they are."""
    params = []

    def take(t):
        if t.is_floating_point():
            params.append(t)
        return t
    _map_tensors(scene, take)

    def rebuild(new):
        it = iter(new)
        out = _map_tensors(
            scene, lambda t: next(it) if t.is_floating_point() else t)
        if next(it, None) is not None:
            raise ValueError(f"rebuild takes {len(params)} tensors")
        return out

    return tuple(params), rebuild
