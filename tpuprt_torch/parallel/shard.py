"""Inverse-rendering losses and rendering over several devices (port of
tpuprt/parallel/shard.py).

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

Several devices: a Mesh is the initialised torch.distributed process
group, one device per rank (tpuprt's 1-D jax Mesh over the "data" axis;
multihost.init_distributed or torchrun starts the group). Every rank holds
the whole scene. render_sharded gives each rank tpuprt's contiguous block
of every global chunk of (pixel, sample) ids (shard_map's P(axis)), which
it renders with render.render_chunk into a film kept on its device; the
films are summed once at the end (all_reduce SUM), where tpuprt psums
each chunk's film.
Counter-based sampling makes the result the single-device render's up to
the order of float additions. train_step_sharded computes each rank's
block's loss and gradients and averages both over the ranks (SUM, then a
division: gloo has no AVG). The backend is the caller's: NCCL on cards,
gloo on the CPU or where ranks share one card.
"""
from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.distributed as dist

from .. import render as R
from ..cameras import cameras as cam_mod
from ..film import film as film_mod
from ..samplers import samplers as smp
from ..scene.data import SceneData, to_device


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
    o, d, mint, maxt, _ = cam_mod.generate_rays(
        scene.camera, cs["image_x"], cs["image_y"], cs["lens_u"],
        cs["lens_v"], cs["time"], opts.xres, opts.yres)
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


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the ranks of the default process group, one device
    each."""
    device: torch.device  # this rank's device
    rank: int
    size: int


def local_device(rank: int = None):
    """cuda:{local rank}: torchrun's LOCAL_RANK, else the rank modulo the
    cards of this host."""
    rank = dist.get_rank() if rank is None else rank
    local = os.environ.get("LOCAL_RANK")
    n = max(1, torch.cuda.device_count())
    return torch.device("cuda", int(local) if local is not None
                        else rank % n)


def make_mesh(device=None) -> Mesh:
    """The mesh over the initialised default process group (every rank of
    it renders), this rank on `device`: local_device() unless the caller
    asks for another or for the CPU; without a CUDA device a mesh on the
    card raises."""
    device = torch.device(device) if device is not None else None
    if device is None or device.type == "cuda":
        R.require_device("make_mesh()", "cuda")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh(): no process group; start one with "
                           "multihost.init_distributed or torchrun")
    if device is None or (device.type == "cuda" and device.index is None):
        device = local_device()
    return Mesh(device, dist.get_rank(), dist.get_world_size())


def render_sharded(scene: SceneData, opts: R.RenderOptions,
                   mesh: Mesh = None):
    """A full-frame render with the sample space sharded over the mesh's
    ranks (tpuprt/parallel/shard.py:39-87): each rank renders its block of
    every global chunk into a film that stays on its device, and the
    films are summed once at the end. Every rank returns the same (rgb
    f32[yres,xres,3], alpha f32[yres,xres]) numpy arrays, render()'s up to
    float addition order."""
    mesh = mesh or make_mesh()
    device = mesh.device
    R.require_device("render_sharded()", device)
    scene = R.on_device(scene, device)
    aux = R.preprocess(scene, opts)
    film = film_mod.make_film(opts.xres, opts.yres, opts.crop, device)
    xstart, xcount, ystart, ycount = film_mod.pixel_extent(film)
    spp = smp.samples_per_pixel(opts.sampler)
    total = xcount * ycount * spp
    ndev = mesh.size
    # tpuprt's global chunk: opts.chunk_size lanes a device, rounded up to
    # a multiple of the device count.
    chunk = min(opts.chunk_size * ndev, -(-total // ndev) * ndev)
    per_dev = chunk // ndev
    for c in range(math.ceil(total / chunk)):
        lo = c * chunk + mesh.rank * per_dev
        if lo < total:
            lin = torch.arange(lo, min(lo + per_dev, total), device=device)
            pix = lin // spp
            R.render_chunk(scene, opts, film,
                           (xstart + pix % xcount).to(torch.int32),
                           (ystart + pix // xcount).to(torch.int32),
                           (lin % spp).to(torch.int32), aux)
    dist.all_reduce(film.data)
    rgb, alpha = film_mod.develop(film)
    if opts.half_readback:
        rgb, alpha = film_mod.to_half(rgb, alpha)
    return (rgb.to(torch.float32).cpu().numpy(),
            alpha.to(torch.float32).cpu().numpy())


def train_step_sharded(scene: SceneData, opts: R.RenderOptions, target,
                       px, py, s_idx, mesh: Mesh = None,
                       boundary: bool = False, topology=None,
                       n_edge_samples: int = 1024, seed: int = 0):
    """One inverse-rendering step (tpuprt/parallel/shard.py:124-178): the
    samples (px, py, s_idx i32[N], N a multiple of the mesh's size) split
    into the ranks' contiguous blocks, each rank's render_loss_fn and its
    gradients on its device, the loss and the gradients averaged over the
    ranks. boundary=True adds the silhouette terms (diff/silhouette.py,
    render_loss_with_silhouette; the loss value is unchanged), weighted by
    the whole batch's N: each rank takes its contiguous block of the edge
    samples and scales its share by the rank count, so the average is the
    single-device term. The result equals one device's up to float
    addition order; tpuprt's, under JAX 0.9's
    shard_map, comes out D times too large in the interior (the gradient
    of a device's loss w.r.t. the replicated scene is already summed
    over the devices before its pmean) and D^2 times in the boundary term
    (its weight takes the shard's n, and every device takes every edge
    sample). topology: mesh_edges of the triangles, computed here when
    None. Returns (loss f32[], the scene
    with each float table replaced by its gradient, on the mesh's
    device)."""
    mesh = mesh or make_mesh()
    device = mesh.device
    R.require_device("train_step_sharded()", device)
    n = px.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} samples do not split over {mesh.size} ranks")
    block = slice(mesh.rank * (n // mesh.size),
                  (mesh.rank + 1) * (n // mesh.size))
    params, rebuild = split_float_params(to_device(scene, device))
    params = tuple(p.detach().requires_grad_(True) for p in params)
    ids = [torch.as_tensor(a)[block].to(device) for a in (px, py, s_idx)]
    target = torch.as_tensor(target).to(device)
    if boundary:
        from ..diff.silhouette import (mesh_edges,
                                       render_loss_with_silhouette)
        if topology is None:
            topology = mesh_edges(scene.triangles.idx.cpu().numpy())
        loss = render_loss_with_silhouette(
            rebuild(params), opts, *ids, target,
            n_edge_samples=n_edge_samples, seed=seed, topology=topology,
            n_total=n, part=(mesh.rank, mesh.size), device=device)
    else:
        loss = render_loss_fn(rebuild(params), opts, *ids, target, device)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    flat = torch.cat([loss.detach().reshape(1)] +
                     [g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat = flat / mesh.size
    out, at = [], 1
    for g in grads:
        out.append(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return flat[0], rebuild(out)
