"""Several processes, one device each, over torch.distributed (port of
tpuprt/parallel/multihost.py).

Every process runs the same program: init_distributed joins the process
group (a TCP rendezvous at the coordinator's address, or torchrun's
environment), global_mesh is the mesh over all its ranks, and the sample
space is sharded over them. Every process computes the same (pixel,
sample) schedule from the same counters, so no ids are exchanged: each
takes its block of the global arrays, and only films, losses and
gradients travel (all_reduce).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .. import render as R
from ..film import film as film_mod
from ..samplers import samplers as smp
from ..scene.data import SceneData
from . import shard as shard_mod


def init_distributed(coordinator_address: str = None,
                     num_processes: int = None, process_id: int = None,
                     device=None, backend: str = None) -> shard_mod.Mesh:
    """torch.distributed.init_process_group over tcp://coordinator_address
    ("host:port") for num_processes ranks, this one process_id; with no
    address, torchrun's environment (env://). This rank's device is
    `device` ("cpu", or "cuda:k" where tpuprt takes local_device_ids=[k]),
    else cuda:{local rank} (shard.local_device); without a CUDA device one
    on the card raises. The backend is the caller's: NCCL by default on
    the card, gloo on the CPU; ranks that share one card need gloo, and
    ask for it. Returns the global mesh."""
    device = torch.device(device) if device is not None else None
    if device is None or device.type == "cuda":
        R.require_device("init_distributed()", "cuda")
        if device is None or device.index is None:
            device = shard_mod.local_device(process_id or 0)
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if coordinator_address is None:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id)
    return global_mesh(device)


def global_mesh(device=None) -> shard_mod.Mesh:
    """The 1-D mesh over every rank of every process."""
    return shard_mod.make_mesh(device=device)


def render_multihost(scene: SceneData, opts: R.RenderOptions,
                     mesh: shard_mod.Mesh = None):
    """A full-frame render across every rank (tpuprt/parallel/
    multihost.py:62-119): shard.render_sharded over the global mesh. The
    films are summed once at the end, where tpuprt psums each chunk's:
    the same image up to float addition order. Every process returns the
    same (rgb, alpha)."""
    return shard_mod.render_sharded(scene, opts, mesh or global_mesh())


def train_step_multihost(scene: SceneData, opts: R.RenderOptions, target,
                         mesh: shard_mod.Mesh = None, n_samples: int = None,
                         seed_chunk: int = 0):
    """One global inverse-rendering step (tpuprt/parallel/multihost.py:
    122-145): n_samples (256 a rank by default, rounded up to a multiple of
    the rank count) consecutive (pixel, sample) ids from seed_chunk *
    n_samples, wrapping around the film, through
    shard.train_step_sharded."""
    mesh = mesh or global_mesh()
    ndev = mesh.size
    spp = smp.samples_per_pixel(opts.sampler)
    n = n_samples or (ndev * 256)
    n = ((n + ndev - 1) // ndev) * ndev
    film0 = film_mod.make_film(opts.xres, opts.yres, opts.crop, "cpu")
    xstart, xcount, ystart, ycount = film_mod.pixel_extent(film0)
    total = xcount * ycount * spp
    lin = (np.arange(n) + seed_chunk * n) % total
    s_idx = (lin % spp).astype(np.int32)
    pixid = lin // spp
    px = (xstart + (pixid % xcount)).astype(np.int32)
    py = (ystart + (pixid // xcount)).astype(np.int32)
    return shard_mod.train_step_sharded(
        scene, opts, target, torch.from_numpy(px), torch.from_numpy(py),
        torch.from_numpy(s_idx), mesh)
