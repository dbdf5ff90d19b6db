"""Render driver (port of tpuprt/render.py: RenderOptions, the routing to
the regenerating wavefront pool, and the chunked driver).

Path, directlighting, whitted and photonmap go to the pool
(integrators/path_wavefront.py), as tpuprt's "auto" routes them; the port
has no volumes (the parser raises on a Volume statement), so every
photonmap scene goes there. igi, irradiancecache, bidirectional and
exphotonmap go to the chunked driver (tpuprt/render.py:115-165, 246-330):
the integrator's preprocess on the render's device, then chunks of
(pixel, sample) ids, each camera rays with their +x/+y differential rays,
the integrator's Li, the radiance guards and the film's splat. Checkpoint,
resume and writefrequency are not ported.

A chunk's lanes come from the device's free memory (tpuprt caps them for
the TPU, exphotonmap's at 4096): every stream is keyed by (pixel, sample,
depth, purpose), so the chunk changes no sample's result.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from .accel.photon_grid import block_rows
from .cameras import cameras as cam_mod
from .film import film as film_mod
from .integrators import (bidirectional, exphotonmap, igi, irradiancecache,
                          path_wavefront)
from .lights import lights as lt
from .ops import bvh_cuda, mt_cuda
from .samplers import samplers as smp
from .scene.data import BvhAccel, SceneData, to_device

# The integrators the chunked driver renders.
CHUNKED = ("igi", "irradiancecache", "bidirectional", "exphotonmap")
# Bytes a chunk's lane holds outside the blocks its integrator sizes
# itself: its rays, hit record, BSDF, light samples and radiance.
_LANE_BYTES = 16384


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
    photon: tuple = ()                 # PhotonParams (photonmap) or
                                       # ExPhotonParams (exphotonmap)
    igi: tuple = ()                    # IgiParams when igi
    irrad: tuple = ()                  # IrradParams when irradiancecache


def render(scene: SceneData, opts: RenderOptions, device="cuda",
           maps=None, aux=None, stats: dict = None):
    """Full-frame render on `device`: the card by default (the traversal
    kernels), or "cpu" on request (their plain versions). Without a CUDA
    device a render that did not ask for the CPU raises. Returns (rgb
    f32[yres,xres,3], alpha f32[yres,xres]) as numpy arrays. A photonmap
    render shoots its photons and builds its maps on `device` before the
    pool starts (tpuprt/render.py:262-267), unless `maps`
    (integrators.photonmap.PhotonMaps) are given; a render of the chunked
    driver runs its integrator's preprocess first unless `aux` (its
    result) is given. stats, when given, receives the chunked driver's
    preprocess seconds and the preprocess's own stats, and its chunks."""
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
    scene = to_device(scene, device)
    if opts.integrator in CHUNKED:
        return render_chunked(scene, opts, device, aux=aux, stats=stats)
    kw = {} if maps is None else {"maps": to_device(maps, device)}
    return path_wavefront.render(scene, opts, device, **kw)


def preprocess(scene: SceneData, opts: RenderOptions, stats: dict = None):
    """The chunked integrator's preprocess (Scene::Render -> Preprocess,
    core/scene.cpp:38; tpuprt/render.py:261-280) on the scene's device:
    igi's virtual lights, the irradiance cache, or exphotonmap's maps and
    radiance photons; None for bidirectional."""
    if opts.integrator == "igi":
        return igi.build_virtual_lights(scene, opts.igi or igi.IgiParams(),
                                        opts.seed)
    if opts.integrator == "irradiancecache":
        return irradiancecache.build_cache(
            scene, opts.irrad or irradiancecache.IrradParams(), opts.xres,
            opts.yres, opts.seed, stats=stats)
    if opts.integrator == "exphotonmap":
        return exphotonmap.build_aux(
            scene, opts.photon or exphotonmap.ExPhotonParams(), opts.seed,
            stats=stats)
    return None


def li(scene: SceneData, opts: RenderOptions, aux, o, d, mint, maxt, px,
       py, s_idx, rx, ry):
    """_li_dispatch (tpuprt/render.py:66-112) for the chunked integrators."""
    if opts.integrator == "bidirectional":
        return bidirectional.li(scene, o, d, mint, maxt, opts.sampler, px,
                                py, s_idx, opts.max_depth, opts.seed, rx=rx,
                                ry=ry)
    module, prm = {
        "igi": (igi, opts.igi or igi.IgiParams()),
        "irradiancecache": (irradiancecache,
                            opts.irrad or irradiancecache.IrradParams()),
        "exphotonmap": (exphotonmap,
                        opts.photon or exphotonmap.ExPhotonParams()),
    }[opts.integrator]
    return module.li(scene, aux, o, d, mint, maxt, opts.sampler, px, py,
                     s_idx, opts.max_depth, opts.seed, prm, rx=rx, ry=ry)


def render_chunk(scene: SceneData, opts: RenderOptions, film, px, py, s_idx,
                 aux=None):
    """One chunk (tpuprt/render.py:115-165): camera rays and their +x/+y
    differential rays, Li, the radiance guards (a NaN, negative or infinite
    sample is black, core/scene.cpp:60-74), the splat."""
    cs = smp.camera_samples(opts.sampler, px, py, s_idx, opts.seed)
    ix, iy = cs["image_x"], cs["image_y"]
    o, d, mint, maxt = cam_mod.generate_rays(scene.camera, ix, iy, opts.xres,
                                             opts.yres)
    rx = cam_mod.generate_rays(scene.camera, ix + 1.0, iy, opts.xres,
                               opts.yres)[:2]
    ry = cam_mod.generate_rays(scene.camera, ix, iy + 1.0, opts.xres,
                               opts.yres)[:2]
    L, alpha, _ = li(scene, opts, aux, o, d, mint, maxt, px, py, s_idx, rx,
                     ry)
    bad = torch.any(~torch.isfinite(L) | (L < 0.0), dim=-1)
    L = torch.where(bad[..., None], 0.0, L)
    film_mod.add_samples(film, ix, iy, L, alpha, opts.filter_kind,
                         opts.filter_xwidth, opts.filter_ywidth)


def chunk_lanes(device, total: int) -> int:
    """Lanes of a chunk: what a share of the card's free memory holds, or
    2^16 on the CPU."""
    return int(min(total, block_rows(device, _LANE_BYTES, 1 << 16)))


def render_chunked(scene: SceneData, opts: RenderOptions, device, aux=None,
                   stats: dict = None):
    """The chunked driver (tpuprt/render.py:246-330, without checkpoints or
    writefrequency) on a scene whose tables live on `device`."""
    lt.check(scene.lights)    # once per render: it reads a table
    t0 = time.perf_counter()
    if aux is None:
        aux = preprocess(scene, opts, stats)
    else:
        aux = to_device(aux, device)
    if stats is not None:
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        stats["preprocess_s"] = time.perf_counter() - t0
    film = film_mod.make_film(opts.xres, opts.yres, opts.crop, device)
    xstart, xcount, ystart, ycount = film_mod.pixel_extent(film)
    spp = smp.samples_per_pixel(opts.sampler)
    total = xcount * ycount * spp
    chunk = chunk_lanes(device, total)
    for base in range(0, total, chunk):
        lin = torch.arange(base, min(base + chunk, total), device=device)
        pix = lin // spp
        render_chunk(scene, opts, film,
                     (xstart + pix % xcount).to(torch.int32),
                     (ystart + pix // xcount).to(torch.int32),
                     (lin % spp).to(torch.int32), aux)
    if stats is not None:
        stats.update(chunks=-(-total // chunk), chunk_lanes=chunk)
    rgb, alpha = film_mod.develop(film)
    if opts.half_readback:
        rgb, alpha = film_mod.to_half(rgb, alpha)
    return (rgb.to(torch.float32).cpu().numpy(),
            alpha.to(torch.float32).cpu().numpy().astype(np.float32))
