"""Render driver (port of tpuprt/render.py: RenderOptions, the routing to
the regenerating wavefront pool, the chunked driver with its checkpoint,
resume and writefrequency, and the Li dispatch).

Routing (tpuprt/render.py:226-234), by `RenderOptions.driver`: "auto"
sends path, directlighting, whitted and photonmap to the pool
(integrators/path_wavefront.py) unless a checkpoint, a resume or a
writefrequency is asked for, and every other integrator (debug, igi,
irradiancecache, bidirectional, exphotonmap) to the chunked driver;
"scan" sends every integrator to the chunked driver; "wavefront" forces
the pool. A photonmap scene with volumes leaves the pool for the chunked
driver, as in tpuprt.

Volumes (tpuprt/render.py:130-150): Li's camera segment, from the camera
to the first hit (each integrator's t_first), is composed as pbrt-v1's
Scene::Li composes it (core/scene.cpp:120-126), L = T L + Lv, with T its
transmittance and Lv the volume integrator's ("emission" or "single",
integrators/volume.py) radiance along it; the streams are keyed by the
pixel hash of salt 0xF0 and purpose 0x7A. The pool composes the same on
its bounce-0 lanes (integrators/path_wavefront.py).

The chunked driver (tpuprt/render.py:115-165, 246-330): the integrator's
preprocess on the render's device, then chunks of (pixel, sample) ids,
each camera rays with their +x/+y differential rays, the integrator's Li
(li: the scan forms of every integrator), the radiance guards and the
film's splat. A chunk's lanes come from the device's free memory (tpuprt
caps them for the TPU, exphotonmap's at 4096): every stream is keyed by
(pixel, sample, depth, purpose), so the chunk changes no sample's result.
A render that writes or reads a checkpoint, or writes its partial image
every `writefrequency` samples, chunks by `opts.chunk_size` instead, as
tpuprt does: the checkpoint's chunk index is valid only at that size,
which its fingerprint holds.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from .accel.photon_grid import block_rows
from .cameras import cameras as cam_mod
from .core import rng
from .film import film as film_mod
from .integrators import (bidirectional, debug, directlighting, exphotonmap,
                          igi, irradiancecache, path, path_wavefront,
                          photonmap, volume, whitted)
from .io import exr
from .ops import bvh_cuda, mt_cuda
from .samplers import samplers as smp
from .scene.data import BvhAccel, SceneData, to_device
from .utils.progress import ProgressReporter
from .volumes import regions as vr

# The integrators "auto" sends to the wavefront pool.
POOL = ("path", "directlighting", "whitted", "photonmap")
DRIVERS = ("auto", "scan", "wavefront")
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
    direct_strategy: str = "all"       # directlighting: all|one|weighted
    debug_channels: tuple = ("u", "v", "hit")
    # Re-write the partial image every this many samples (film/image.cpp:
    # 142-146, the film's writefrequency), rounded up to whole chunks;
    # <= 0: never.
    writefrequency: int = -1
    # "auto", "scan" (the chunked driver for every integrator) or
    # "wavefront" (the pool); see the module's docstring.
    driver: str = "auto"
    volume_integrator: str = "emission"   # emission | single


def render(scene: SceneData, opts: RenderOptions, device="cuda",
           maps=None, aux=None, stats=None, checkpoint_path: str = None,
           resume: bool = False, progress: bool = False):
    """Full-frame render on `device`: the card by default (the traversal
    kernels), or "cpu" on request (their plain versions). Without a CUDA
    device a render that did not ask for the CPU raises. Returns (rgb
    f32[yres,xres,3], alpha f32[yres,xres]) as numpy arrays. A photonmap
    render shoots its photons and builds its maps on `device` first
    (tpuprt/render.py:262-267), unless `maps` (integrators.photonmap.
    PhotonMaps) are given; a render of the chunked driver runs its
    integrator's preprocess first unless `aux` (its result) is given.
    stats: a utils.stats.StatsRegistry that receives tpuprt's counters
    (tpuprt/render.py:213-236), the pool's or the chunked driver's
    (render_chunked). progress: a ProgressReporter bar on stderr.
    checkpoint_path, resume: the chunked driver saves the film and its
    next chunk there with each partial image (writefrequency), and with
    resume starts from the checkpoint found there (tpuprt/render.py:
    287-318)."""
    require_device("render()", device)
    if opts.driver not in DRIVERS:
        raise ValueError(f"unknown driver {opts.driver!r}; one of {DRIVERS}")
    scene = on_device(scene, device)
    pool_ok = opts.integrator in POOL and checkpoint_path is None and \
        not resume and not opts.writefrequency > 0 and not (
            opts.integrator == "photonmap" and vr.present(scene.volumes))
    if opts.driver == "wavefront" or (opts.driver == "auto" and pool_ok):
        kw = {} if maps is None else {"maps": to_device(maps, device)}
        return path_wavefront.render(scene, opts, device, progress=progress,
                                     stats=stats, **kw)
    return render_chunked(scene, opts, device,
                          aux=maps if aux is None else aux, stats=stats,
                          checkpoint_path=checkpoint_path, resume=resume,
                          progress=progress)


def compose_volumes(scene: SceneData, opts: RenderOptions, L, o, d, mint,
                    t_first, px, py, s_idx):
    """L = T L + Lv over the camera segment [mint, t_first] (the module's
    docstring); L itself without volumes."""
    if not vr.present(scene.volumes):
        return L
    ph = rng.hash_u32(px, py, opts.seed, 0xF0)
    u = rng.uniform(ph, s_idx, 0x7A)
    T = volume.transmittance(scene, o, d, mint, t_first, u)
    if opts.volume_integrator == "single":
        Lv = volume.li_single(scene, o, d, mint, t_first, ph, s_idx,
                              opts.seed)
    else:
        Lv = volume.li_emission(scene, o, d, mint, t_first, u)
    return T * L + Lv


def require_device(caller: str, device):
    """Raise when `device` is the card and there is none: an entry point
    runs on the CPU only when its caller asks for it."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{caller}: no CUDA device; pass device=\"cpu\" "
                           "to run the plain versions")


def on_device(scene: SceneData, device) -> SceneData:
    """The scene's tables on `device` as the renderer walks them: of a BVH
    only the format the front end walks, and for the brute force the
    dense kernel's triangles packed once (tris_packed). A scene whose main
    aggregate holds no triangle or quadric (instances only, or an object
    never instanced) loads, and raises IndexError here, as every render
    of it by tpuprt fails in hit_geometry's gather from the empty quadric
    table (tpuprt/accel/intersect.py:242-244)."""
    if not (scene.triangles.count or scene.quadrics.count):
        raise IndexError("the scene's main aggregate holds no triangle or "
                         "quadric")
    if isinstance(scene.accel, BvhAccel):
        scene = dataclasses.replace(scene,
                                    accel=bvh_cuda.walked_only(scene.accel))
    elif scene.accel is None and scene.triangles.count:
        scene = dataclasses.replace(
            scene, tris_packed=mt_cuda.pack_table(scene.triangles))
    return to_device(scene, device)


def preprocess(scene: SceneData, opts: RenderOptions, stats: dict = None):
    """The chunked integrator's preprocess (Scene::Render -> Preprocess,
    core/scene.cpp:38; tpuprt/render.py:261-280) on the scene's device:
    photonmap's maps, igi's virtual lights, the irradiance cache, or
    exphotonmap's maps and radiance photons; None for the others."""
    if opts.integrator == "photonmap":
        return photonmap.build_maps(scene, opts.photon or
                                    photonmap.PhotonParams(), opts.seed)
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
       py, s_idx, rx=None, ry=None):
    """_li_dispatch (tpuprt/render.py:66-112): the scan form of
    `opts.integrator`'s Li on camera rays (o, d, mint, maxt) with ids (px,
    py, s_idx), its preprocess state `aux` and the +x/+y differential rays
    rx, ry (or None). Returns (L, alpha, t_first)."""
    integ, cfg = opts.integrator, opts.sampler
    if integ == "debug":
        return debug.li(scene, o, d, mint, maxt, opts.debug_channels)
    if integ == "directlighting":
        return directlighting.li(scene, o, d, mint, maxt, cfg, px, py, s_idx,
                                 opts.max_depth, opts.seed,
                                 opts.direct_strategy, rx=rx, ry=ry)
    if integ in ("whitted", "path", "bidirectional"):
        module = {"whitted": whitted, "path": path,
                  "bidirectional": bidirectional}[integ]
        return module.li(scene, o, d, mint, maxt, cfg, px, py, s_idx,
                         opts.max_depth, opts.seed, rx=rx, ry=ry)
    if integ not in ("photonmap", "igi", "irradiancecache", "exphotonmap"):
        raise ValueError(f"unknown integrator {integ}")
    module, prm = {
        "photonmap": (photonmap, opts.photon or photonmap.PhotonParams()),
        "igi": (igi, opts.igi or igi.IgiParams()),
        "irradiancecache": (irradiancecache,
                            opts.irrad or irradiancecache.IrradParams()),
        "exphotonmap": (exphotonmap,
                        opts.photon or exphotonmap.ExPhotonParams()),
    }[integ]
    return module.li(scene, aux, o, d, mint, maxt, cfg, px, py, s_idx,
                     opts.max_depth, opts.seed, prm, rx=rx, ry=ry)


def render_chunk(scene: SceneData, opts: RenderOptions, film, px, py, s_idx,
                 aux=None):
    """One chunk (tpuprt/render.py:115-165): camera rays and their +x/+y
    differential rays, Li, the volumes' composition (compose_volumes), the
    radiance guards (a NaN, negative or infinite sample is black,
    core/scene.cpp:60-74), the splat."""
    cs = smp.camera_samples(opts.sampler, px, py, s_idx, opts.seed)
    ix, iy = cs["image_x"], cs["image_y"]
    # The +1-pixel differential rays keep the lens and time samples
    # (tpuprt/render.py:119-129).
    lens = (cs["lens_u"], cs["lens_v"], cs["time"], opts.xres, opts.yres)
    o, d, mint, maxt, _ = cam_mod.generate_rays(scene.camera, ix, iy, *lens)
    rx = cam_mod.generate_rays(scene.camera, ix + 1.0, iy, *lens)[:2]
    ry = cam_mod.generate_rays(scene.camera, ix, iy + 1.0, *lens)[:2]
    L, alpha, t_first = li(scene, opts, aux, o, d, mint, maxt, px, py,
                           s_idx, rx, ry)
    L = compose_volumes(scene, opts, L, o, d, mint, t_first, px, py, s_idx)
    bad = torch.any(~torch.isfinite(L) | (L < 0.0), dim=-1)
    L = torch.where(bad[..., None], 0.0, L)
    film_mod.add_samples(film, ix, iy, L, alpha, opts.filter_kind,
                         opts.filter_xwidth, opts.filter_ywidth)


def chunk_lanes(device, total: int) -> int:
    """Lanes of a chunk: what a share of the card's free memory holds, or
    2^16 on the CPU."""
    return int(min(total, block_rows(device, _LANE_BYTES, 1 << 16)))


def _render_fingerprint(opts: RenderOptions) -> str:
    """The sample schedule a checkpoint belongs to (tpuprt/render.py:
    174-180): resuming under another would blend wrong pixels."""
    return repr((opts.xres, opts.yres, tuple(opts.crop), opts.seed,
                 opts.sampler, opts.integrator, opts.max_depth,
                 opts.filter_kind, opts.filter_xwidth, opts.filter_ywidth,
                 opts.chunk_size))


def save_checkpoint(path: str, film, next_chunk: int,
                    opts: RenderOptions = None):
    """The film's planes and the next chunk's index (tpuprt/render.py:
    183-196), an .npz at `path`: deterministic streams make a resume from
    that chunk redo exactly the work left."""
    data = film.data.detach().cpu().numpy()
    np.savez(path, pixels=data[..., 0:3], alpha=data[..., 3],
             weight_sum=data[..., 4], next_chunk=np.int64(next_chunk),
             fingerprint=np.array(
                 _render_fingerprint(opts) if opts is not None else ""))


def load_checkpoint(path: str, opts: RenderOptions, device="cuda"):
    """(film on `device`, next_chunk) from save_checkpoint's file
    (tpuprt/render.py:199-210); refuses one written under another sample
    schedule."""
    z = np.load(path)
    saved = str(z["fingerprint"])
    if saved and saved != _render_fingerprint(opts):
        raise ValueError(
            f"checkpoint {path} was written by a different render "
            "configuration (resolution/sampler/seed/integrator...); "
            "refusing to resume into it")
    film = film_mod.from_planes(z["pixels"], z["alpha"], z["weight_sum"],
                                opts.xres, opts.yres, opts.crop, device)
    return film, int(z["next_chunk"])


def render_chunked(scene: SceneData, opts: RenderOptions, device, aux=None,
                   stats=None, checkpoint_path: str = None,
                   resume: bool = False, progress: bool = False):
    """The chunked driver (tpuprt/render.py:246-330) on a scene whose
    tables live on `device`: chunks sized from free memory, or by
    opts.chunk_size when a checkpoint, a resume or a writefrequency is
    asked for; every `writefrequency` samples (in whole chunks) but after
    the last chunk, the partial image to opts.filename and, with
    checkpoint_path, the checkpoint; with resume, the chunks after a
    checkpoint found at checkpoint_path. progress: a bar over the chunks.
    stats (a StatsRegistry) receives tpuprt's counters (tpuprt/render.py:
    333-342): the samples taken (those of the chunks rendered; tpuprt's
    fixed chunks count their padding lanes too), the rays generated with
    their differentials, the chunks, the wall and samples per second; and
    the port's own: the chunk's lanes, the preprocess's seconds and its
    counts (category "Preprocess": a list summed, a dict's entries as
    "<key> <entry>", None left out)."""
    t0 = time.perf_counter()
    cuda = torch.device(device).type == "cuda"
    pre = {} if stats is not None else None
    if aux is None:
        aux = preprocess(scene, opts, pre)
    else:
        aux = to_device(aux, device)
    if stats is not None:
        if cuda:
            torch.cuda.synchronize(device)
        stats.add("Performance", "Preprocess seconds",
                  time.perf_counter() - t0)
        for k, v in pre.items():
            for name, x in (v.items() if isinstance(v, dict) else
                            [(None, v)]):
                if x is not None:       # None: a map that never filled
                    stats.add("Preprocess", k if name is None else
                              f"{k} {name}", sum(x) if isinstance(x, list)
                              else x)
    film = film_mod.make_film(opts.xres, opts.yres, opts.crop, device)
    xstart, xcount, ystart, ycount = film_mod.pixel_extent(film)
    spp = smp.samples_per_pixel(opts.sampler)
    total = xcount * ycount * spp
    fixed = checkpoint_path is not None or resume or opts.writefrequency > 0
    chunk = min(opts.chunk_size, total) if fixed else \
        chunk_lanes(device, total)
    n_chunks = math.ceil(total / chunk)
    start = 0
    if resume and checkpoint_path is not None and \
            os.path.exists(checkpoint_path):
        film, start = load_checkpoint(checkpoint_path, opts, device)
    write_every = math.ceil(opts.writefrequency / chunk) \
        if opts.writefrequency > 0 else 0
    rep = ProgressReporter(n_chunks - start, "Rendering") if progress \
        else None
    for c in range(start, n_chunks):
        lin = torch.arange(c * chunk, min((c + 1) * chunk, total),
                           device=device)
        pix = lin // spp
        render_chunk(scene, opts, film,
                     (xstart + pix % xcount).to(torch.int32),
                     (ystart + pix // xcount).to(torch.int32),
                     (lin % spp).to(torch.int32), aux)
        if write_every and (c + 1) % write_every == 0 and c + 1 < n_chunks:
            rgb_p, alpha_p = film_mod.develop(film)
            exr.write_exr(opts.filename, rgb_p.cpu().numpy(),
                          alpha_p.cpu().numpy())
            if checkpoint_path is not None:
                save_checkpoint(checkpoint_path, film, c + 1, opts)
        if rep is not None:
            if cuda:
                torch.cuda.synchronize(device)
            rep.update()
    if rep is not None:
        rep.done()
    rgb, alpha = film_mod.develop(film)
    if opts.half_readback:
        rgb, alpha = film_mod.to_half(rgb, alpha)
    rgb = rgb.to(torch.float32).cpu().numpy()
    if stats is not None:
        wall = time.perf_counter() - t0
        samples = total - min(start * chunk, total)
        stats.add("Camera", "Samples taken", samples)
        stats.add("Camera", "Rays generated (incl. differentials)",
                  3 * samples)
        stats.add("Film", "Wavefront chunks", n_chunks - start)
        stats.add("Film", "Chunk lanes", chunk)
        stats.add("Performance", "Wall-clock seconds", round(wall, 3))
        stats.add("Performance", "Samples per second",
                  int(samples / max(wall, 1e-9)))
    return rgb, alpha.to(torch.float32).cpu().numpy().astype(np.float32)
