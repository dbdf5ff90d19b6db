"""Frames: a configuration rendered frame after frame through the
renderer's main entry, `render.render()`, each frame with its own sample
seed and its image read back to the host, as the renderer's command line
renders a file (its options, f16 readback, the pool of `lanes`, the
driver the cell names).

A run: set-up (parse, build, tables to the card, a warm-up render), the
window (whole frames until `seconds` have passed; frame_s is the window's
wall over its frames), then the check of frames drawn from the seed
against the reference, once the program's state is freed.

The warm-up renders a whole frame, or, where the cell gives
`warm_samples`, a square crop in the film's middle that holds at least
that many samples: the pool runs its fixed lanes on any crop, so a crop of
twice the lanes runs every shape a frame runs (first fill, refills, the
drain) at a fraction of a frame's time.
"""
from __future__ import annotations

import gc
import math
import os
import sys
import time

import numpy as np
import torch

from . import compare, registry
from .seeds import Seeds
from .trace import profiled


def launch_total():
    """Kernel launches so far, from the renderer's own counters (an
    any-hit launch is also counted under its kernel's name)."""
    from tpuprt_torch.ops import bvh_cuda, mt_cuda
    return sum(v for c in (bvh_cuda.launches, mt_cuda.launches)
               for k, v in c.items() if not k.endswith("_any"))


def scene_path(cfg: dict) -> str:
    return os.path.join(registry.ROOT, cfg["scene"])


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def setup(cfg, wl, device, window=None):
    """(scene on the device, options): the file's options with the
    product's f16 readback, the cell's lanes and driver; `window` (x0,
    x1, y0, y1 pixels) crops the film (the CPU tests only)."""
    from tpuprt_torch import render as R
    from tpuprt_torch.scene.parser import load_scene
    scene, opts = load_scene(scene_path(cfg))
    opts = opts._replace(half_readback=True,
                         chunk_size=int(wl.get("lanes", opts.chunk_size)),
                         driver=wl.get("driver", "auto"))
    if window is not None:
        x0, x1, y0, y1 = window
        opts = opts._replace(crop=(x0 / opts.xres, x1 / opts.xres,
                                   y0 / opts.yres, y1 / opts.yres))
    sc = R.on_device(scene, device)
    sync(device)
    return sc, opts


def warm_opts(opts, wl):
    """The warm-up's options: a centred crop of at least the cell's
    `warm_samples`, or the whole film where it gives none."""
    n = wl.get("warm_samples")
    if n is None:
        return opts
    side = math.ceil(math.sqrt(int(n) / _spp(opts)))
    w, h = min(side, opts.xres), min(side, opts.yres)
    x0, y0 = (opts.xres - w) // 2, (opts.yres - h) // 2
    return opts._replace(crop=(x0 / opts.xres, (x0 + w) / opts.xres,
                               y0 / opts.yres, (y0 + h) / opts.yres))


def render(sc, opts, seed, device, stats=None):
    """One frame through render.render(): (rgb f16 [H,W,3], alpha f16)."""
    from tpuprt_torch import render as R
    rgb, alpha = R.render(sc, opts._replace(seed=seed), device=device,
                          stats=stats)
    return rgb.astype(np.float16), alpha.astype(np.float16)


def reference_frames(cfg, frames, device, window=None, dtype=torch.float32):
    """The reference's images (rgb, alpha numpy f32) of frame seeds, and
    the reference, its `rays` the mean of the frames' ray counts."""
    rr = registry.reference(cfg)
    ref = rr.Reference(rr.load(scene_path(cfg)), device, dtype)
    out, rays = [], {}
    for s in frames:
        rgb, alpha = ref.frame(s, window)
        out.append((rgb.float().cpu().numpy(), alpha.float().cpu().numpy()))
        for k, v in ref.rays.items():
            rays[k] = rays.get(k, 0) + v / len(frames)
    ref.rays = rays
    return out, ref


def numbers(images, refs, window=None):
    """The worst of each number over the frames."""
    rows = []
    for (rgb, alpha), (rr_, ra) in zip(images, refs):
        if window is not None:
            x0, x1, y0, y1 = window
            cut = (slice(y0, y1), slice(x0, x1))
            rgb, alpha, rr_, ra = rgb[cut], alpha[cut], rr_[cut], ra[cut]
        rows.append(compare.frame_numbers(rgb, alpha, rr_, ra))
    return compare.worst(rows)


def run(args, cfg, wl, device, window, t0):
    from tpuprt_torch.utils.stats import StatsRegistry
    out = {}
    seeds = Seeds(args.seed)
    t = time.perf_counter()
    sc, opts = setup(cfg, wl, device, window)
    out["load_s"] = time.perf_counter() - t
    render(sc, warm_opts(opts, wl) if window is None else opts, seeds.warm,
           device)                                     # builds and warms
    sync(device)
    out["setup_peak"] = _peak(device, reset=True)
    out["setup_s"] = time.perf_counter() - t0

    stats = StatsRegistry() if args.trace else None
    limit = min(args.seconds, float(wl.get("trace_seconds", args.seconds))) \
        if args.trace else args.seconds
    images, frame_seeds, ends, tr = [], [], [], {}
    n0 = launch_total()
    with profiled(args.trace, tr):
        t1 = time.perf_counter()
        while True:
            s = seeds.frame(len(images))
            images.append(render(sc, opts, s, device, stats))
            frame_seeds.append(s)
            ends.append(time.perf_counter())
            if ends[-1] - t1 >= limit:
                break
        sync(device)
        t2 = time.perf_counter()
    walls = np.diff([t1] + ends)
    print(f"window: {len(images)} frames, the first {float(walls[0])!r} s, "
          f"their median {float(np.median(walls))!r} s", file=sys.stderr)
    out.update(window_s=t2 - t1, n=len(images),
               frame_s=(t2 - t1) / len(images),
               launches=launch_total() - n0, stats=stats, trace=tr,
               lanes=min(opts.chunk_size, opts.xres * opts.yres *
                         _spp(opts)),
               window_peak=_peak(device))
    del sc
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    pick = seeds.checked(len(images), int(wl.get("check_frames", 1)))
    refs, ref = reference_frames(cfg, [frame_seeds[k] for k in pick],
                                 device, window)
    got = [tuple(a.astype(np.float32) for a in images[k]) for k in pick]
    out.update(numbers=numbers(got, refs, window), checked=len(pick),
               ref_scene=ref.sc, ref_rays=ref.rays, attempted=len(images))
    return out


def _spp(opts):
    from tpuprt_torch.samplers import samplers as smp
    return smp.samples_per_pixel(opts.sampler)


def _peak(device, reset=False):
    if torch.device(device).type != "cuda":
        return 0
    v = torch.cuda.max_memory_allocated()
    if reset:
        torch.cuda.reset_peak_memory_stats()
    return v
