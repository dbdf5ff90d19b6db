#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``tpuprt_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--exr PATH] [--profile]

Phases, one JSON line each; any failure raises and exits nonzero:

1. build   -- compile ``tpuprt_torch/ops/csrc/bvh_tiles.cu`` with nvcc.
2. parity  -- config4_big (100K triangles, NN <= 22000 tile rows): its
   512x512x4 camera rays and 256K random rays, nearest and any-hit, through
   the kernel and through its plain torch version on the card.
3. parity  -- the 1M-triangle terrain (NN > 22000, the contract of the
   TPU's chunked tile walk), 64K random rays, both modes.
4. render  -- config4_big at full size through load_scene -> render ->
   write_exr on the card; the kernel's launch count must be > 0, the image
   finite and inside a band around scenes/bench4.exr.

Then the card's name and power limit, the kernel table, and as the last
line ``{"ok": true, "device": {...}}``. Without a CUDA device it exits
nonzero and prints no result. ``--exr PATH`` also keeps the rendered image;
``--profile`` profiles one more render (phase "profile").
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SCENE = os.path.join(ROOT, "scenes", "config4_big.pbrt")
GOLDEN = os.path.join(ROOT, "scenes", "bench4.exr")

# bench.py's rays/s convention for config4_big: camera + shadow rays of the
# reference pbrt-v1 run (bench.py CONFIG4_REF_RAYS).
CONFIG4_REF_RAYS = 1.05e6 + 0.387e6
# Band around bench4.exr, in test_golden._compare's measures: twice what
# tpuprt.render(config4_big) on the CPU shows against the same file
# (blurred relative error 0.008569, relative mean difference 0.000317).
BAND_REL = 2 * 0.008569
BAND_MEAN = 2 * 0.000317
T_RTOL = 1e-6             # kernel vs plain: t agreement (relative)
SCALE_TERRAIN_N = 708     # bench.py's 1M-triangle terrain grid


def emit(**kw):
    print(json.dumps(kw), flush=True)


def random_rays(n, seed):
    """Packed f32[8, n] rays over the [-1,1]^2 terrain: most aim from above
    at it, a quarter point in random directions, a fifth carry a short
    maxt (the mix of camera, bounce and shadow rays)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.5, 1.5, n)
    tgt = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    tgt[:, 1] = rng.uniform(-0.4, 0.4, n)
    d = tgt - o
    d[::4] = rng.normal(size=(len(d[::4]), 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mint = np.full(n, 1e-3, np.float32)
    maxt = np.full(n, 1e30, np.float32)
    maxt[1::5] = rng.uniform(0.2, 2.0, len(maxt[1::5]))
    return np.ascontiguousarray(np.concatenate(
        [o, d.astype(np.float32), mint[:, None], maxt[:, None]], 1).T)


def camera_rays(scene, opts, device):
    """Packed f32[8, N] camera rays of every (pixel, sample) of the film,
    as the render's lane pool generates them."""
    import torch
    from tpuprt_torch.cameras import cameras as cam
    from tpuprt_torch.samplers import samplers as smp
    spp = smp.samples_per_pixel(opts.sampler)
    lin = torch.arange(opts.xres * opts.yres * spp, device=device)
    pix = lin // spp
    cs = smp.camera_samples(opts.sampler, (pix % opts.xres).int(),
                            (pix // opts.xres).int(), (lin % spp).int(),
                            opts.seed)
    o, d, mint, maxt = cam.generate_rays(scene.camera, cs["image_x"],
                                         cs["image_y"], opts.xres, opts.yres)
    return torch.cat([o, d, mint[:, None], maxt[:, None]], 1).T.contiguous()


def sort_packed(bvh, rays):
    """The front end's coherence order (ops/bvh_cuda.intersect), so the
    kernel is timed on rays as the render hands them over."""
    from tpuprt_torch.ops import bvh_cuda
    order = bvh_cuda.sort_key(bvh, rays[0:3].T, rays[3:6].T).argsort(
        stable=True)
    return rays[:, order].contiguous()


def timed(fn, reps=5):
    """Median time (ms) of `reps` calls between CUDA events on the current
    stream, after a warm-up call; returns (ms, result of the last call)."""
    import torch
    out = fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2], out


def compare(ref, got):
    """Kernel (t, id) against the plain version's: equal hit masks, equal
    ids where both hit except at ties (t equal within T_RTOL), t within
    T_RTOL relative. Returns the counts; the caller fails on any."""
    import torch
    t_ref, id_ref = ref
    t, ids = got
    hit_ref, hit = id_ref >= 0, ids >= 0
    both = hit_ref & hit
    rel = (t - t_ref).abs() / t_ref.abs().clamp(min=1e-30)
    tie = rel <= T_RTOL
    return dict(
        rays=int(t.numel()), hits=int(hit_ref.sum()),
        hit_mask_mismatch=int((hit_ref != hit).sum()),
        id_mismatch=int((both & (ids != id_ref) & ~tie).sum()),
        id_mismatch_at_ties=int((both & (ids != id_ref) & tie).sum()),
        t_rel_max=float(torch.where(both, rel, 0.0).max()),
        max_abs_err=float(torch.where(both, (t - t_ref).abs(), 0.0).max()))


def parity(label, bvh, rays, reps=5):
    """Kernel vs plain version on one packed ray set, both modes."""
    from tpuprt_torch.ops import bvh_cuda
    results = []
    for any_hit in (False, True):
        args = (bvh.nodesT, bvh.nodeskip, bvh.nodemeta, rays)
        kw = dict(nn=bvh.n_nodes, any_hit=any_hit)
        ms, got = timed(lambda: bvh_cuda.traverse_tiles(*args, **kw), reps)
        plain_ms, ref = timed(
            lambda: bvh_cuda.traverse_tiles_ref(*args, **kw), reps)
        r = compare(ref, got)
        r.update(phase="parity", set=label, nn=bvh.n_nodes,
                 mode="any" if any_hit else "nearest", ms=ms,
                 plain_ms=plain_ms)
        emit(**r)
        if r["hit_mask_mismatch"] or r["id_mismatch"] or \
                r["t_rel_max"] > T_RTOL:
            raise AssertionError(f"kernel disagrees with plain version: {r}")
        results.append(r)
    return results


def scale_scene(device):
    """bench.py's 1M-triangle terrain (config4's lights and camera, plain
    matte), built through the port's SceneBuilder."""
    import numpy as np
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_scenes import terrain
    from tpuprt_torch.cameras import cameras as cam
    from tpuprt_torch.core import transform as tf
    from tpuprt_torch.scene.build import SceneBuilder
    from tpuprt_torch.scene.data import to_device
    v, f = terrain(SCALE_TERRAIN_N)
    b = SceneBuilder()
    m = b.matte(kd=(0.6, 0.55, 0.5))
    b.add_trianglemesh(np.eye(4), f, v, material=m)
    b.add_distant_light(np.eye(4), L=(2.2, 2.1, 1.9), frm=(3, 6, -4),
                        to=(0, 0, 0))
    b.add_infinite_light(np.eye(4), L=(0.8, 0.9, 1.1))
    c2w = np.asarray(tf.look_at([0, 1.1, -2.6], [0, 0, 0], [0, 1, 0]))
    b.set_camera(cam.build_projective(
        0, c2w, np.asarray(tf.perspective(55.0, 1e-2, 100.0)),
        cam.default_screen_window(512, 512), 512, 512))
    return to_device(b.build(), device), len(f)


def band(rgb, ref):
    """test_golden._compare's measures: blurred (4x4 box) relative error on
    lit regions, and the relative difference of the means."""
    import numpy as np

    def down(x, k=4):
        h, w = x.shape[:2]
        return x[:h // k * k, :w // k * k].reshape(
            h // k, k, w // k, k, -1).mean((1, 3))
    dr, dm = down(ref), down(rgb)
    lit = dr.mean(-1) > 0.02
    rel = float((np.abs(dr - dm).mean(-1)[lit] /
                 np.maximum(dr.mean(-1)[lit], 1e-3)).mean())
    mean = float(abs(rgb.mean() - ref.mean()) / max(ref.mean(), 1e-3))
    return rel, mean


def profile_render(scene, opts, device):
    """One more render under torch.profiler: device time by kernel name
    (top 12), the traversal kernel's share, and the device's idle share of
    the render's wall time (one stream, so kernels do not overlap)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tpuprt_torch import render as R
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        R.render(scene, opts, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.name] = kernels.get(ev.name, 0.0) + \
                ev.time_range.elapsed_us() / 1e3
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    trav = sum(v for k, v in kernels.items() if "bvh_tiles" in k)
    emit(phase="profile", scene="config4_big", wall_ms=wall * 1e3,
         device_busy_ms=busy, device_idle_share=1.0 - busy / (wall * 1e3),
         traversal_ms=trav, traversal_share_of_busy=trav / max(busy, 1e-9),
         n_device_ops=len(kernels), top_ms=[[k[:80], v] for k, v in top])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--exr", help="also keep the rendered image here")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one more render: device time by "
                    "kernel and the device's idle share")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np
    from tpuprt_torch import render as R
    from tpuprt_torch.io.exr import read_exr, write_exr
    from tpuprt_torch.ops import bvh_cuda
    from tpuprt_torch.scene.data import to_device
    from tpuprt_torch.scene.parser import load_scene

    device = "cuda"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    # 1. Build the kernel from the checkout's source.
    t0 = time.perf_counter()
    bvh_cuda.load_kernel()
    emit(phase="build", source=os.path.relpath(bvh_cuda.KERNEL_SRC, ROOT),
         seconds=time.perf_counter() - t0)

    # 2. Kernel vs plain version at config4_big (NN <= 22000).
    t0 = time.perf_counter()
    scene, opts = load_scene(SCENE)
    load_s = time.perf_counter() - t0
    scene_d = to_device(scene, device)
    bvh = scene_d.accel
    emit(phase="load", scene="config4_big", seconds=load_s,
         triangles=scene.triangles.count, nn=bvh.n_nodes)
    assert bvh.n_nodes <= 22000, bvh.n_nodes
    cam_rays = sort_packed(bvh, camera_rays(scene_d, opts, device))
    rnd_rays = sort_packed(bvh, torch.from_numpy(random_rays(1 << 18, 1))
                           .to(device))
    res = parity("config4_big/camera", bvh, cam_rays)
    res += parity("config4_big/random", bvh, rnd_rays)
    del cam_rays, rnd_rays

    # 3. Kernel vs plain version above 22000 nodes (1M triangles).
    t0 = time.perf_counter()
    big, ntris = scale_scene(device)
    emit(phase="load", scene=f"terrain({SCALE_TERRAIN_N})",
         seconds=time.perf_counter() - t0, triangles=ntris,
         nn=big.accel.n_nodes)
    assert big.accel.n_nodes > 22000, big.accel.n_nodes
    res += parity(f"terrain{SCALE_TERRAIN_N}/random", big.accel,
                  sort_packed(big.accel, torch.from_numpy(
                      random_rays(1 << 16, 2)).to(device)), reps=3)
    del big

    # 4. The main path: load_scene -> render -> write_exr on the card, with
    # bench.py's settings for config4_big (2^17 lanes, f16 readback).
    ref, _ = read_exr(GOLDEN)
    opts = opts._replace(chunk_size=1 << 17, half_readback=True)
    bvh_cuda.launches = 0
    t0 = time.perf_counter()
    rgb, alpha = R.render(scene, opts, device=device)
    first_s = time.perf_counter() - t0
    launches = bvh_cuda.launches
    with tempfile.TemporaryDirectory() as tmp:
        out = args.exr or os.path.join(tmp, opts.filename)
        write_exr(out, rgb, alpha)
        back, _ = read_exr(out)
    rel, mean = band(rgb, ref)
    t0 = time.perf_counter()
    R.render(scene, opts, device=device)
    wall = time.perf_counter() - t0
    emit(phase="render", scene="config4_big", shape=list(rgb.shape),
         spp=opts.sampler.pixelsamples, launches=launches,
         finite=bool(np.isfinite(rgb).all()), band_rel=rel,
         band_rel_limit=BAND_REL, band_mean=mean, band_mean_limit=BAND_MEAN,
         first_render_s=first_s, wall_s=wall,
         rays_per_s=CONFIG4_REF_RAYS / wall)
    assert launches > 0, "the render launched no traversal kernel"
    assert rgb.shape == (512, 512, 3) and np.isfinite(rgb).all()
    assert back.shape == rgb.shape
    assert rel <= BAND_REL and mean <= BAND_MEAN, (rel, mean)
    if args.profile:
        profile_render(scene, opts, device)

    print(smi, flush=True)
    cam_near = res[0]
    emit(kernels=[dict(
        name="bvh_tiles", route="cuda",
        source=os.path.relpath(bvh_cuda.KERNEL_SRC, ROOT),
        replaces="tpuprt/ops/bvh_pallas.py:860",
        also_replaces="tpuprt/ops/bvh_pallas.py:1010",
        launches=launches,
        max_abs_err=max(r["max_abs_err"] for r in res),
        ms=cam_near["ms"], plain_ms=cam_near["plain_ms"],
        timed_on="config4_big camera rays, nearest",
        parity=[{k: r[k] for k in ("set", "mode", "nn", "hit_mask_mismatch",
                                   "id_mismatch", "t_rel_max")}
                for r in res])])
    emit(ok=True, device=dict(platform="gpu",
                              kind=torch.cuda.get_device_name(0),
                              count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
