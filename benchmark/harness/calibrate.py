"""The readings that a cell's limits are set from, in one process on the
card (they are not part of a run):

    python3 benchmark/harness/calibrate.py --workload bench3.pool \\
        --seeds 1,2,3 --mode program|control|faults

program: the renderer's numbers, as a run checks them, on each seed;
control: the reference in bfloat16 put in the renderer's place;
faults: the renderer with a fault planted where its answer is made
(frames: a stale frame, half of each pixel's samples, a 32x32 tile
altered; steps: Adam's step a no-op, half of the pixels, the loss
altered by 1%). One JSON line per seed and reading.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from harness import compare, frames, grad, registry  # noqa: E402
from harness.seeds import Seeds  # noqa: E402

TILE = 32


def frame_readings(cfg, wl, seeds_list, mode, device, window=None):
    from tpuprt_torch.samplers import samplers as smp
    out = []
    sc, opts = frames.setup(cfg, wl, device, window)
    frames.render(sc, opts, 1, device)
    k = int(wl.get("check_frames", 1))
    for seed in seeds_list:
        S = Seeds(seed)
        fs = [S.frame(i) for i in range(k + 1)]
        t = time.perf_counter()
        refs, _ = frames.reference_frames(cfg, fs[:k], device, window)
        ref_s = time.perf_counter() - t
        if mode == "program":
            imgs = [frames.render(sc, opts, s, device) for s in fs[:k]]
            rows = {"program": imgs}
        elif mode == "control":
            ctl, _ = frames.reference_frames(cfg, fs[:k], device, window,
                                             torch.bfloat16)
            rows = {"control": ctl}
        else:
            spp = smp.samples_per_pixel(opts.sampler)
            half = opts._replace(sampler=opts.sampler._replace(
                pixelsamples=spp // 2))
            imgs = [frames.render(sc, opts, s, device) for s in fs[:k]]
            alt = []
            for rgb, a in imgs:
                rgb = rgb.astype(np.float32)
                h, w = rgb.shape[:2]
                y, x = (h - TILE) // 2, (w - TILE) // 2
                if window is not None:
                    x, y = window[0], window[2]
                rgb[y:y + TILE, x:x + TILE] *= 1.5
                alt.append((rgb, a))
            rows = {"stale": [frames.render(sc, opts, s, device)
                              for s in fs[1:k + 1]],
                    "half": [frames.render(sc, half, s, device)
                             for s in fs[:k]],
                    "tile": alt}
        for name, imgs in rows.items():
            imgs = [tuple(np.asarray(a, np.float32) for a in im)
                    for im in imgs]
            out.append(dict(seed=seed, reading=name, ref_s=ref_s,
                            **frames.numbers(imgs, refs, window)))
            print(json.dumps(out[-1]), flush=True)
    return out


def grad_readings(cfg, wl, seeds_list, mode, device, window=None):
    out = []
    for seed in seeds_list:
        S = Seeds(seed)
        t = time.perf_counter()
        ref, ref_target, _ = grad.reference_steps(cfg, wl, S, device, window)
        ref_s = time.perf_counter() - t
        rows = {}
        if mode == "control":
            ctl, ctl_target, _ = grad.reference_steps(cfg, wl, S, device,
                                                      window, torch.bfloat16)
            rows["control"] = (ctl, ctl_target)
        else:
            fit = grad.Fit(cfg, wl, device, window, S)
            tgt = (fit.target.cpu().numpy(), fit.target_alpha)
            if mode == "program":
                rows["program"] = (fit.first_steps(), tgt)
            else:
                first = fit.first_steps()
                rows["noop"] = (dict(first, change={
                    k: np.zeros_like(v) for k, v in first["change"].items()}),
                    tgt)
                for name in ("half", "loss"):
                    f = grad.Fit(cfg, wl, device, window, S)
                    if name == "half":
                        f.px, f.py, f.s = f.px[::2], f.py[::2], f.s[::2]
                    else:
                        fwd = f.forward
                        f.forward = lambda fwd=fwd: 1.01 * fwd()
                    rows[name] = (f.first_steps(), tgt)
        for name, (got, tgt) in rows.items():
            nums = compare.grad_numbers(got, ref)
            nums["target_off"] = frames.numbers([tgt], [ref_target],
                                                window)["off_share"]
            out.append(dict(seed=seed, reading=name, ref_s=ref_s, **nums))
            print(json.dumps(out[-1]), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", choices=("program", "control", "faults"),
                    required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, registry.ROOT)
    wl = registry.workload(args.workload)
    cfg = registry.config(wl["config"])
    seeds_list = [int(s) for s in args.seeds.split(",")]
    t = time.perf_counter()
    fn = grad_readings if wl["kind"] == "grad" else frame_readings
    fn(cfg, wl, seeds_list, args.mode, "cuda")
    print(f"# {args.workload} {args.mode}: {time.perf_counter() - t:.1f} s",
          file=sys.stderr)


if __name__ == "__main__":
    main()
