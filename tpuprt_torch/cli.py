"""Command-line renderer: parse a pbrt-v1 scene, render it on the card,
write the EXR (the port's counterpart of pbrt.py, which needs JAX).

    python -m tpuprt_torch scene.pbrt [-o out.exr] [--integrator NAME]
        [--spp N] [--resume] [--checkpoint] [--quiet] [--device cuda|cpu]

The reference's main() (renderer/pbrt.cpp:28-51): parse, render with a
progress bar, write the EXR with half pixels, then print the stats table
(printed at WorldEnd in the reference, core/api.cpp:479). It renders on
the card unless --device cpu asks for the plain versions; without a CUDA
device it raises, as render() does. --checkpoint writes
<outfile>.ckpt.npz at each writefrequency and --resume starts from it; the
file is removed once the render is done.
"""
from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpuprt_torch",
        description="Render a pbrt-v1 scene file to an EXR.")
    ap.add_argument("scene", help=".pbrt scene file")
    ap.add_argument("-o", "--outfile", default=None,
                    help="output EXR (default: the Film's filename)")
    ap.add_argument("--integrator", default=None,
                    help="override the scene's surface integrator")
    ap.add_argument("--spp", type=int, default=None,
                    help="override samples per pixel")
    ap.add_argument("--resume", action="store_true",
                    help="resume from <outfile>.ckpt.npz if present")
    ap.add_argument("--checkpoint", action="store_true",
                    help="write a resume checkpoint at each writefrequency")
    ap.add_argument("--quiet", action="store_true",
                    help="no progress bar and no stats table")
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (the default) or "cpu"')
    args = ap.parse_args(argv)

    from . import render as R
    from .io.exr import write_exr
    from .scene.parser import load_scene
    from .utils.stats import StatsRegistry

    R.require_device("python -m tpuprt_torch", args.device)
    scene, opts = load_scene(args.scene)
    # The EXR holds half pixels (the reference's core/exrio.cpp), so the
    # film is read back at f16 on the device.
    opts = opts._replace(half_readback=True)
    if args.outfile:
        opts = opts._replace(filename=args.outfile)
    if args.integrator:
        opts = opts._replace(integrator=args.integrator)
    if args.spp:
        # Only the count changes; the scene's sampler keeps its kind. A
        # stratified sampler takes it as a near-square xsamples x ysamples.
        if opts.sampler.kind == "stratified":
            xs = max(1, int(args.spp ** 0.5))
            ys = max(1, (args.spp + xs - 1) // xs)
            opts = opts._replace(sampler=opts.sampler._replace(
                xsamples=xs, ysamples=ys))
        else:
            opts = opts._replace(sampler=opts.sampler._replace(
                pixelsamples=args.spp))
    ckpt = opts.filename + ".ckpt.npz" if (args.checkpoint or args.resume) \
        else None
    stats = StatsRegistry()
    rgb, alpha = R.render(scene, opts, device=args.device, stats=stats,
                          checkpoint_path=ckpt, resume=args.resume,
                          progress=not args.quiet)
    write_exr(opts.filename, rgb, alpha)
    if not args.quiet:
        stats.print()
        print(f"Wrote {opts.filename}")
    if ckpt and os.path.exists(ckpt):
        os.remove(ckpt)       # the render is done; the checkpoint is stale
    return 0


if __name__ == "__main__":
    sys.exit(main())
