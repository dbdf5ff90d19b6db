#!/usr/bin/env python3
"""Reference images for chip_smoke.py's phase 36, from tpuprt on the CPU.

    JAX_PLATFORMS=cpu python3 tools/volume_refs.py [fog] [smoke] [single]
        [--res 64] [--spp 4] [--integrator emission] [--dir DIR]

Renders, with the JAX package's scan driver on the CPU, and writes as half
EXRs under scenes/:

- fog -> scenes/config4_fog.exr: config4_big with a homogeneous Volume
  box over the terrain (chip_smoke.fog_text), directlighting "all";
- smoke -> scenes/bench3_smoke.exr: bench3's box with a 32^3 volumegrid
  of chip_smoke.smoke_grid's density (chip_smoke.smoke_text), path mode,
  depth 5;

both at res x res x spp with the VolumeIntegrator `integrator`, by
default chip_smoke.VOL_REF_INTEGRATOR ("emission", about 1.5 min for
both: a jit of tpuprt's "single" render_chunk did not finish on the CPU);
- single -> scenes/single_box.exr: chip_smoke.single_text's scene of its
  own (14 triangles under Accelerator "none", a homogeneous region and a
  4^3 volumegrid, a point and a disk area light, VolumeIntegrator
  "single") at its own 16x16 x 1 spp, rendered eagerly (under
  jax.disable_jit) since a jit of "single" does not finish; --res, --spp
  and --integrator do not apply to it.
The scene text, seed and sampler are the card's: chip_smoke.py renders
the same text at the EXR's size and holds it to the image
(chip_smoke.VOL_REF_REL, VOL_REF_MEAN). The driver is the scan ("scan"),
in chunks of CHUNK lanes to bound host memory; the image does not depend
on either (counter-based samples). Prints one JSON line per image: its
shape, the seconds and the file written.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import chip_smoke  # noqa: E402
from tpuprt import render as R  # noqa: E402
from tpuprt.io.exr import write_exr  # noqa: E402
from tpuprt.scene.parser import load_scene_string  # noqa: E402

CHUNK = 1 << 12
OUT = {"fog": chip_smoke.FOG_EXR, "smoke": chip_smoke.SMOKE_EXR,
       "single": chip_smoke.SINGLE_EXR}


def render_to(name, text, out, eager=False):
    scene, opts = load_scene_string(text)
    t0 = time.perf_counter()
    with jax.disable_jit(eager):
        rgb, alpha = R.render(scene, opts._replace(chunk_size=CHUNK,
                                                   driver="scan"))
    secs = time.perf_counter() - t0
    write_exr(out, rgb, alpha)
    print(json.dumps(dict(image=name, shape=list(rgb.shape),
                          spp=opts.sampler.pixelsamples,
                          volume_integrator=opts.volume_integrator,
                          seconds=secs,
                          file=os.path.relpath(out, ROOT))),
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("which", nargs="*", default=["fog", "smoke"])
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--integrator", default=chip_smoke.VOL_REF_INTEGRATOR)
    ap.add_argument("--dir", help="write the images here instead of "
                    "scenes/")
    args = ap.parse_args(argv)
    for name in args.which:
        out = os.path.join(args.dir, os.path.basename(OUT[name])) \
            if args.dir else OUT[name]
        if name == "single":
            render_to(name, chip_smoke.single_text(), out, eager=True)
            continue
        src, text_of = {"fog": (chip_smoke.SCENE, chip_smoke.fog_text),
                        "smoke": (chip_smoke.BENCH3,
                                  chip_smoke.smoke_text)}[name]
        with open(src) as f:
            render_to(name, text_of(f.read(), args.res, args.spp,
                                    args.integrator), out)


if __name__ == "__main__":
    main()
