#!/usr/bin/env python3
"""Reference images for chip_smoke.py's phases 34-35, from tpuprt on the CPU.

    JAX_PLATFORMS=cpu python3 tools/shading_refs.py [materials] [thinlens]

Renders, with the JAX package's render() on the CPU, and writes as half
EXRs under scenes/:

- materials -> scenes/bench3_materials.exr: bench3's Cornell box with
  every wall and sphere in another material and no PixelFilter line
  (chip_smoke.materials_text: pbrt-v1's default Mitchell 2x2), path mode,
  depth 5, at the file's 256x256 x 32 spp (about 1.5 min on 8 CPU cores);
- thinlens -> scenes/config4_thinlens.exr: config4_big through a thin lens
  with the triangle filter (chip_smoke.cameras_text "thinlens"),
  directlighting, at the file's 512x512 x 4 spp (about 2 min).

The scene text, seed and sampler are the card's: chip_smoke.py renders
the same text at the EXR's size and holds it to the image by
test_golden._compare's measures (chip_smoke.band). Prints one JSON line per
image: its shape, the render's seconds and the file written. The pool runs
in chunks of CHUNK lanes to bound host memory; the image does not depend on
it (counter-based samples).
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

CHUNK = 1 << 14
OUT = {"materials": chip_smoke.MATERIALS_EXR,
       "thinlens": chip_smoke.THINLENS_EXR}


def render_to(name, text):
    scene, opts = load_scene_string(text)
    t0 = time.perf_counter()
    rgb, alpha = R.render(scene, opts._replace(chunk_size=CHUNK))
    secs = time.perf_counter() - t0
    write_exr(OUT[name], rgb, alpha)
    print(json.dumps(dict(image=name, shape=list(rgb.shape),
                          spp=opts.sampler.pixelsamples, seconds=secs,
                          file=os.path.relpath(OUT[name], ROOT))),
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("which", nargs="*", default=["materials", "thinlens"])
    args = ap.parse_args(argv)
    if "materials" in args.which:
        with open(chip_smoke.BENCH3) as f:
            render_to("materials", chip_smoke.materials_text(f.read()))
    if "thinlens" in args.which:
        with open(chip_smoke.SCENE) as f:
            render_to("thinlens", chip_smoke.cameras_text(f.read(),
                                                          "thinlens"))


if __name__ == "__main__":
    main()
