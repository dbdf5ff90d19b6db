#!/usr/bin/env python3
"""The bands chip_smoke.py holds its light phases to, from tpuprt on the CPU.

    JAX_PLATFORMS=cpu python3 tools/light_bands.py [env|bench3 ...]

Renders, with the JAX package's render() on the CPU, the two pairs of
images that estimate the same image and prints, as one JSON line each,
test_golden._compare's measures between them (chip_smoke.band: the blurred
relative error on lit regions and the relative difference of the means):

- env: config4_big lit by chip_smoke's sky map alone (write_lit_maps,
  MAP_SEED), under "infinitesample" and under "infinite", at
  ENV_RES^2 x ENV_SPP (chip_smoke.lit_text);
- bench3: scenes/bench3.pbrt against bench3 with its disk light as a
  48-triangle fan and Accelerator "none" (chip_smoke.meshlight_text), at
  the file's 256x256 x 32 spp.

chip_smoke.py's limits are twice these numbers (ENV_BAND_*, MESH3_BAND_*).
The maps go to a temporary directory. Minutes on a few CPU cores.
"""
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import chip_smoke  # noqa: E402
from tpuprt import render as R  # noqa: E402
from tpuprt.scene.parser import load_scene  # noqa: E402


def render_file(path):
    scene, opts = load_scene(path)
    t0 = time.perf_counter()
    rgb, _ = R.render(scene, opts)
    return rgb, time.perf_counter() - t0


def pair(name, texts, d):
    imgs, secs = [], []
    for i, text in enumerate(texts):
        path = os.path.join(d, f"{name}{i}.pbrt")
        with open(path, "w") as f:
            f.write(text)
        rgb, s = render_file(path)
        imgs.append(rgb)
        secs.append(s)
    rel, mean = chip_smoke.band(imgs[0], imgs[1])
    print(json.dumps(dict(pair=name, band_rel=rel, band_mean=mean,
                          shape=list(imgs[0].shape), seconds=secs)),
          flush=True)


def main(which):
    with tempfile.TemporaryDirectory() as d:
        if "env" in which:
            chip_smoke.write_lit_maps(d)
            with open(chip_smoke.SCENE) as f:
                base = f.read()
            pair("env", [chip_smoke.lit_text(base, k) for k in
                         ("infinite", "infinitesample")], d)
        if "bench3" in which:
            with open(chip_smoke.BENCH3) as f:
                b3 = f.read()
            pair("bench3", [chip_smoke.meshlight_text(b3), b3], d)


if __name__ == "__main__":
    main(sys.argv[1:] or ["env", "bench3"])
