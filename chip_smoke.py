#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``tpuprt_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--exr PATH] [--profile]
    python3 chip_smoke.py --old DIR [--new-first]

Phases, one JSON line each; any failure raises and exits nonzero:

1. build   -- compile ``tpuprt_torch/ops/csrc/bvh_tiles.cu``,
   ``bvh_rows.cu`` and ``mt_best.cu`` with nvcc, all three at once.
2. parity  -- config4_big (100K triangles, NN <= 22000 rows): its
   512x512x4 camera rays and 256K random rays, nearest and any-hit, through
   the tile walk and the row walk and through their plain torch versions
   on the card.
3. parity  -- the 1M-triangle terrain (NN > 22000, the contract of the
   TPU's chunked walks), 64K random rays, both kernels, both modes; and
   the row walk on a hand-built tree 40 levels deep (deep_tree), deeper
   than the tile walk takes and than the row walk's stack keeps in local
   memory (its scratch path), both modes; told a depth of 1, the row walk
   must fail (understated_depth). The tile and row walks must equal their
   plain versions bit for bit (t and ids) in both modes.
4. render  -- config4_big at full size through load_scene -> render ->
   write_exr on the card (the tile walk); the kernel's launch count must be
   > 0, the image finite and inside a band around scenes/bench4.exr.
5. render  -- the same scene with its BVH in row format only (the state a
   tree too deep for the tile walk leaves it in): the row walk's launch
   count must be > 0, the image inside the same band.
6. parity  -- the rocks scene (config4_big + 1000 ObjectInstances of a
   1280-triangle rock): its camera rays and 256K random rays, in lane
   order as the front end hands them over, through the instanced walk
   (top-level BVH over the entries) and its plain version (entries in
   order), both modes; and
   a tie set, the rocks with every 10th instance repeated after the others
   (same prototype, same transform), where the earliest entry must win:
   ids, instances and t per ray.
7. render  -- the rocks scene through load_scene_string -> render ->
   write_exr: the tile and instanced walks' launch counts must be > 0, the
   image finite and, against the same rocks duplicated into the main mesh
   (1.38M triangles), inside test_instances' band.
8. parity  -- the brute-force kernel (mt_best) against its plain version:
   config2 with Accelerator "none" (1,282 triangles), its 128x128x32
   camera rays and 256K random rays, both modes; every 8th of config4_big's
   camera rays (128K) against all its 99,458 triangles; an adversarial set
   at the edges of the kernel's staged rejects (adversarial_mt_set), all
   triangles at once in both modes and one launch per triangle (every
   pair's own result).
9. render  -- config2 with Accelerator "none" through load_scene_string ->
   render -> write_exr: mt_best's launch count must be > 0, the image
   finite and inside test_golden's band around scenes/golden2.exr.
10. render -- config4_big without an accelerator (every camera and shadow
   ray against every triangle): mt_best launched, its shadow calls in
   any-hit mode, the image inside the band of phase 4. Then the render's
   real shadow batch (393K rays) through mt_best in any-hit mode against
   the plain version.
11. parity -- mt_best on bench3 (scenes/bench3.pbrt: 10 triangles, a disk
   light, a glass and a mirror sphere): its 256x256x32 camera rays, and the
   NEE shadow batch (any hit) and the MIS BSDF-strategy batch (nearest) of
   the render's pass with the most live shadow rays, bit for bit against
   the plain version.
12. render -- config3 (the same Cornell box at 96x96) at 64 spp through
   load_scene -> render -> write_exr in path mode: mt_best launched in both
   modes, the image finite and inside test_golden's band around
   scenes/golden3.exr.
13. render -- bench3 at its full size (256x256 x 32 spp, path mode, depth
   5) with bench.py's pool: mt_best launched in both modes, the image
   finite; its walls and rays/s by bench.py's convention.
14. render -- config1 as its file asks (128x128, Whitted, stratified 2x2,
   a point light, one matte sphere: no kernel, the sphere by plain torch)
   inside test_golden's band around scenes/golden1.exr.
15. walk, render -- config2 as its file asks (Accelerator "grid", 128x128
   x 32 spp): the plain grid walk timed on 2^17 of its camera rays (wall
   on the card, DDA steps, pairs tested), then the render inside golden2's
   band.
16. walk, render -- config4 as its file asks (Accelerator "kdtree",
   128x128 x 16 spp): the plain kd-restart walk timed on 2^17 camera rays,
   nearest and any-hit, then the render inside golden4's band.
17. render -- config5_huge, bench.py's 1M-triangle terrain (the scene of
   phase 3) at 512x512 x 4 spp with bench.py's options, through the tile
   walk: launched, the image finite; its load seconds, walls, rays/s by
   bench.py's convention and the peak device memory of the render.
18. parity -- mt_best on bench6 (scenes/bench6.pbrt: photonmap, 10
   triangles, a disk light, a mirror sphere): the first shooting batch's
   65,536 photon rays at depth 0 and at depth 2 (nearest), and from a
   render with the maps built its biggest final-gather block (nearest)
   and NEE shadow batch (any hit), bit for bit against the plain version.
19. photons -- bench6's photon maps built on the card: batches, paths
   shot, per map the photons kept and stored, n_paths, the batch that
   filled it, buckets and bucket cap; seconds of shooting, host
   collection and the grids' build.
20. render -- config6 as its file asks (64x64 x 4 spp, photonmap, final
   gather of 8): mt_best launched in both modes, the image inside
   test_golden's band around scenes/golden6.exr.
21. render -- bench6 (final gather of 16) and bench6ng (none) at their
   full size (256x256 x 4 spp) as bench.py's bench_config6 times them:
   load -> photon shooting and map build -> render in one wall, the first
   run the main path's, then the best of 2; the image finite, samples/s,
   the wall against pbrt-v1's 80.0 s, mt_best's launches by mode, the
   peak device memory, and as information the band against
   scenes/bench6.exr and bench6ng.exr.
22. walk, render -- config2 with Accelerator "bvh" (a BVH holding its
   disk: rows only, walked by the plain skip-link walk): the walk timed on
   2^17 camera rays, nearest and any-hit, then the render inside golden2's
   band.
23. parity -- mt_best on the chunked driver's paths (configs 7-10: the
   bench6 Cornell box, 12 prims, so every ray goes through it), each set
   captured from a render at test_golden's settings: config8's largest
   shadow block of the virtual lights (igi, any hit), config10's
   connection batch (bidirectional, any hit), config7's largest
   final-gather ray set (exphotonmap, nearest) and config9's largest
   estimate block (irradiance cache, nearest), bit for bit.
24. render -- configs 7 (exphotonmap), 8 (igi, 16 spp), 9 (irradiance
   cache, 16 spp) and 10 (bidirectional) at 64x64 through
   load_scene_string -> render -> write_exr, inside the bands of
   tests/test_golden.py:93-117: mt_best launched in both modes, its
   launches by mode, the preprocess's seconds (the maps and radiance
   photons, the virtual lights, the probe cache).
25. render -- the same four at bench6's film (256x256, each file's spp) as
   bench_config6 times bench6 (load -> preprocess -> render in one wall,
   the first run the main path's, then the best of 2): samples/s, the
   peak device memory, the image finite.
26. render -- every light and texture (light_phases): config4_big lit by
   an infinitesample sky (2048x1024 map), a spot, a projection (512^2
   slide) and a goniometric light (256x128 map) and a 512-triangle
   emissive patch, its terrain's Kd a mix of a 2048^2 EWA imagemap and a
   colour by an fbm, bump-mapped by a scale of wrinkled (lit_text), its
   maps made from MAP_SEED and written beside the scene text, which names
   them relative to itself: load_scene -> render -> write_exr at 512x512
   x 4 spp through the tile walk, launched, finite; the wall best of 2,
   the peak device memory. The tile walk vs its plain version on its
   camera rays and on the render's largest call (a pass's fused shadow
   and BSDF-strategy rays, all nearest), bit for bit. The same
   scene at 32x32 x 1 spp rendered on the CPU and on the card (the
   shading layer on two devices: the light kinds' maps, the EWA gathers,
   fbm, wrinkled, bump), 99.5% of pixels within atol = rtol = 1e-4 and
   alpha equal. Then the sky alone on the checkerboard under "infinite"
   and under "infinitesample" at 128x128 x 64 spp, held to each other
   inside twice tpuprt's band between the same two renders.
27. render -- bench3 with its disk light as a 48-triangle fan of the same
   radius and L and Accelerator "none" (meshlight_text; 60 prims, every
   ray through mt_best), 256x256 x 32 spp in path mode: both modes
   launched, held to phase 13's bench3 inside twice tpuprt's band. Then
   mt_best vs its plain version, bit for bit, on its camera rays and on
   one pass's shadow (any hit) and BSDF-strategy (nearest) batches.
28. photons, render -- bench6 with the same fan: its photon maps built on
   the card (counts beside phase 19's), then load -> maps -> render at
   256x256 x 4 spp as bench_config6 times bench6: photon emission from
   triangles through mt_best, the image finite, the wall.
29. scan -- the chunked scan driver on the card (driver "scan") against
   the pool (driver "wavefront"), both read back in f32, per pixel within
   atol = rtol = 2e-4 (alpha 1e-5; tests/test_wavefront.py's tolerance):
   config4_big at 512x512 x 4 spp through the tile walk with
   directlighting's strategies "all", "one" and "weighted" (each one's
   band against bench4.exr as information), bench3 at 256x256 x 32 spp in
   path mode through mt_best in both modes. Then config4_big through the
   scan in 8 chunks with a writefrequency of 4 chunks and a checkpoint,
   resumed from the checkpoint: equal to the straight render within 1e-5.
   Walls, chunks, launches by kernel, peak device memory.
30. grad -- render_loss_fn of config4_big over its 512x512 film at 1 spp
   (262,144 samples in one batch; the target the scan render at the
   file's values) in the checkerboard's two colours, the distant light's
   L and a translation of each terrain vertex, at Adam's start (colours at
   half): gradients through the tile walk and through its plain version
   on the card within rtol 1e-4 (of each tensor's largest), autograd
   against a central difference (eps 1e-2, the per-sample losses summed
   in float64) of the first colour channel and of L within 2%, every
   gradient finite, the vertices' nonzero; 10 steps of torch.optim.Adam
   (lr 0.05) over the colours halve the loss. Seconds a step, peak device
   memory, launches a step.
31. grad -- the same on bench3 over 256x256 at 1 spp (path mode, depth 5,
   mt_best in both modes) in the red wall's Kd (bench3.pbrt:24), from
   [0.3 0.3 0.3]: mt_best against its plain version's route within rtol
   1e-4, autograd against a central difference (eps 1e-3) within 5%, 10
   Adam steps halve the loss.
32. boundary -- render_loss_with_silhouette (diff/silhouette.py) on the
   card: tests/test_grad.py's four finite-difference scenes at 256x256
   (a black quad before an infinite light: the primary term; a quad out
   of frame shadowing a floor from a point light and from a quad area
   light; a black sphere's rim) and a fifth, the floor shadowed from a
   distant light (the shadow term's distant branch), each gradient in
   the translation within that test's tolerance of the central
   difference (10%, 10%, 25%, 10%; the point light's 10% for the
   distant one) and of its sign, the case's term with live edge samples,
   mt_best launched (the sphere's scene has no triangle). Then
   grad/config4_big at 512x512 x 1 spp in a per-vertex translation with
   the boundary terms over the terrain's 149,633 edges and without:
   seconds a step, peak device memory, launches a step by mode, live
   edge samples a step by term (the primary term's required; the
   distant light's shadow term has none there: no terrain face turns
   from the sun, and the border edges' casts leave the terrain); the
   value unchanged; the boundary gradient through the tile walk and
   through its plain version within rtol 1e-4.
33. shard -- render_sharded of config4_big at 512x512 x 4 spp over a
   world of 1 (multihost.init_distributed, NCCL) against render_chunked,
   and from a world of 2 processes sharing the card (gloo, spawned here)
   against the world of 1, within 1e-5; train_step_sharded with the
   boundary terms on the point-light shadow scene at 256x256, 2 ranks
   against 1 within 1e-5 relative (loss and vertex gradient). Walls,
   first and warm, of both worlds.
34. render -- every material (shading_phases): bench3 with its walls and
   spheres in substrate, primer, felt, bluepaint, uber at opacity 0.6,
   translucent and shinymetal and no PixelFilter line (materials_text:
   pbrt-v1's default Mitchell 2x2), 256x256 x 32 spp, path, depth 5,
   bench.py's pool: mt_best launched in both modes, finite, walls,
   samples/s, peak device memory; mt_best bit-equal on the BSDF-strategy
   batch of the pass with the most live ones and on the shadow batch of
   the pass with the most live shadow rays; the scene at the size of
   scenes/bench3_materials.exr (tpuprt's, tools/shading_refs.py),
   written with write_exr, inside golden3's limits of it.
35. render -- every camera and pixel filter: config4_big at 512x512 x 4
   spp through the tile walk with its box filter and as cameras_text
   makes it: "mitchell" (a pinhole, no PixelFilter), "thinlens" (lens
   radius 0.06 focused at 2.6, triangle), "ortho" (orthographic, gaussian,
   a substrate terrain) and "env" (environment camera, sinc 4x4): each
   launched and finite, walls and peak device memory; the film splat
   alone, 2^17 samples a call, by filter (phase "splat": device and host
   ms); then "thinlens" at the size of scenes/config4_thinlens.exr inside
   phase 4's band of it.
36. render -- volumes (volume_phases): config4_big/fog (fog_text: a
   homogeneous box over the terrain, VolumeIntegrator "single") at
   512x512 x 4 spp, directlighting, through the tile walk, and
   bench3/smoke (smoke_text: a 32^3 volumegrid of seeded puffs, "single")
   at 256x256 x 32 spp in path mode through mt_best: walls first and warm,
   peak device memory, launches; the pool against the scan driver per
   pixel (SCAN_TOL); the kernel bit-equal on every k-th ray of the scan's
   largest any-hit call (the single-scattering march's shadow rays); each
   at the size of its reference (scenes/config4_fog.exr,
   bench3_smoke.exr: tpuprt's, tools/volume_refs.py, emission only) within
   VOL_REF_REL, VOL_REF_MEAN; single_box (single_text: a small scene of
   its own under Accelerator "none", VolumeIntegrator "single") at
   16x16 x 1 spp through mt_best, within the same limits of
   scenes/single_box.exr (tpuprt's "single", rendered eagerly).
   bench6/fog (bench6 in a thin homogeneous
   box: photonmap over volumes takes the chunked driver): load -> maps ->
   render, first and warm, finite, peak memory, mt_best's launches.
37. render -- the rest of instancing (instancing_phases): rocks/loop, the
   rocks with the rock a loopsubdiv (loop_rock: 3 levels, 1280
   triangles), its prototype bit-equal to the port's tessellation written
   inline and the images within LOOP_REL; rocks/lamps, the rocks and 48
   instanced quad lamps (lamps_text, every 8th mirrored), directlighting
   "one", beside the same lamps inline (LAMP_DIFF, LAMP_MAX), the
   instanced walk bit-equal on every k-th ray of its largest call.
38. operability -- config4_big written as pbrt-v1 users split a scene
   (split_scene_files: SearchPath, Include nested and relative,
   CoordinateSystem/CoordSysTransform, Identity, a MakeNamedMaterial
   line and an unused parameter) rendered by ``python -m tpuprt_torch``'s
   main() in this process: bvh_tiles launched, the EXR inside phase 4's
   band of bench4.exr and equal to the library path's render up to the
   splat's order, two warnings, the samples taken in its stats table;
   then once more as ``python3 -m tpuprt_torch`` in a child process (no
   JAX on the machine); walls beside phase 4's. Then the imaging
   pipeline (maxwhite, gamma 2.2, bloom 0.2) on that image on the card
   and on the CPU, their largest difference.

Each parity line carries the kernel's and the plain version's times, the
wrapper's host time per call (host_ms), and the kernel's bound (the least time the card could take: the bytes it must
move over the memory rate, or the ray-box, ray-triangle and transform
operations these rays need, counted by the plain version, over the f32
rate; for the instanced walk, only the entries a ray's final window meets;
for mt_best, each pair priced by the stage of its staged rejects that
settles it, and in any-hit mode only the pairs up to a ray's first hit),
and the floor that -fmad=false sets (the same operations, one instruction
each, at 128 lanes a clock on each SM). Then the card's name and power
limit, the kernel table, and as the last line ``{"ok": true, "device":
{...}}``. Without a CUDA device it exits nonzero and prints no result.
``--exr PATH`` also keeps config4_big's image; ``--profile`` profiles one
more render of config4_big, of the rocks scene, of config2/none, of
config1, config2/grid, config4/kdtree and config5_huge (phase "profile";
for the brute-force scenes mt_best's device ms by mode), and
profiles config2/none, config4_big without an accelerator and bench3
with their visibility segments dispatched as the port does (split) and
fused into one launch a bounce as it did before it followed tpuprt's
dispatch (phase "dispatch": config2/none in the turns split, fused,
fused, split, the others split, fused), and profiles bench6 (its photon
shooting included) with the device time of the photon lookups (lphoton),
of photon_radiance and of build_maps (ranges_ms), and times the lookup of
a final-gather block's hit points with whole-row gathers and with the
shipped column takes (phase "lookup": rows, cols, cols, rows), and
profiles configs 7-10 at 256x256 and config4_big/lit (device busy and
idle shares, the top device ops).

``--old DIR`` runs no smoke phase: it times the earlier ``bvh_tiles.cu``
and ``bvh_rows.cu`` of commit 2a258fc (the skip-link walks), copied into
DIR (``git show 2a258fc:tpuprt_torch/ops/csrc/bvh_tiles.cu``), against the
checkout's, in one process (ab_main), in the turns old, new, new, old
(``--new-first``: new, old, old, new). It refuses a source whose C
interface is not theirs (OLD_INTERFACES).
"""
import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
SCENE = os.path.join(ROOT, "scenes", "config4_big.pbrt")
GOLDEN = os.path.join(ROOT, "scenes", "bench4.exr")
CONFIG2 = os.path.join(ROOT, "scenes", "config2.pbrt")
GOLDEN2 = os.path.join(ROOT, "scenes", "golden2.exr")
CONFIG3 = os.path.join(ROOT, "scenes", "config3.pbrt")
GOLDEN3 = os.path.join(ROOT, "scenes", "golden3.exr")
BENCH3 = os.path.join(ROOT, "scenes", "bench3.pbrt")
CONFIG1 = os.path.join(ROOT, "scenes", "config1.pbrt")
GOLDEN1 = os.path.join(ROOT, "scenes", "golden1.exr")
CONFIG4 = os.path.join(ROOT, "scenes", "config4.pbrt")
GOLDEN4 = os.path.join(ROOT, "scenes", "golden4.exr")
CONFIG6 = os.path.join(ROOT, "scenes", "config6.pbrt")
GOLDEN6 = os.path.join(ROOT, "scenes", "golden6.exr")
BENCH6 = os.path.join(ROOT, "scenes", "bench6.pbrt")
BENCH6NG = os.path.join(ROOT, "scenes", "bench6ng.pbrt")
# Phases 34-35's references, written by tpuprt on the CPU
# (tools/shading_refs.py); each is rendered again at its own size.
MATERIALS_EXR = os.path.join(ROOT, "scenes", "bench3_materials.exr")
THINLENS_EXR = os.path.join(ROOT, "scenes", "config4_thinlens.exr")

# bench.py's rays/s convention for config4_big: camera + shadow rays of the
# reference pbrt-v1 run (bench.py CONFIG4_REF_RAYS).
CONFIG4_REF_RAYS = 1.05e6 + 0.387e6
# Band around bench4.exr, in test_golden._compare's measures: twice what
# tpuprt.render(config4_big) on the CPU shows against the same file
# (blurred relative error 0.008569, relative mean difference 0.000317).
BAND_REL = 2 * 0.008569
BAND_MEAN = 2 * 0.000317
# config2 against golden2.exr: the limits tests/test_golden.py holds
# tpuprt.render to (test_golden2_grid_mesh_arealight).
BAND2_REL, BAND2_MEAN = 0.04, 0.015
# config3 at 64 spp against golden3.exr: test_golden3_path_cornell's
# sample count and limits.
CONFIG3_SPP, BAND3_REL, BAND3_MEAN = 64, 0.10, 0.03
# bench.py's rays/s convention for bench3: camera + shadow rays of the
# reference pbrt-v1 run (bench.py CONFIG3_REF_RAYS).
BENCH3_REF_RAYS = 2.114e6 + 3.363e6
# The same for config5_huge (bench.py CONFIG5_REF_RAYS).
CONFIG5_REF_RAYS = 1.053e6 + 0.387e6
# config1 and config4 against golden1.exr and golden4.exr: the limits
# tests/test_golden.py holds tpuprt.render to.
BAND1_REL, BAND1_MEAN = 0.025, 0.015
BAND4_REL, BAND4_MEAN = 0.02, 0.01
# config6 against golden6.exr: test_golden6_photonmap's limits.
BAND6_REL, BAND6_MEAN = 0.10, 0.05
# pbrt-v1's wall for bench6 on the CPU of the JAX package's image, single
# thread, shooting included (bench.py PBRT_BENCH6_WALL).
PBRT_BENCH6_WALL = 80.0
# Configs 7-10 (the GI integrators of the chunked driver): the spp and the
# limits (blurred rel, mean) tests/test_golden.py:93-117 hold tpuprt to;
# None: the file's spp. GI_RES: the film of the full-size phase, bench6's.
GI_GOLDEN = {"config7": (None, 0.10, 0.05), "config8": (16, 0.15, 0.05),
             "config9": (16, 0.10, 0.04), "config10": (None, 0.12, 0.04)}
GI_RES = 256
# The plain grid and kd-tree walks are timed on this many camera rays,
# one pool's worth (bench.py's 2^17 lanes).
WALK_RAYS = 1 << 17
MT_CONFIG4_RAYS = 1 << 17  # config4_big camera rays held against mt_best
T_RTOL = 1e-6             # kernel vs plain: t agreement (relative)
# timed(): the spin before each timed call, about 8 ms at the H100's clock,
# longer than a wrapper's host cost (Python and ctypes, up to ~1 ms).
HOLD_CYCLES = 1 << 24
SCALE_TERRAIN_N = 708     # bench.py's 1M-triangle terrain grid
N_ROCKS, ROCK_SUBDIV, ROCK_SEED = 1000, 3, 1
# Instanced vs duplicated rocks: tests/test_instances.py's tolerance
# (atol = rtol = 2e-3) on at least this share of pixels, and at most this
# relative difference of the image means.
DUP_CLOSE, DUP_SHARE, DUP_MEAN = 2e-3, 0.995, 1e-3

# The bound. Published H100 SXM peaks (NVIDIA's H100 datasheet): HBM
# 3.35 TB/s, f32 outside the tensor cores 67 TFLOP/s (a fused multiply-add
# counted as two). Operations per test, as the kernels compute them: a slab
# test (of a node's or an instance entry's box) is 6 sub + 6 mul, 12
# min/max, the window clip (min, mul) and a compare; a Moller-Trumbore test
# 56 (the tile walk's edges come precomputed) or 62 (the row walk forms
# them); mt_best's pairs by the stage that settles them (mt_best.cu): 24
# operations up to b1's sign test, 39 up to b2's, 45 up to t's, 56 through
# the full test; a ray moved into an instance's object space 45 (two 3x4
# transforms and three safe reciprocals). Bytes of a row-format node: the
# 88 of its 128 columns the walks read (box, skip, nprims, 8 triangles, 8
# ids). Built with -fmad=false, every operation is its own instruction:
# the floor at 128 f32 lanes a clock on each SM is twice the bound.
HBM_BPS, F32_FLOPS = 3.35e12, 67e12
SLAB_OPS, XFORM_OPS = 27, 45
ROW_BYTES = 88 * 4
DEEP_LEVELS = 40          # the hand-built deep tree (deep_tree)
TRI_OPS = {"bvh_tiles": 56, "bvh_rows": 62, "bvh_instanced": 62}
MT_STAGE_OPS = {"b1": 24, "b2": 39, "t": 45, "full": 56}
# Instanced tie set: every DUP_EVERY-th rock repeated after the others.
DUP_EVERY = 10
REPLACES = {"bvh_tiles": "tpuprt/ops/bvh_pallas.py:860",
            "bvh_rows": "tpuprt/ops/bvh_pallas.py:457",
            "bvh_instanced": "tpuprt/ops/bvh_pallas.py:1182",
            "mt_best": "tpuprt/ops/mt_pallas.py:111"}
ALSO_REPLACES = {"bvh_tiles": "tpuprt/ops/bvh_pallas.py:1010",
                 "bvh_rows": "tpuprt/ops/bvh_pallas.py:558"}


# Phases 26-28, the lights and textures. The image maps are made from
# MAP_SEED with numpy and written with the port's write_exr beside the
# scene text, which names them relative to itself (write_lit_maps).
MAP_SEED = 11
LIT_SIDE = 2048            # the terrain's imagemap, 2048 x 2048
SKY_HW = (1024, 2048)      # the environment map: rows theta, columns phi
SLIDE_SIDE = 512           # the projection light's slide
GONIO_HW = (128, 256)      # the goniometric light's map
PATCH_QUADS = 16           # the emissive patch: 16 x 16 quads, 512 triangles
FAN_TRIS = 48              # bench3's disk light as a fan of 48 triangles
ENV_RES, ENV_SPP = 128, 64
# config4_big/lit rendered on the CPU and on the card (phase 26): the film,
# and the share of pixels within atol = rtol = 1e-4 of each other, as
# tests/test_torch_lights.py holds the port to tpuprt per sample.
DEV_RES, DEV_SHARE, DEV_TOL = 32, 0.995, 1e-4
# The bands between renders that estimate the same image, in
# test_golden._compare's measures: twice what tpuprt gives between the
# same two renders on the CPU (tools/light_bands.py):
# - config4_big lit by the environment map alone, "infinite" against
#   "infinitesample", 128x128 x 64 spp: blurred rel 0.008308, mean
#   0.000547;
# - bench3/meshlight against bench3, 256x256 x 32 spp: blurred rel
#   0.012414, mean 0.002823 (the fan's area is 0.29% below the disk's).
ENV_BAND_REL, ENV_BAND_MEAN = 2 * 0.008308, 2 * 0.000547
MESH3_BAND_REL, MESH3_BAND_MEAN = 2 * 0.012414, 2 * 0.002823

# Phases 29-31, the scan driver and gradients.
# Scan against pool, per pixel: tests/test_wavefront.py's tolerance.
SCAN_TOL, SCAN_ALPHA_TOL = 2e-4, 1e-5
RESUME_TOL = 1e-5          # a resumed render against the straight one
ROUTE_RTOL = 1e-4          # gradients, kernel route against plain route
# Autograd against a central difference: tests/test_grad.py:66, 88 (2%,
# direct lighting) and :296 (5%, path); the steps.
FD4_TOL, FD4_EPS, FD3_TOL, FD3_EPS = 0.02, 1e-2, 0.05, 1e-3
ADAM_STEPS, ADAM_LR = 10, 0.05
BENCH3_KD = (0.65, 0.05, 0.05)    # the red wall, scenes/bench3.pbrt:24
BENCH3_KD0 = (0.3, 0.3, 0.3)      # where Adam starts

# Phases 32-33, the boundary gradients and several devices.
BOUNDARY_RES = 256        # the FD scenes' film (the tests: 48, 64)
# tests/test_grad.py's four FD cases (:119-179, :456-512) and the point
# shadow's scene under a distant light: the terms, spp, the target's
# shift, edge samples, seed, the central difference's step and the
# tolerance on |autograd - FD| / |FD|.
BOUNDARY_FD = {
    "occluder": (("primary",), 4, 0.2, 4096, 3, 1e-1, 0.10),
    "point_shadow": (("shadow",), 1, 0.25, 4096, 5, 5e-2, 0.10),
    "distant_shadow": (("shadow",), 1, 0.25, 4096, 5, 5e-2, 0.10),
    "area_shadow": (("area",), 4, 0.25, 4096, 5, 5e-2, 0.25),
    "sphere_rim": (("rim",), 1, 0.15, 2048, 7, 5e-2, 0.10),
}
BOUNDARY_STEPS = 3        # config4_big's timed steps, each kind
SHARD_TOL = 1e-5          # sharded against single-device results

# Phases 36-37, volumes and the rest of instancing. The references of
# config4_big/fog and bench3/smoke, written by tpuprt on the CPU
# (tools/volume_refs.py) at their own films; the card's image at that film
# within these limits (blurred rel, mean) of it: the same samples, so
# only float differences remain.
# The references are emission-only ("emission"): a jit of tpuprt's
# single-scattering render_chunk did not finish on the CPU (config4_big's
# failed after a 5.5-minute compile, bench3's ran past 18 minutes), so
# "single" is held by the pool against the scan here, per lane on the
# CPU (tests/test_torch_volumes_single.py), and on a small scene of its
# own against tpuprt's eager render (SINGLE_EXR).
FOG_EXR = os.path.join(ROOT, "scenes", "config4_fog.exr")
SMOKE_EXR = os.path.join(ROOT, "scenes", "bench3_smoke.exr")
VOL_REF_REL, VOL_REF_MEAN = 1e-3, 1e-3
VOL_REF_INTEGRATOR = "emission"
SMOKE_N, SMOKE_SEED = 32, 5  # bench3/smoke's density grid: 32^3, seeded
LAMPS, LAMP_MIRROR = 48, 8   # rocks/lamps: 48 lamps, every 8th mirrored
# Instanced lamps against the same lamps inline: test_instances.py's
# measures (mean |diff| / mean, the brightest pixel's relative difference).
LAMP_DIFF, LAMP_MAX = 0.03, 0.01
# rocks/loop against its inline tessellation, per pixel: the same samples,
# summed into a pixel in the order of the card's atomic adds.
LOOP_REL = 1e-5
# "single" scattering held to tpuprt's image of a scene of its own
# (single_text; tools/volume_refs.py, rendered eagerly on the CPU).
SINGLE_EXR = os.path.join(ROOT, "scenes", "single_box.exr")
SINGLE_RES, SINGLE_SEED = 16, 7
# Phase 38: the imaging pipeline on the card against the CPU, on the 0-255
# scale (the convolutions sum in other orders on the two devices).
TONEMAP_TOL = 1e-2


def write_lit_maps(d, small=1):
    """The maps of phases 26-28 as half EXRs in directory `d`, each side
    divided by `small`: tex.exr, the terrain's texture (64 x 64 cells of
    random colours, each texel dimmed by up to 15%); sky.exr, the
    environment (rows theta from the light's +z, columns phi): a blue sky
    brightening toward the zenith, a dark ground below the horizon and a
    sun of angular radius 0.03 at theta 0.3 pi, phi 1.2 pi; slide.exr,
    8 x 8 blocks of random colours; gonio.exr, a smooth pattern over the
    sphere."""
    import numpy as np
    from tpuprt_torch.io.exr import write_exr
    rng = np.random.default_rng(MAP_SEED)
    f32 = np.float32
    n = LIT_SIDE // small
    cells = rng.uniform(0.1, 0.9, (64, 64, 3)).astype(f32)
    tex = np.repeat(np.repeat(cells, n // 64, 0), n // 64, 1)
    tex = tex * (0.85 + 0.15 * rng.uniform(size=(n, n, 1))).astype(f32)
    h, w = SKY_HW[0] // small, SKY_HW[1] // small
    theta = ((np.arange(h) + 0.5) * np.pi / h)[:, None]
    phi = ((np.arange(w) + 0.5) * 2 * np.pi / w)[None, :]
    up = np.cos(theta)
    sky = np.where(up[..., None] > 0, np.array([0.35, 0.55, 1.0]) *
                   (0.5 + 0.5 * up[..., None]), 0.12) * np.ones((1, w, 1))
    t0, p0 = 0.3 * np.pi, 1.2 * np.pi
    cosang = np.cos(theta) * np.cos(t0) + np.sin(theta) * np.sin(t0) * \
        np.cos(phi - p0)
    sky[cosang > np.cos(0.03)] = 50.0
    m = SLIDE_SIDE // small
    slide = np.repeat(np.repeat(rng.uniform(0, 1, (8, 8, 3)), m // 8, 0),
                      m // 8, 1)
    gh, gw = GONIO_HW[0] // small, GONIO_HW[1] // small
    gt = ((np.arange(gh) + 0.5) * np.pi / gh)[:, None, None]
    gp = ((np.arange(gw) + 0.5) * 2 * np.pi / gw)[None, :, None]
    gonio = 0.6 + 0.4 * np.cos(3 * gt + np.array([0.0, 1.0, 2.0])) * \
        np.cos(2 * gp)
    os.makedirs(d, exist_ok=True)
    for name, img in (("tex.exr", tex), ("sky.exr", sky),
                      ("slide.exr", slide), ("gonio.exr", gonio)):
        write_exr(os.path.join(d, name), np.asarray(img, f32))
    return d


def _fmt(a):
    return " ".join(f"{x:.6g}" for x in a)


def patch_text(n=PATCH_QUADS, x=(-0.9, -0.5), z=(0.3, 0.7), y=0.9):
    """An n x n grid of quads in the plane y, its normal down (-y), as a
    trianglemesh's parameters."""
    import numpy as np
    xs, zs = np.meshgrid(np.linspace(*x, n + 1), np.linspace(*z, n + 1))
    P = np.stack([xs, np.full_like(xs, y), zs], -1).reshape(-1)
    idx = []
    for i in range(n):
        for j in range(n):
            a = i * (n + 1) + j
            idx += [a, a + 1, a + n + 1, a + 1, a + n + 2, a + n + 1]
    return f'"integer indices" [{_fmt(idx)}] "point P" [{_fmt(P)}]'


def fan_text(n=FAN_TRIS, r=0.3):
    """A disk of radius r in the plane z = 0 as a fan of n triangles, its
    normal +z as a disk's: trianglemesh parameters."""
    import math
    P = [0.0, 0.0, 0.0]
    for i in range(n):
        a = 2 * math.pi * i / n
        P += [r * math.cos(a), r * math.sin(a), 0.0]
    idx = []
    for i in range(n):
        idx += [0, 1 + i, 1 + (i + 1) % n]
    return f'"integer indices" [{_fmt(idx)}] "point P" [{_fmt(P)}]'


LIT_LIGHTS = '''AttributeBegin
Rotate -90 1 0 0
LightSource "infinitesample" "string mapname" "sky.exr" "color L" [0.6 0.6 0.6]
AttributeEnd
LightSource "spot" "point from" [0.8 1.5 -0.6] "point to" [0.3 0 0.2]
    "float coneangle" [18] "float conedeltaangle" [5] "color I" [4 3.6 3]
AttributeBegin
Translate -0.6 1.4 -0.4
Rotate 80 1 0 0
LightSource "projection" "string mapname" "slide.exr" "float fov" [30]
    "color I" [3 3 3]
AttributeEnd
AttributeBegin
Translate 0.3 0.8 0.5
Rotate 90 1 0 0
LightSource "goniometric" "string mapname" "gonio.exr" "color I" [1.2 1.2 1.2]
AttributeEnd
AttributeBegin
AreaLightSource "area" "color L" [3 2.8 2.6]
Shape "trianglemesh" {patch}
AttributeEnd
Texture "photo" "color" "imagemap" "string filename" "tex.exr"
    "float uscale" [4] "float vscale" [4]
TransformBegin
Scale 0.1 0.1 0.1
Texture "grain" "float" "fbm" "integer octaves" [6] "float roughness" [0.5]
Texture "wr" "float" "wrinkled" "integer octaves" [6] "float roughness" [0.5]
TransformEnd
Texture "kd" "color" "mix" "texture tex1" "photo" "color tex2" [0.45 0.4 0.32]
    "texture amount" "grain"
Texture "bumpamp" "float" "constant" "float value" [0.004]
Texture "bump" "float" "scale" "texture tex1" "wr" "texture tex2" "bumpamp"
Material "matte" "texture Kd" "kd" "texture bumpmap" "bump"
'''


def lit_text(base_text, kind="lit", res=None, spp=None):
    """config4_big's terrain and camera under other lights. "lit": the
    slide's main path (LIT_LIGHTS: an infinitesample sky, a spot, a
    projection, a goniometric light and a 512-triangle emissive patch;
    the terrain's Kd a mix of a 2048^2 EWA imagemap and a colour by an
    fbm, its bump a scale of wrinkled), by default at the file's 512x512
    x 4 spp. "infinitesample" or "infinite": the sky alone on the file's
    checkerboard, by default at ENV_RES^2 x ENV_SPP."""
    head = base_text[:base_text.index("WorldBegin")]
    mesh = base_text[base_text.index('Shape "trianglemesh"'):
                     base_text.rindex("WorldEnd")]
    if kind != "lit":
        res, spp = res or ENV_RES, spp or ENV_SPP
    if res:
        head = head.replace("[512]", f"[{res}]")
    if spp:
        head = head.replace('"integer pixelsamples" [4]',
                            f'"integer pixelsamples" [{spp}]')
    if kind == "lit":
        world = LIT_LIGHTS.format(patch=patch_text())
    else:
        world = (f'AttributeBegin\nRotate -90 1 0 0\nLightSource "{kind}" '
                 '"string mapname" "sky.exr" "color L" [0.6 0.6 0.6]\n'
                 'AttributeEnd\n' + base_text[
                     base_text.index('Texture "checks"'):
                     base_text.index('Shape "trianglemesh"')])
    return f"{head}WorldBegin\n{world}{mesh}WorldEnd\n"


def meshlight_text(text):
    """bench3's or bench6's disk light as a fan of FAN_TRIS triangles of the
    same radius and L, and Accelerator "none"."""
    disk = 'Shape "disk" "float radius" [0.3]'
    assert text.count(disk) == 1
    return text.replace(disk, f'Shape "trianglemesh" {fan_text()}').replace(
        "WorldBegin", 'Accelerator "none"\nWorldBegin', 1)


# Phase 34: bench3's walls and spheres in the other materials (the disk
# light keeps the default matte). Each entry replaces one Material line or
# one sphere's material of scenes/bench3.pbrt.
MATERIALS_3 = (
    ('Material "matte" "color Kd" [0.73 0.73 0.73]\n'
     'Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]\n'
     '  "point P" [-1 -1 -1  1 -1 -1  1 -1 1  -1 -1 1]',
     'Material "substrate" "color Kd" [0.62 0.56 0.48] "color Ks" '
     '[0.18 0.18 0.18] "float uroughness" [0.04] "float vroughness" [0.3]\n'
     'Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]\n'
     '  "point P" [-1 -1 -1  1 -1 -1  1 -1 1  -1 -1 1]\n'
     'Material "primer"'),                         # the floor; the ceiling
    ('  "point P" [-1 1 -1  -1 1 1  1 1 1  1 1 -1]\n',
     '  "point P" [-1 1 -1  -1 1 1  1 1 1  1 1 -1]\nMaterial "felt"\n'),
    ('Material "matte" "color Kd" [0.65 0.05 0.05]',   # the left wall
     'Material "bluepaint"'),
    ('Material "matte" "color Kd" [0.12 0.45 0.15]',   # the right wall
     'Material "uber" "color Kd" [0.12 0.45 0.15] "color Ks" [0.2 0.2 0.2] '
     '"color Kr" [0.05 0.05 0.05] "float roughness" [0.02] '
     '"color opacity" [0.6 0.6 0.6]'),
    ('Material "glass"',
     'Material "translucent" "color Kd" [0.5 0.4 0.3] "color Ks" '
     '[0.3 0.3 0.3] "float roughness" [0.05] "color reflect" [0.6 0.6 0.6] '
     '"color transmit" [0.4 0.4 0.4]'),
    ('Material "mirror"',
     'Material "shinymetal" "color Ks" [0.9 0.7 0.4] "color Kr" '
     '[0.5 0.4 0.3] "float roughness" [0.03]'),
)


def fog_text(text, res=None, spp=None, integrator="single"):
    """config4_big's text (film_text's res, spp) with one homogeneous
    Volume box over the terrain, thin fog that scatters forward, and the
    single-scattering VolumeIntegrator (or `integrator`)."""
    text = film_text(text, res, spp).replace(
        'SurfaceIntegrator "directlighting"',
        f'SurfaceIntegrator "directlighting"\n'
        f'VolumeIntegrator "{integrator}"', 1)
    cut = text.rindex("WorldEnd")
    return text[:cut] + (
        'Volume "homogeneous" "color sigma_a" [0.05 0.05 0.05]\n'
        '  "color sigma_s" [0.25 0.25 0.25] "float g" [0.3]\n'
        '  "point p0" [-1.2 -0.6 -1.2] "point p1" [1.2 0.35 1.2]\n') + \
        text[cut:]


def smoke_grid(n=SMOKE_N, seed=SMOKE_SEED):
    """bench3/smoke's density, n^3 values (x fastest): a smooth field of
    six Gaussian puffs at seeded centres and widths, in [0, ~1]."""
    import numpy as np
    rng = np.random.default_rng(seed)
    c = (np.arange(n) + 0.5) / n
    z, y, x = np.meshgrid(c, c, c, indexing="ij")
    d = np.zeros((n, n, n))
    for _ in range(6):
        m = rng.uniform(0.25, 0.75, 3)
        w = rng.uniform(0.1, 0.22)
        d += rng.uniform(0.4, 0.8) * np.exp(
            -((x - m[0]) ** 2 + (y - m[1]) ** 2 + (z - m[2]) ** 2) /
            (2 * w * w))
    return np.minimum(d, 1.0)


def smoke_text(text, res=None, spp=None, integrator="single"):
    """bench3's text (film_text's res, spp) with a SMOKE_N^3 "volumegrid"
    of smoke_grid's density inside the box: scattering, a little
    absorption, a faint warm glow, and the single-scattering
    VolumeIntegrator (or `integrator`)."""
    text = film_text(text, res, spp).replace(
        'SurfaceIntegrator "path" "integer maxdepth" [5]',
        'SurfaceIntegrator "path" "integer maxdepth" [5]\n'
        f'VolumeIntegrator "{integrator}"', 1)
    n = SMOKE_N
    dens = " ".join(f"{v:.4f}" for v in smoke_grid().ravel())
    cut = text.rindex("WorldEnd")
    return text[:cut] + (
        f'Volume "volumegrid" "integer nx" [{n}] "integer ny" [{n}] '
        f'"integer nz" [{n}]\n  "float density" [{dens}]\n'
        '  "color sigma_a" [0.2 0.2 0.2] "color sigma_s" [1.2 1.2 1.2]\n'
        '  "color Le" [0.03 0.02 0.01] "float g" [0.2]\n'
        '  "point p0" [-0.95 -1 -0.95] "point p1" [0.95 0.6 0.95]\n') + \
        text[cut:]


def single_text(res=SINGLE_RES, spp=1):
    """A small scene of its own for "single" scattering against tpuprt's
    image (scenes/single_box.exr, tools/volume_refs.py): a floor, a back
    wall and a box, 14 triangles under Accelerator "none", a homogeneous
    region over them and a 4^3 volumegrid of seeded density inside it, lit
    by a point light and a downward disk area light, directlighting with
    VolumeIntegrator "single", at res x res x spp."""
    import numpy as np
    P = [-1.5, 0, -1.5, 1.5, 0, -1.5, 1.5, 0, 1.5, -1.5, 0, 1.5,
         -1.5, 0, 1.5, 1.5, 0, 1.5, 1.5, 2.5, 1.5, -1.5, 2.5, 1.5]
    idx = [0, 1, 2, 0, 2, 3, 4, 5, 6, 4, 6, 7]
    box = [(x, y, z) for y in (0.0, 0.7) for z in (-0.6, 0.0)
           for x in (-0.2, 0.4)]
    base = len(P) // 3
    P += [c for v in box for c in v]
    # The box's top and its four sides (the floor hides its bottom).
    for a, b, c, d in ((4, 5, 7, 6), (0, 1, 5, 4), (2, 3, 7, 6),
                       (0, 2, 6, 4), (1, 3, 7, 5)):
        idx += [base + a, base + b, base + c, base + a, base + c, base + d]
    dens = np.random.default_rng(SINGLE_SEED).uniform(0, 3, 64)
    return f'''Film "image" "integer xresolution" [{res}]
  "integer yresolution" [{res}] "string filename" ["single_box.exr"]
Sampler "lowdiscrepancy" "integer pixelsamples" [{spp}]
PixelFilter "box"
LookAt 0 1.1 -3.6  0 0.7 0  0 1 0
Camera "perspective" "float fov" [50]
SurfaceIntegrator "directlighting"
VolumeIntegrator "single"
Accelerator "none"
WorldBegin
LightSource "point" "point from" [0.9 2.1 -0.8] "color I" [5 5 5]
AttributeBegin
  Translate -0.5 2.2 0.3
  Rotate 90 1 0 0
  AreaLightSource "area" "color L" [5 4.5 4]
  Shape "disk" "float radius" [0.35]
AttributeEnd
Material "matte" "color Kd" [0.6 0.55 0.5]
Shape "trianglemesh" "integer indices" [{_fmt(idx)}] "point P" [{_fmt(P)}]
Volume "homogeneous" "color sigma_a" [0.04 0.04 0.04]
  "color sigma_s" [0.2 0.2 0.2] "float g" [0.3]
  "point p0" [-1.4 0.01 -1.4] "point p1" [1.4 2.3 1.4]
Volume "volumegrid" "integer nx" [4] "integer ny" [4] "integer nz" [4]
  "float density" [{_fmt(dens)}]
  "color sigma_a" [0.1 0.1 0.1] "color sigma_s" [0.8 0.8 0.8]
  "color Le" [0.02 0.015 0.01] "float g" [-0.2]
  "point p0" [-1.1 0.05 -0.5] "point p1" [-0.3 1.0 0.5]
WorldEnd
'''


def materials_text(text, res=None, spp=None):
    """bench3 (scenes/bench3.pbrt) with its walls and spheres in the other
    materials (MATERIALS_3: substrate, primer, felt, bluepaint, uber at
    opacity 0.6, translucent, shinymetal) and no PixelFilter line, so
    pbrt-v1's default Mitchell 2x2 applies; by default at the file's
    256x256 x 32 spp."""
    for old, new in MATERIALS_3:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    text = "".join(line + "\n" for line in text.splitlines()
                   if not line.startswith("PixelFilter"))
    return film_text(text, res, spp)


# Phase 35: config4_big's cameras and filters. Each kind's Camera and
# PixelFilter lines replace the file's; "ortho" also makes the terrain
# substrate over the checkerboard.
CAMERAS_4 = {
    "mitchell": ('Camera "perspective" "float fov" [55]', None),
    "thinlens": ('Camera "perspective" "float fov" [55] "float lensradius" '
                 '[0.06] "float focaldistance" [2.6]',
                 'PixelFilter "triangle"'),
    "ortho": ('Camera "orthographic" "float screenwindow" [-1.3 1.3 -1.3 '
              '1.3]', 'PixelFilter "gaussian"'),
    "env": ('Camera "environment"', 'PixelFilter "sinc"'),
}


def cameras_text(text, kind, res=None, spp=None):
    """config4_big (scenes/config4_big.pbrt) through another camera and
    pixel filter (CAMERAS_4): "mitchell" a pinhole and no PixelFilter line
    (pbrt-v1's default Mitchell 2x2), "thinlens" a lens of radius 0.06
    focused at 2.6 with the triangle filter, "ortho" the orthographic
    camera with the gaussian filter over a substrate terrain, "env" the
    environment camera with the sinc filter (4x4); by default at the
    file's 512x512 x 4 spp."""
    camera, pfilter = CAMERAS_4[kind]
    lines = []
    for line in text.splitlines():
        if line.startswith("Camera "):
            line = camera
        elif line.startswith("PixelFilter "):
            if pfilter is None:
                continue
            line = pfilter
        lines.append(line)
    text = "".join(line + "\n" for line in lines)
    if kind == "ortho":
        old = 'Material "matte" "texture Kd" "checks"'
        assert text.count(old) == 1
        text = text.replace(old, 'Material "substrate" "texture Kd" "checks" '
                            '"color Ks" [0.12 0.12 0.12] "float uroughness" '
                            '[0.02] "float vroughness" [0.25]')
    return film_text(text, res, spp)


def emit(**kw):
    print(json.dumps(kw), flush=True)


def rocks_scene_text(base_text, n_rocks, subdiv, seed, dup_every=0,
                     rock=None):
    """`base_text` (a config4-style terrain scene) with `n_rocks` instances
    of one rock inserted before its WorldEnd.

    The rock is ObjectBegin "rock": tools/make_scenes.icosphere(subdiv)
    with each vertex pushed out radially by a seeded factor in [0.8, 1.2],
    the sphere's directions as "normal N", a spherical "float uv", and its
    own matte material (1280 triangles at subdiv 3). The instances sit on a
    seeded, jittered 40 x 25 grid over [-0.95, 0.95]^2 (n_rocks < 1000
    take evenly spaced cells), on the terrain's height function
    (make_scenes.terrain), with a uniform yaw and a scale in [0.015, 0.04];
    every 10th is mirrored (Scale -1 1 1) and every 7th scaled by k in
    [0.5, 1.5] along y (a non-uniform scale). With dup_every k > 0, every
    k-th instance is placed again after all of them: the same prototype
    under the same transform, so its hits tie exactly with the first's.
    `rock`: the object's shape lines in place of the icosphere (the
    placements do not change)."""
    import numpy as np
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_scenes import icosphere
    rng = np.random.default_rng(seed)
    dirs, faces = icosphere(subdiv)
    verts = dirs * rng.uniform(0.8, 1.2, (len(dirs), 1)).astype(np.float32)
    u = 0.5 + np.arctan2(dirs[:, 2], dirs[:, 0]) / (2 * np.pi)
    v = np.arccos(np.clip(dirs[:, 1], -1.0, 1.0)) / np.pi

    def nums(a):
        return " ".join(f"{x:.6g}" for x in np.asarray(a).ravel())

    shape = rock or (
        f'Shape "trianglemesh" "integer indices" [{nums(faces)}]\n'
        f'  "point P" [{nums(verts)}]\n  "normal N" [{nums(dirs)}]\n'
        f'  "float uv" [{nums(np.stack([u, v], 1))}]\n')
    out = ['ObjectBegin "rock"\n',
           'Material "matte" "color Kd" [0.45 0.42 0.40]\n', shape,
           "ObjectEnd\n"]
    nx, nz = 40, 25
    blocks = []
    for i in range(n_rocks):
        cell = i * (nx * nz) // n_rocks
        x = -0.95 + (cell % nx + 0.5 + rng.uniform(-0.3, 0.3)) * 1.9 / nx
        z = -0.95 + (cell // nx + 0.5 + rng.uniform(-0.3, 0.3)) * 1.9 / nz
        h = 0.35 * (np.sin(3.1 * x) * np.cos(2.7 * z) +
                    0.4 * np.sin(7.3 * x + 1.1) * np.sin(6.1 * z))
        s = rng.uniform(0.015, 0.04)
        b = (f"AttributeBegin\n  Translate {x:.6g} {h:.6g} {z:.6g}\n"
             f"  Rotate {rng.uniform(0.0, 360.0):.6g} 0 1 0\n"
             f"  Scale {s:.6g} {s:.6g} {s:.6g}\n")
        if i % 10 == 0:
            b += "  Scale -1 1 1\n"
        if i % 7 == 3:
            b += f"  Scale 1 {rng.uniform(0.5, 1.5):.6g} 1\n"
        blocks.append(b + '  ObjectInstance "rock"\nAttributeEnd\n')
    out += blocks
    if dup_every:
        out += blocks[::dup_every]
    cut = base_text.rindex("WorldEnd")
    return base_text[:cut] + "".join(out) + base_text[cut:]


def loop_rock(seed=ROCK_SEED, nlevels=3, inline=False):
    """The rock as a Loop subdivision surface: a Shape "loopsubdiv" of
    `nlevels` over a jittered icosahedron (12 vertices pushed out radially
    by a seeded factor in [0.8, 1.2]; 20 x 4^3 = 1280 triangles at 3
    levels), or with `inline` the port's tessellation of it written as a
    trianglemesh, every f32 value exactly."""
    import numpy as np
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_scenes import icosphere
    dirs, faces = icosphere(0)
    verts = dirs * np.random.default_rng(seed + 100).uniform(
        0.8, 1.2, (len(dirs), 1))
    nums = lambda a: " ".join(f"{x:.9g}" for x in np.asarray(a).ravel())
    text = (f'Shape "loopsubdiv" "integer nlevels" [{nlevels}]\n'
            f'  "integer indices" [{nums(faces)}]\n'
            f'  "point P" [{nums(verts.astype(np.float32))}]\n')
    if not inline:
        return text
    from tpuprt_torch.scene.parser import ParamSet, tokenize, _Stream
    ts = _Stream(tokenize(text))
    ts.next()
    ts.next()
    P, idx, _, _ = __import__(
        "tpuprt_torch.scene.tessellate", fromlist=["tessellate"]).tessellate(
            "loopsubdiv", ts.params())
    return (f'Shape "trianglemesh" "integer indices" [{nums(idx)}]\n'
            f'  "point P" [{nums(P)}]\n')


def lamps_text(base_text, n=LAMPS, mirror_every=LAMP_MIRROR, seed=3,
               inline=False):
    """`base_text` (the rocks scene) with `n` quad lamps hovering over the
    terrain (make_scenes.terrain's height function), emitting down onto it:
    one emissive ObjectBegin "lamp" placed n times at seeded points, yaws
    and sizes (similarity transforms, each placement its own light), every
    `mirror_every`-th mirrored (Scale -1 1 1); with `inline`, the same
    lamps written inline, each a mesh emitter (the duplication path)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lamp = ('AreaLightSource "area" "color L" [9 8 6]\n'
            'Material "matte" "color Kd" [0.1 0.1 0.1]\n'
            'Shape "trianglemesh" "integer indices" [0 2 1 0 3 2]\n'
            '  "point P" [-1 0 -1  1 0 -1  1 0 1  -1 0 1]\n')
    out = [] if inline else ['ObjectBegin "lamp"\n', lamp, "ObjectEnd\n"]
    for i in range(n):
        x, z = rng.uniform(-0.9, 0.9, 2)
        h = 0.35 * (np.sin(3.1 * x) * np.cos(2.7 * z) +
                    0.4 * np.sin(7.3 * x + 1.1) * np.sin(6.1 * z))
        side = rng.uniform(0.01, 0.025)
        out.append(f"AttributeBegin\n  Translate {x:.6g} {h + 0.06:.6g} "
                   f"{z:.6g}\n  Rotate {rng.uniform(0, 360):.6g} 0 1 0\n"
                   f"  Scale {side:.6g} {side:.6g} {side:.6g}\n")
        if mirror_every and i % mirror_every == 0:
            out.append("  Scale -1 1 1\n")
        out.append((lamp if inline else '  ObjectInstance "lamp"\n') +
                   "AttributeEnd\n")
    cut = base_text.rindex("WorldEnd")
    return base_text[:cut] + "".join(out) + base_text[cut:]


def deep_tree(levels, seed):
    """A row-format BVH `levels` deep, built by hand from a seed, since
    accel/csrc/bvh_build8.cpp's recursion guard (binary depth 60, then
    equal splits) keeps its trees below about 28 levels. A spine: node k <
    levels has 8 children, first the spine's next node, then 7 leaves, each
    of 8 triangles of size 0.3 r at radius r = 0.8^k around the origin in
    seeded directions; the last spine node is such a leaf. Every box is the
    exact bound of what lies below it, so a ray through the middle enters
    every child at every level, the spine first, and the row walk's stack
    holds an entry a level, past its 32 local ones. Interior rows hold
    their children's ids in cols 8..15, as the builder's do. Returns a
    BvhAccel (host tensors: rows, child table, depth; no tiles)."""
    import numpy as np
    import torch
    from tpuprt_torch.accel import bvh_build
    from tpuprt_torch.scene.data import BvhAccel
    rng = np.random.default_rng(seed)
    rows, tid = [], 0

    def leaf(k):
        nonlocal tid
        r = 0.8 ** k
        c = rng.normal(size=(8, 3))
        c *= r / np.linalg.norm(c, axis=1, keepdims=True)
        tri = (c[:, None] + 0.3 * r * rng.normal(size=(8, 3, 3))
               ).astype(np.float32)
        row = np.zeros(bvh_build.NODE_COLS, np.float32)
        row[0:3], row[3:6] = tri.min((0, 1)), tri.max((0, 1))
        row[6], row[7] = len(rows) + 1, 8
        row[8:80] = tri.reshape(72)
        row[80:88] = np.arange(tid, tid + 8)
        tid += 8
        rows.append(row)

    # Preorder: spine node k, its subtree through the spine, its 7 leaves.
    spine = []
    for k in range(levels):
        spine.append(len(rows))
        rows.append(np.zeros(bvh_build.NODE_COLS, np.float32))
    leaf(levels)
    for k in range(levels - 1, -1, -1):
        first = spine[k] + 1
        row = rows[spine[k]]
        row[8:16] = [first] + list(range(len(rows), len(rows) + 7))
        for _ in range(7):
            leaf(k + 1)
        below = np.stack(rows[first:])
        row[0:3], row[3:6] = below[:, 0:3].min(0), below[:, 3:6].max(0)
        row[6] = len(rows)
    rows = np.stack(rows)
    nn = len(rows)
    depth, rank, parent = bvh_build.tree_links(rows, nn)
    return BvhAccel(
        bounds_lo=torch.from_numpy(rows[0, 0:3].copy()),
        bounds_hi=torch.from_numpy(rows[0, 3:6].copy()),
        nodes=torch.from_numpy(rows),
        child=torch.from_numpy(bvh_build.child_table(rank, parent)),
        max_depth=int(depth.max()), n_nodes=nn, leaf_k=8)


def deep_rays(n, seed):
    """Packed f32[8, n] rays for deep_tree: from a sphere of radius 3
    through a point within 0.8^k of the origin (k uniform in [0, 40]),
    a fifth with a short maxt."""
    import numpy as np
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o *= 3.0 / np.linalg.norm(o, axis=1, keepdims=True)
    tgt = rng.normal(size=(n, 3)) * (0.8 ** rng.uniform(0, 40, n))[:, None]
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    maxt = np.full(n, 1e30)
    maxt[1::5] = rng.uniform(2.0, 3.5, len(maxt[1::5]))
    return np.ascontiguousarray(np.concatenate(
        [o, d, np.full((n, 1), 1e-3), maxt[:, None]], 1).T, np.float32)


def understated_depth(timeout=300):
    """The row walk told a depth below its tree's (deep_tree with
    max_depth 1: 32 local stack levels for 40) must fail, not write past
    its stack: the kernel traps and the launch's error surfaces at the
    next synchronization. Run in a child process, since a trap leaves the
    CUDA context unusable. Emits a line; raises if the child exits 0."""
    code = (
        "import sys, torch; sys.path.insert(0, %r); import chip_smoke as c; "
        "from tpuprt_torch.ops import bvh_cuda; "
        "from tpuprt_torch.scene.data import to_device; "
        "b = to_device(c.deep_tree(c.DEEP_LEVELS, 6), 'cuda'); "
        "r = torch.from_numpy(c.deep_rays(1 << 12, 7)).cuda(); "
        "bvh_cuda.traverse_rows(b.nodes, r, nn=b.n_nodes, max_depth=1); "
        "torch.cuda.synchronize()" % ROOT)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=timeout, cwd=ROOT)
    err = [ln for ln in r.stderr.splitlines() if "Error" in ln]
    emit(phase="refuse", kernel="bvh_rows",
         set=f"deep_tree({DEEP_LEVELS}), max_depth 1", rc=r.returncode,
         error=err[-1][:200] if err else None)
    if r.returncode == 0:
        raise AssertionError("the row walk ran a tree deeper than its stack")


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
    o, d, mint, maxt, _ = cam.generate_rays(
        scene.camera, cs["image_x"], cs["image_y"], cs["lens_u"],
        cs["lens_v"], cs["time"], opts.xres, opts.yres)
    return torch.cat([o, d, mint[:, None], maxt[:, None]], 1).T.contiguous()


def sort_packed(bvh, rays):
    """The front end's coherence order (ops/bvh_cuda.intersect), so a
    kernel is timed on rays as the render hands them over."""
    from tpuprt_torch.ops import bvh_cuda
    order = bvh_cuda.sort_key(bvh.bounds_lo, bvh.bounds_hi, rays[0:3].T,
                              rays[3:6].T).argsort(stable=True)
    return rays[:, order].contiguous()


def timed(fn, reps=5):
    """Median time (ms) of `reps` calls between CUDA events on the current
    stream, after a warm-up call, and the median host time (ms) a call
    took to return; returns (ms, result of the last call, host_ms). A spin
    kernel (HOLD_CYCLES) holds the stream while the host enqueues the
    start event and the call, so a kernel's time is the device's, and its
    host_ms the wrapper's launch cost (Python, checks, ctypes), which the
    render pays on the host. A call that synchronizes (a plain version)
    waits for the spin: its host_ms is not a launch cost."""
    import torch
    out = fn()
    times, host = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        t0 = time.perf_counter()
        out = fn()
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    mid = len(times) // 2
    return sorted(times)[mid], out, sorted(host)[mid]


def compare(ref, got):
    """Kernel (t, id[, inst]) against the plain version's: equal hit masks,
    equal ids (and instances) where both hit except at ties (t equal
    within T_RTOL), t within T_RTOL relative. Returns the counts."""
    import torch
    t_ref, id_ref = ref[0], ref[1]
    t, ids = got[0], got[1]
    hit_ref, hit = id_ref >= 0, ids >= 0
    both = hit_ref & hit
    rel = (t - t_ref).abs() / t_ref.abs().clamp(min=1e-30)
    tie = rel <= T_RTOL
    differ = torch.zeros_like(both)
    for a, b in zip(ref[1:], got[1:]):
        differ |= a != b
    return dict(
        rays=int(t.numel()), hits=int(hit_ref.sum()),
        hit_mask_mismatch=int((hit_ref != hit).sum()),
        id_mismatch=int((both & differ & ~tie).sum()),
        id_mismatch_at_ties=int((both & differ & tie).sum()),
        t_rel_max=float(torch.where(both, rel, 0.0).max()),
        max_abs_err=float(torch.where(both, (t - t_ref).abs(), 0.0).max()))


def bound(name, nbytes, counts):
    """(ms, "bytes" | "operations", ops): the larger of the bytes over the
    memory rate and the counted tests' operations over the f32 rate."""
    if name == "mt_best":
        ops = sum(MT_STAGE_OPS[k] * counts[k] for k in MT_STAGE_OPS)
    else:
        ops = SLAB_OPS * (counts.get("slab", 0) + counts.get("entry", 0)) + \
            TRI_OPS[name] * counts["tri"] + XFORM_OPS * counts.get("xform", 0)
    t_bytes, t_ops = nbytes / HBM_BPS, ops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", ops)


def parity(label, name, kernel, ref, table_bytes, rays, reps=5,
           modes=(False, True), plain_reps=None, steps=None):
    """Kernel vs plain version on one packed ray set, in each mode (any_hit
    False, True): nearest must agree per ray (masks, ids outside ties, t),
    any-hit in its masks. `kernel(rays, any_hit)` and `ref(rays, any_hit,
    with_counts)` return (t, id[, inst][, counts]). The plain version is
    timed over plain_reps calls (default reps). `steps(counts, n_rays)`,
    where given, adds the line's steps_per_ray."""
    results = []
    for any_hit in modes:
        ms, got, host_ms = timed(lambda: kernel(rays, any_hit), reps)
        plain_ms, _, _ = timed(lambda: ref(rays, any_hit, False),
                               plain_reps or reps)
        *want, counts = ref(rays, any_hit, True)
        r = compare(want, got)
        n = rays.shape[1]
        nbytes = table_bytes + rays.numel() * 4 + 4 * len(got) * n
        bound_ms, bound_by, ops = bound(name, nbytes, counts)
        r.update(phase="parity", kernel=name, set=label,
                 mode="any" if any_hit else "nearest", ms=ms,
                 host_ms=host_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                 fmad_floor_ms=ops / (F32_FLOPS / 2) * 1e3,
                 bytes=nbytes, ops=ops, counts=counts)
        if steps:
            r["steps_per_ray"] = steps(counts, n)
        emit(**r)
        bad = r["hit_mask_mismatch"] or (not any_hit and (
            r["id_mismatch"] or r["t_rel_max"] > T_RTOL))
        if bad:
            raise AssertionError(f"{name} disagrees with its plain version: "
                                 f"{r}")
        results.append(r)
    return results


def steps_of(old_key, new_keys, scale=1):
    """counts -> per-ray steps: the skip-link walk's dependent steps
    (counts[old_key]) and the descent's entered nodes (the sum of
    counts[new_keys] over `scale`), for parity's `steps`."""
    def steps(c, n):
        return dict(skip_link=c[old_key] / n,
                    entered=sum(c[k] for k in new_keys) / scale / n)
    return steps


def bit_equal(rs):
    """Raise unless every parity result has equal t and ids per ray (the
    walks enter the nodes of their plain versions in the same order, so
    both modes' results are fixed per ray)."""
    for r in rs:
        if r["id_mismatch"] or r["id_mismatch_at_ties"] or r["t_rel_max"]:
            raise AssertionError(f"{r['kernel']} is not bit-equal: {r}")
    return rs


def tiles_parity(label, bvh, rays, reps=5):
    """The tile walk vs its plain version. Bytes: what the plain version
    needs, the tile rows, skip and meta once (the kernel reads its child-id
    table instead of skip and meta)."""
    from tpuprt_torch.ops import bvh_cuda
    args = (bvh.nodesT, bvh.nodeskip, bvh.nodemeta)
    return bit_equal(parity(
        label, "bvh_tiles",
        lambda r, a: bvh_cuda.traverse_tiles(*args, bvh.child, r,
                                             nn=bvh.n_nodes, any_hit=a),
        lambda r, a, c: bvh_cuda.traverse_tiles_ref(
            *args, r, nn=bvh.n_nodes, any_hit=a, with_counts=c),
        bvh.n_nodes * (128 * 4 + 8), rays, reps,
        steps=steps_of("steps", ("slab", "tri"), 8)))


def rows_parity(label, bvh, rays, reps=5):
    """The row walk vs its plain version. Bytes: the rows' read columns
    once."""
    from tpuprt_torch.ops import bvh_cuda
    return bit_equal(parity(
        label, "bvh_rows",
        lambda r, a: bvh_cuda.traverse_rows(bvh.nodes, r, nn=bvh.n_nodes,
                                            max_depth=bvh.max_depth,
                                            any_hit=a),
        lambda r, a, c: bvh_cuda.traverse_rows_ref(
            bvh.nodes, r, nn=bvh.n_nodes, any_hit=a, with_counts=c),
        bvh.n_nodes * ROW_BYTES, rays, reps,
        steps=steps_of("slab", ("entered",))))


def instanced_parity(label, inst, rays, reps=5, exact=False):
    """The instanced walk vs its plain version; `exact` also requires, in
    nearest mode, equal ids, instances and t on every ray, ties included
    (the tie set)."""
    from tpuprt_torch.ops import bvh_cuda
    w2o12 = inst.inst_w2o[:, :3, :].reshape(inst.count, 12).contiguous()
    args = (inst.nodes, inst.entry_block, inst.entry_inst, inst.entry_start,
            inst.entry_stop, inst.entry_bbox, w2o12)
    # The used rows of each prototype block once, 4 ints and a 6-float box
    # per entry, 12 floats per instance.
    used = dict(zip(inst.entry_block.tolist(),
                    (inst.entry_stop - inst.entry_start).tolist()))
    table_bytes = sum(used.values()) * ROW_BYTES + \
        inst.n_entries * 10 * 4 + w2o12.numel() * 4
    rs = parity(
        label, "bvh_instanced",
        lambda r, a: bvh_cuda.traverse_instanced(*args, r,
                                                 cap=inst.block_cap,
                                                 top=inst.top_nodes,
                                                 any_hit=a),
        lambda r, a, c: bvh_cuda.traverse_instanced_ref(
            *args, r, cap=inst.block_cap, any_hit=a, with_counts=c),
        table_bytes, rays, reps)
    if exact:
        got = bvh_cuda.traverse_instanced(*args, rays, cap=inst.block_cap,
                                          top=inst.top_nodes)
        want = bvh_cuda.traverse_instanced_ref(*args, rays,
                                               cap=inst.block_cap)
        differ = [int((a != b).sum()) for a, b in zip(want, got)]
        emit(phase="parity", kernel="bvh_instanced", set=label,
             mode="nearest, exact", t_differ=differ[0], id_differ=differ[1],
             inst_differ=differ[2], hits=int((want[1] >= 0).sum()))
        if any(differ):
            raise AssertionError(f"{label}: ids, instances or t differ "
                                 f"{differ}")
    return rs


def mt_parity(label, tris, rays, reps=5, modes=(False, True),
              plain_reps=None):
    """mt_best vs mt_best_ref, nearest and any-hit. Both modes' results
    are fixed per ray (any-hit: the lowest-index hit), so t and ids must be
    equal bit for bit in both. Bytes: the 9-float triangles once."""
    from tpuprt_torch.ops import mt_cuda
    rs = parity(
        label, "mt_best", lambda r, a: mt_cuda.mt_best(r, tris, any_hit=a),
        lambda r, a, c: mt_cuda.mt_best_ref(r, tris, any_hit=a,
                                            with_counts=c),
        tris.numel() * 4, rays, reps, modes=modes, plain_reps=plain_reps)
    for r in rs:
        if r["id_mismatch"] or r["id_mismatch_at_ties"] or r["t_rel_max"]:
            raise AssertionError(f"mt_best is not bit-equal: {r}")
    return rs


def adversarial_mt_set(seed, n_rays=1 << 16, n_tris=64):
    """Packed (tris f32[9,T], rays f32[8,N]) at the edges of mt_best's
    staged rejects, as numpy. Triangles span scales 1e-7 to 3e10 (so |div|
    runs from below 1e-12 past the guard at 1e20), the last eighth exact
    copies of earlier ones. Each ray aims at one triangle: at a vertex
    exactly (b1 or b2 = 0, numerators near or at +-0), at an edge point,
    inside it, or along its plane (div near 0); a tenth of the directions
    have an exact zero component; a fifth of the windows start at -1e30
    (negative t can win), a tenth are empty, a tenth end short."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n_own = n_tris - n_tris // 8
    scale = 10.0 ** np.linspace(-7.0, 10.5, n_own)
    c = rng.uniform(-10, 10, (n_own, 3))
    p = c[:, None] + scale[:, None, None] * rng.normal(size=(n_own, 3, 3))
    p = np.concatenate([p, p[rng.integers(0, n_own, n_tris - n_own)]])
    p = p.astype(np.float32)
    pk = p[rng.integers(0, n_tris, n_rays)].astype(np.float64)
    kind = rng.integers(0, 4, n_rays)[:, None]
    u = rng.uniform(0, 1, (n_rays, 1))
    bary = np.where(kind == 0, np.eye(3)[rng.integers(0, 3, n_rays)],
                    np.where(kind == 1, np.concatenate(
                        [u, 1 - u, 0 * u], 1),
                        rng.dirichlet(np.ones(3), n_rays)))
    tgt = (bary[:, :, None] * pk).sum(1)
    e1, e2 = pk[:, 1] - pk[:, 0], pk[:, 2] - pk[:, 0]
    nrm = np.cross(e1, e2)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-300)
    along = e1 / np.linalg.norm(e1, axis=1, keepdims=True) + \
        rng.normal(0, 1e-7, (n_rays, 1)) * nrm
    d = np.where(kind == 3, along, rng.normal(size=(n_rays, 3)))
    d[rng.uniform(size=n_rays) < 0.1, 0] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dist = np.linalg.norm(e1, axis=1) * 10.0 ** rng.uniform(-3, 2, n_rays)
    o = tgt - d * dist[:, None]
    mint = np.full(n_rays, 1e-3)
    maxt = np.full(n_rays, 1e30)
    mint[rng.uniform(size=n_rays) < 0.2] = -1e30
    dead = rng.uniform(size=n_rays) < 0.1
    mint[dead], maxt[dead] = 1.0, -1.0
    short = ~dead & (rng.uniform(size=n_rays) < 0.1)
    maxt[short] = dist[short] * rng.uniform(0.5, 1.5, short.sum())
    tris = np.concatenate([p[:, 0].T, (p[:, 1] - p[:, 0]).T,
                           (p[:, 2] - p[:, 0]).T])
    rays = np.concatenate([o, d, mint[:, None], maxt[:, None]], 1).T
    return (np.ascontiguousarray(tris, np.float32),
            np.ascontiguousarray(rays, np.float32))


def mt_pairs_parity(label, tris, rays):
    """One mt_best launch per triangle, both modes: each pair's own (t,
    id) against the plain version's, bit for bit."""
    from tpuprt_torch.ops import mt_cuda
    bad = pairs = hits = 0
    for j in range(tris.shape[1]):
        one = tris[:, j:j + 1].contiguous()
        want = mt_cuda.mt_best_ref(rays, one)
        for any_hit in (False, True):
            got = mt_cuda.mt_best(rays, one, any_hit=any_hit)
            bad += int(((got[0] != want[0]) | (got[1] != want[1])).sum())
        pairs += rays.shape[1]
        hits += int((want[1] >= 0).sum())
    emit(phase="parity", kernel="mt_best", set=label, mode="per pair",
         pairs=pairs, hits=hits, differ=bad)
    if bad:
        raise AssertionError(f"{label}: {bad} pairs differ")


@contextlib.contextmanager
def patched(module, name, fn):
    """module.name replaced by fn while the block runs."""
    real = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield real
    finally:
        setattr(module, name, real)


def capture_rays(scene, opts, device, module, name, at, period=None,
                 maps=None, aux=None, by=None):
    """The packed rays of one render's calls of the kernel wrapper
    module.name (rays its argument number `at`), as {any_hit: rays of the
    call with the most rays that have a non-empty window} (the first passes
    cover the sky, where no shadow ray is traced). With `period` p, when
    the render calls the wrapper p times a pass: {(k, any_hit): rays of the
    k-th call of one pass}, the pass whose any-hit calls (with `by`: whose
    by-th call) have the most such rays. `maps`: a photonmap render's PhotonMaps (none: the render shoots
    its own, and those launches count in the period); `aux`: a chunked
    render's preprocess state (none: the render runs its preprocess). Not a
    main-path run: the counts are reset before that."""
    from tpuprt_torch import render as R
    got, cur, n = {}, {}, [0, -1]

    def spy(*a, **kw):
        rays, any_hit = a[at], kw.get("any_hit", False)
        live = int((rays[6] <= rays[7]).sum())
        if period:
            k = n[0] % period
            n[0] += 1
            if k == 0:
                cur.clear()
                cur["live"] = 0
            cur[(k, any_hit)] = rays.clone()
            cur["live"] += live if (any_hit if by is None else k == by) \
                else 0
            if k == period - 1 and cur["live"] > n[1]:
                n[1] = cur["live"]
                got.clear()
                got.update({key: (0, v) for key, v in cur.items()
                            if key != "live"})
        elif live > got.get(any_hit, (-1, None))[0]:
            got[any_hit] = (live, rays.clone())
        return real(*a, **kw)
    with patched(module, name, spy) as real:
        R.render(scene, opts, device=device, maps=maps, aux=aux)
    return {k: v[1] for k, v in got.items()}


def config2_none_text():
    """scenes/config2.pbrt with Accelerator "none" in place of "grid"."""
    with open(CONFIG2) as f:
        text = f.read()
    assert 'Accelerator "grid"' in text
    return text.replace('Accelerator "grid"', 'Accelerator "none"')


def config5_huge():
    """bench.py's config5_huge (build_config5_scene): the 1M-triangle
    terrain with config4's lights and camera, plain matte, built through
    the port's SceneBuilder, and bench.py's options for it. Returns
    (scene on the host, RenderOptions, triangles)."""
    import numpy as np
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_scenes import terrain
    from tpuprt_torch.cameras import cameras as cam
    from tpuprt_torch.core import transform as tf
    from tpuprt_torch.render import RenderOptions
    from tpuprt_torch.samplers.samplers import SamplerConfig
    from tpuprt_torch.scene.build import SceneBuilder
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
    opts = RenderOptions(
        xres=512, yres=512,
        sampler=SamplerConfig(kind="lowdiscrepancy", pixelsamples=4),
        filter_kind="box", filter_xwidth=0.5, filter_ywidth=0.5,
        integrator="directlighting", max_depth=5, chunk_size=1 << 17,
        half_readback=True)
    return b.build(), opts, len(f)


def walk_timing(label, scene, rays, any_hit=False, reps=3):
    """The plain grid, kd-tree or quadric-BVH walk (accel/grid.py,
    accel/kdtree.py, accel/bvh.walk_skip_links) on the card: its wall per
    call (host clock, synchronized; median of `reps` after a warm-up), the
    passes it made (a DDA step, a kd restart or a skip-link step: one
    batched prim test each) and the (ray, slot) pairs it tested (a second,
    counted call)."""
    import torch
    from tpuprt_torch.accel import bvh as bvh_mod
    from tpuprt_torch.accel import grid as grid_mod
    from tpuprt_torch.accel import intersect as isect
    from tpuprt_torch.accel import kdtree as kd_mod
    args = (scene, rays[0:3].T, rays[3:6].T, rays[6], rays[7])

    def call():
        out = isect.occluded(*args) if any_hit else \
            isect.intersect_ids(*args)[2]
        torch.cuda.synchronize()
        return out
    call()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        hit = call()
        walls.append(time.perf_counter() - t0)
    passes, pairs = [0], [0]
    real = grid_mod.nearest_in_ranges

    def spy(*a):
        passes[0] += 1
        pairs[0] += int(a[3].sum())
        return real(*a)
    with patched(grid_mod, "nearest_in_ranges", spy), \
            patched(kd_mod, "nearest_in_ranges", spy), \
            patched(bvh_mod, "nearest_in_ranges", spy):
        call()
    r = dict(phase="walk", set=label, accel=type(scene.accel).__name__,
             mode="any" if any_hit else "nearest", rays=rays.shape[1],
             hits=int(hit.sum()), ms=sorted(walls)[reps // 2] * 1e3,
             passes=passes[0], pairs=pairs[0],
             pairs_per_ray=pairs[0] / rays.shape[1])
    emit(**r)
    return r


def rocks_scenes(text):
    """The rocks scene as parsed (instanced), and the same scene with every
    instance's prototype added to the main mesh under its o2w through
    SceneBuilder.add_trianglemesh (duplicated). Returns (instanced,
    duplicated, opts)."""
    from tpuprt_torch.scene.parser import PbrtParser
    p = PbrtParser()
    p.parse_string(text)
    inst, opts = p.finish()
    b = p.builder
    for proto_id, o2w in b.instances:
        pr = b.protos[proto_id]
        b.add_trianglemesh(o2w, pr["idx"], pr["verts"], N=pr["normals"],
                           uv=pr["uv"], material=pr["material"],
                           reverse_orientation=pr["flip"] < 0)
    b.protos, b.instances = [], []
    dup, _ = p.finish()
    return inst, dup, opts


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


def render_path(label, scene, opts, device, need, exr=None, alpha=None):
    """One main-path run: counts set to 0, render, counts read, image
    written and read back, then a second render timed. Fails unless every
    kernel in `need` launched. Returns (rgb, launches, first_s, wall_s);
    the first render's alpha is appended to the list `alpha` if given."""
    import numpy as np
    from tpuprt_torch import render as R
    from tpuprt_torch.io.exr import read_exr, write_exr
    from tpuprt_torch.ops import bvh_cuda, mt_cuda
    counters = (bvh_cuda.launches, mt_cuda.launches)
    for c in counters:
        for k in c:
            c[k] = 0
    t0 = time.perf_counter()
    rgb, a = R.render(scene, opts, device=device)
    first_s = time.perf_counter() - t0
    launches = {k: v for c in counters for k, v in c.items()}
    if alpha is not None:
        alpha.append(a)
    with tempfile.TemporaryDirectory() as tmp:
        out = exr or os.path.join(tmp, opts.filename)
        write_exr(out, rgb, a)
        back, _ = read_exr(out)
    t0 = time.perf_counter()
    R.render(scene, opts, device=device)
    wall = time.perf_counter() - t0
    missing = [k for k in need if not launches[k]]
    if missing:
        raise AssertionError(f"{label}: the render launched no {missing}")
    if rgb.shape != (opts.yres, opts.xres, 3) or back.shape != rgb.shape \
            or not np.isfinite(rgb).all():
        raise AssertionError(f"{label}: bad image {rgb.shape}")
    return rgb, launches, first_s, wall


def profile_render(label, scene, opts, device, ranges=(), **extra):
    """One more render under torch.profiler: device time by kernel name
    (top 12), each traversal kernel's time, and the device's idle share of
    the render's wall time (one stream, so kernels do not overlap); for
    mt_best, its launches and device ms by mode (its kernels in launch
    order, matched to the wrapper's calls). `ranges`: (name, module,
    function) triples; each function runs inside a record_function range
    of that name, and the line gets the device ms of the torch ops each
    range launched (ranges_ms; None where the trace attributes none).
    Emits and returns that line, with the fields `extra`."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from tpuprt_torch import render as R
    from tpuprt_torch.ops import mt_cuda
    modes = []

    def spy(rays, tris, any_hit=False):
        modes.append("any" if any_hit else "nearest")
        return real(rays, tris, any_hit=any_hit)

    def in_range(name, fn):
        def wrapped(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return wrapped
    torch.cuda.synchronize()
    with contextlib.ExitStack() as stack:
        for name, module, attr in ranges:
            stack.enter_context(patched(module, attr, in_range(
                name, getattr(module, attr))))
        real = stack.enter_context(patched(mt_cuda, "mt_best", spy))
        prof = stack.enter_context(profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        t0 = time.perf_counter()
        R.render(scene, opts, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    names = {r[0] for r in ranges}
    ranges_ms = {name: 0.0 for name in names}
    kernels, mt_events = {}, []
    for ev in prof.events():
        if ev.name in names:
            if ev.device_type == torch.autograd.DeviceType.CPU:
                ranges_ms[ev.name] += ev.device_time_total / 1e3
            continue
        # A record_function range (the renderer's tpuprt/<stage> spans)
        # has a device-typed copy that spans its kernels: not a kernel.
        if getattr(ev, "is_user_annotation", False):
            continue
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.name] = kernels.get(ev.name, 0.0) + \
                ev.time_range.elapsed_us() / 1e3
            if "mt_best_kernel" in ev.name:
                mt_events.append((ev.time_range.start,
                                  ev.time_range.elapsed_us() / 1e3))
    by_mode = None
    if modes and len(mt_events) == len(modes):
        by_mode = {m: {"launches": 0, "ms": 0.0} for m in ("nearest", "any")}
        for m, (_, ms) in zip(modes, sorted(mt_events)):
            by_mode[m]["launches"] += 1
            by_mode[m]["ms"] += ms
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    trav = {name: sum(v for k, v in kernels.items() if name + "_kernel" in k)
            for name in REPLACES}
    r = dict(phase="profile", scene=label, **extra, wall_ms=wall * 1e3,
             device_busy_ms=busy,
             ranges_ms={k: v or None for k, v in ranges_ms.items()},
             ranges_share_of_busy={k: v / max(busy, 1e-9) if v else None
                                   for k, v in ranges_ms.items()},
             device_idle_share=1.0 - busy / (wall * 1e3), traversal_ms=trav,
             traversal_share_of_busy=sum(trav.values()) / max(busy, 1e-9),
             mt_best_by_mode=by_mode, mt_best_calls=len(modes),
             mt_best_kernel_events=len(mt_events),
             n_device_ops=len(kernels), top_ms=[[k[:80], v] for k, v in top])
    emit(**r)
    return r


def fused_visibility(scene, segs, needs):
    """batched_visibility as the port dispatched the segments at commit
    e8747c9, before it followed tpuprt's: every segment of a bounce in one
    launch, nearest if any segment needs it, on every scene. Only for the
    comparison of phase "dispatch"."""
    import torch
    from tpuprt_torch.accel import intersect as isect
    cat = [torch.cat([sg[i] for sg in segs]) for i in range(4)]
    sizes = [sg[0].shape[0] for sg in segs]
    if "nearest" in needs:
        t, pid, hit = isect.intersect_ids(scene, *cat)
        return [(a, b, c) if nd == "nearest" else c for nd, a, b, c in
                zip(needs, t.split(sizes), pid.split(sizes),
                    hit.split(sizes))]
    return list(isect.occluded(scene, *cat).split(sizes))


def rows_gather_photons(grid, q, accum, init):
    """photon_grid.gather_photons as the port first wrote it: each slot
    step gathers whole 12-float rows (grid.packed[idx]). The same
    arithmetic as the shipped column takes; only for phase "lookup"."""
    import numpy as np
    import torch
    from tpuprt_torch.accel import photon_grid as pg
    if grid.count == 0 or grid.bucket_cap == 0:
        return init
    r2 = float(np.float32(grid.radius * grid.radius))
    rad = torch.tensor(grid.radius, dtype=torch.float32, device=q.device)
    base = torch.floor(torch.clamp(torch.nan_to_num(q / rad), -2.0 ** 30,
                                   2.0 ** 30)).to(torch.int64)
    cells = base[:, None, :] + torch.from_numpy(pg._NBR).to(q.device)
    b = pg._cell_hash(cells[..., 0], cells[..., 1], cells[..., 2],
                      grid.n_buckets)
    s_all = grid.start[b].to(torch.int64)
    cnt_all = grid.start[b + 1].to(torch.int64) - s_all
    carry = init
    for j in range(grid.bucket_cap):
        rows = grid.packed[torch.clamp(s_all + j, max=grid.count - 1)]
        dd = rows[..., 0:3] - q[:, None, :]
        d2 = dd[..., 0] * dd[..., 0] + dd[..., 1] * dd[..., 1] + \
            dd[..., 2] * dd[..., 2]
        w = (cnt_all > j) & (d2 < r2)
        carry = accum(carry, rows[..., 3:6], rows[..., 6:9], w)
    return carry


def lookup_turns(label, scene, maps, rays, reps=3):
    """Phase "lookup": lphoton of the three maps at the hit points of a
    final-gather block's rays (a matte BSDF there), with the photons read
    as whole rows (rows_gather_photons) and as the shipped column takes, in
    the turns rows, cols, cols, rows (`timed`: device ms); the estimates
    must be equal."""
    import torch
    from tpuprt_torch.accel import intersect as isect
    from tpuprt_torch.accel import photon_grid as pg
    from tpuprt_torch.integrators import common
    from tpuprt_torch.integrators import photonmap as pm
    o, d = rays[0:3].T.contiguous(), rays[3:6].T.contiguous()
    t, pid, hit = isect.intersect_ids(scene, o, d, rays[6], rays[7])
    dg = isect.hit_geometry(scene, pid, o, d, t)
    bsdf = common.make_bsdf_at(scene, dg)

    def lookups():
        return sum(pm.lphoton(getattr(maps, k), bsdf, -d, dg["p"], hit,
                              may_glossy=False)
                   for k in ("direct", "caustic", "indirect"))
    runs = {"rows": rows_gather_photons, "cols": pg.gather_photons}
    times, out = {k: [] for k in runs}, {}
    for k in ("rows", "cols", "cols", "rows"):
        with patched(pg, "gather_photons", runs[k]), \
                patched(pm, "gather_photons", runs[k]):
            ms, out[k], host_ms = timed(lookups, reps)
        times[k].append(ms)
    equal = bool(torch.equal(out["rows"], out["cols"]))
    emit(phase="lookup", set=label, points=int(o.shape[0]),
         hits=int(hit.sum()), turns=["rows", "cols", "cols", "rows"],
         ms=times, equal=equal)
    if not equal:
        raise AssertionError(f"{label}: the two lookups disagree")


def dispatch_turns(label, scene, opts, device,
                   order=("split", "fused", "fused", "split")):
    """Profiled renders (profile_render) with the visibility segments
    dispatched as the port does (split: without an accelerator, each in its
    own mode) and as fused_visibility, in `order`."""
    from tpuprt_torch.integrators import common
    out = {}
    for k in order:
        with contextlib.ExitStack() as stack:
            if k == "fused":
                stack.enter_context(patched(common, "batched_visibility",
                                            fused_visibility))
            r = profile_render(label, scene, opts, device, dispatch=k)
        out.setdefault(k, []).append({f: r[f] for f in (
            "wall_ms", "device_busy_ms", "device_idle_share",
            "mt_best_by_mode")})
    emit(phase="dispatch", scene=label, order=list(order), runs=out)


def photon_maps(label, scene, prm, seed, out=None):
    """Phase "photons": build_maps on the card (the scene's tables on it),
    with its batches, paths shot, per map the photons kept and stored,
    n_paths, the batch that filled it, buckets and bucket cap, and its
    seconds: shooting (the device's work, its launches and the copy of
    the deposits to the host), the host's collection, and the rest (the
    grids' host build and copy to the card). Returns the maps."""
    import torch
    from tpuprt_torch.integrators import photonmap as pm
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    maps = pm.build_maps(scene, prm, seed, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    shoot, host = sum(stats.pop("shoot_s")), sum(stats.pop("host_s"))
    line = dict(phase="photons", scene=label, wall_s=wall, shoot_s=shoot,
                host_collect_s=host, grid_build_s=wall - shoot - host,
                params=prm._asdict(), **stats)
    emit(**line)
    if out is not None:
        out.update(line)
    return maps


def photon_render(label, path, device, reps=2, ref_exr=None):
    """bench.py's bench_config6 on the card: load_scene -> render (photon
    shooting, the map build, the pool; f16 readback) in one wall. The
    first run is the main path's (the counts 0 before it, read after it;
    its image written and read back; its peak device memory), then the
    best of `reps` more. Fails unless mt_best launched in both modes and
    the image is finite. The band against `ref_exr` is information only.
    Returns the line."""
    import numpy as np
    import torch
    from tpuprt_torch import render as R
    from tpuprt_torch.io.exr import read_exr, write_exr
    from tpuprt_torch.ops import bvh_cuda, mt_cuda
    from tpuprt_torch.scene.parser import load_scene

    def run():
        t0 = time.perf_counter()
        scene, opts = load_scene(path)
        opts = opts._replace(half_readback=True)
        rgb, alpha = R.render(scene, opts, device=device)
        return rgb, alpha, opts, time.perf_counter() - t0
    counters = (bvh_cuda.launches, mt_cuda.launches)
    for c in counters:
        for k in c:
            c[k] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rgb, alpha, opts, first_s = run()
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v for c in counters for k, v in c.items()}
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, opts.filename)
        write_exr(out, rgb, alpha)
        back, _ = read_exr(out)
    wall = min(run()[3] for _ in range(reps))
    if not (launches["mt_best"] and launches["mt_best_any"]):
        raise AssertionError(f"{label}: mt_best did not launch in both "
                             f"modes: {launches}")
    if rgb.shape != (opts.yres, opts.xres, 3) or back.shape != rgb.shape \
            or not np.isfinite(rgb).all():
        raise AssertionError(f"{label}: bad image {rgb.shape}")
    spp = opts.sampler.pixelsamples
    r = dict(phase="render", scene=label, shape=list(rgb.shape), spp=spp,
             photon=opts.photon._asdict(), launches=launches,
             mt_best_nearest=launches["mt_best"] - launches["mt_best_any"],
             mt_best_any=launches["mt_best_any"], finite=True,
             first_wall_s=first_s, wall_s=wall, walls_timed=reps,
             samples_per_s=opts.xres * opts.yres * spp / wall,
             pbrt_wall_s=PBRT_BENCH6_WALL,
             pbrt_wall_over_wall=PBRT_BENCH6_WALL / wall,
             peak_device_bytes=peak)
    if ref_exr:
        rel, mean = band(rgb, read_exr(ref_exr)[0])
        r.update(info_band_ref=os.path.relpath(ref_exr, ROOT),
                 info_band_rel=rel, info_band_mean=mean,
                 info_band_limits_of_golden6=[BAND6_REL, BAND6_MEAN])
    emit(**r)
    return r


def gi_text(name, res=None, spp=None):
    """scenes/<name>.pbrt (configs 7-10, a 64x64 film) with the film at
    res x res and `spp` pixel samples where given."""
    with open(os.path.join(ROOT, "scenes", f"{name}.pbrt")) as f:
        text = f.read()
    film = '"integer xresolution" [64] "integer yresolution" [64]'
    assert film in text
    if res:
        text = text.replace(film, f'"integer xresolution" [{res}] '
                            f'"integer yresolution" [{res}]')
    if spp:
        old = [n for n in (4, 8) if f'"integer pixelsamples" [{n}]' in text]
        text = text.replace(f'"integer pixelsamples" [{old[0]}]',
                            f'"integer pixelsamples" [{spp}]')
    return text


def gi_render(label, text, device, reps, golden=None, limits=None):
    """A chunked-driver render on the card, as bench_config6 times bench6:
    load_scene_string -> render (the preprocess, the chunks; f16 readback)
    in one wall. The first run is the main path's (the counts 0 before it,
    read after it; its image written and read back; its peak device memory;
    its preprocess seconds and stats), then the best of `reps` more. Fails
    unless mt_best launched in both modes, the image is finite and, with
    `golden`, inside `limits` (blurred rel, mean). Returns the line."""
    import numpy as np
    import torch
    from tpuprt_torch import render as R
    from tpuprt_torch.io.exr import read_exr, write_exr
    from tpuprt_torch.ops import bvh_cuda, mt_cuda
    from tpuprt_torch.scene.parser import load_scene_string
    from tpuprt_torch.utils.stats import StatsRegistry

    def run(stats=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scene, opts = load_scene_string(text)
        opts = opts._replace(half_readback=True)
        rgb, alpha = R.render(scene, opts, device=device, stats=stats)
        return rgb, alpha, opts, time.perf_counter() - t0
    counters = (bvh_cuda.launches, mt_cuda.launches)
    for c in counters:
        for k in c:
            c[k] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = StatsRegistry()
    rgb, alpha, opts, first_s = run(stats)
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v for c in counters for k, v in c.items()}
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, opts.filename)
        write_exr(out, rgb, alpha)
        back, _ = read_exr(out)
    walls = [run()[3] for _ in range(reps)]
    if not (launches["mt_best"] > launches["mt_best_any"] > 0):
        raise AssertionError(f"{label}: mt_best did not launch in both "
                             f"modes: {launches}")
    if rgb.shape != (opts.yres, opts.xres, 3) or back.shape != rgb.shape \
            or not np.isfinite(rgb).all():
        raise AssertionError(f"{label}: bad image {rgb.shape}")
    spp = opts.sampler.pixelsamples
    wall = min(walls) if walls else first_s
    r = dict(phase="render", scene=label, integrator=opts.integrator,
             shape=list(rgb.shape), spp=spp, launches=launches,
             mt_best_nearest=launches["mt_best"] - launches["mt_best_any"],
             mt_best_any=launches["mt_best_any"], finite=True,
             first_wall_s=first_s, wall_s=wall, walls_timed=reps,
             samples_per_s=opts.xres * opts.yres * spp / wall,
             preprocess_s=stats.get("Performance", "Preprocess seconds"),
             preprocess={name: v for (cat, name), v in stats.items()
                         if cat == "Preprocess"},
             peak_device_bytes=peak)
    if golden:
        rel, mean = band(rgb, read_exr(golden)[0])
        r.update(band_rel=rel, band_rel_limit=limits[0], band_mean=mean,
                 band_mean_limit=limits[1])
    emit(**r)
    if golden and not (rel < limits[0] and mean < limits[1]):
        raise AssertionError(f"{label}: outside its band: {rel}, {mean}")
    return r


def light_sets(rs, prefix):
    """The kernel line's entries for the parity results whose set starts
    with `prefix`, by set and mode."""
    return {f"{r['set']}, {r['mode']}": {k: r[k] for k in (
        "rays", "ms", "host_ms", "plain_ms", "bound_ms", "bound_by")}
        for r in rs if r["set"].startswith(prefix)}


def gi_sets(device):
    """mt_best's sets from the chunked paths, each captured from one render
    at test_golden's settings (not a main-path run): config8's largest
    shadow block of the virtual lights (any hit), config10's connection
    batch (any hit), config7's largest final-gather ray set (nearest; the
    maps and radiance photons built first, so the shooting is not in it)
    and config9's largest estimate block (nearest). Returns {label:
    (tris, rays, any_hit)}."""
    from tpuprt_torch import render as R
    from tpuprt_torch.ops import mt_cuda
    from tpuprt_torch.scene.data import to_device
    from tpuprt_torch.scene.parser import load_scene_string
    sets = {}
    for name, label, any_hit in (("config8", "config8/vl_shadow", True),
                                 ("config10", "config10/connections", True),
                                 ("config7", "config7/gather", False),
                                 ("config9", "config9/estimate", False)):
        scene, opts = load_scene_string(gi_text(name,
                                                spp=GI_GOLDEN[name][0]))
        scene_d = to_device(scene, device)
        aux = R.preprocess(scene_d, opts) if name == "config7" else None
        got = capture_rays(scene, opts, device, mt_cuda, "mt_best", 0,
                           aux=aux)
        sets[label] = (mt_cuda.pack_table(scene_d.triangles), got[any_hit],
                       any_hit)
    return sets


# The C interfaces of the earlier bvh_tiles.cu and bvh_rows.cu (commit
# 2a258fc: the skip-link walks), as parameter types in order: the sources
# that --old times against the checkout's. A source with another
# interface is refused, never called.
OLD_INTERFACES = {
    "bvh_tiles.cu": {"bvh_tiles_launch": (
        "const float*, const int*, const int*, const float*, int, int, int, "
        "float*, int*, void*")},
    "bvh_rows.cu": {
        "bvh_rows_launch": ("const float*, const float*, int, int, int, "
                            "float*, int*, void*"),
        "bvh_instanced_launch": (
            "const float*, const float*, int, const int*, const int*, "
            "const int*, const int*, const float*, const float*, int, "
            "const float*, int, int, float*, int*, int*, void*")}}


def c_interface(path, name):
    """The parameter types of the C function `name` in the source at
    `path`, as OLD_INTERFACES writes them, or None."""
    import re
    with open(path) as f:
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", f.read())
    return m and ", ".join(" ".join(p.split()[:-1])
                           for p in m.group(1).split(","))


def bind_old(old_dir, src):
    """{name: launch function} of OLD_INTERFACES[src] in old_dir/src, built
    with the port's nvcc flags and bound through ctypes; raises unless
    every one has the listed parameter types."""
    import ctypes
    from tpuprt_torch.ops import bvh_cuda
    path = os.path.join(old_dir, src)
    for name, want in OLD_INTERFACES[src].items():
        got = c_interface(path, name)
        if got != want:
            raise SystemExit(f"{path}: {name}({got}) is not the interface "
                             f"--old knows ({want})")
    return {name: bvh_cuda._bind(path, name, [
        ctypes.c_void_p if t.endswith("*") else ctypes.c_int
        for t in want.split(", ")])
        for name, want in OLD_INTERFACES[src].items()}


def ptxas_report(src):
    """Registers, shared memory and spills of each kernel in `src`."""
    import re
    from tpuprt_torch.ops import bvh_cuda
    cmd = [c for c in bvh_cuda._nvcc_cmd()
           if c not in ("-shared", "-Xcompiler", "-fPIC")]
    r = subprocess.run(cmd + ["-Xptxas", "-v", "-c", "-o", os.devnull, src],
                       capture_output=True, text=True, check=True)
    emit(phase="ptxas", source=os.path.relpath(src, ROOT), report=[
        ln.strip() for ln in r.stderr.splitlines()
        if re.search(r"registers|spill|Compiling entry", ln)])


def turns(new_first=False):
    """The order in which --old runs its two trees: old, new, new, old, or
    with new_first new, old, old, new (a position effect shows as the
    outer or inner turns' lead, whichever tree holds them)."""
    return ["new", "old", "old", "new"] if new_first else \
        ["old", "new", "new", "old"]


def in_turns(label, runs, reps, check, new_first=False):
    """Each zero-argument callable of `runs` {"old": fn, "new": fn} timed
    (`timed`: device ms and the call's host ms) in the order turns().
    `check(last results)` -> {name: agrees}; every one must."""
    import torch
    times, host, last = {k: [] for k in runs}, {k: [] for k in runs}, {}
    for k in turns(new_first):
        ms, last[k], host_ms = timed(runs[k], reps)
        times[k].append(ms)
        host[k].append(host_ms)
    torch.cuda.synchronize()
    agree = check(last)
    emit(phase="ab", set=label, turns=turns(new_first), ms=times,
         host_ms=host, agree=agree)
    if not all(agree.values()):
        raise AssertionError(f"{label}: the trees disagree {agree}")


def ab_main(old_dir, reps=5, renders=2, new_first=False):
    """--old: the earlier tile and row walks (commit 2a258fc, the sources
    in old_dir: skip-link walks) against the checkout's, in one process on
    one card, in the order turns(new_first). Sets, each through both tile walks and both row walks in
    the front end's sorted order: config4_big's camera rays (nearest),
    the 1M terrain's random rays (nearest, NN 164,480) and the
    config4_big render's busiest shadow batch (any hit); t and ids must be
    equal bit for bit. Then renders of config4_big (tile walk),
    config4_big/rows, the rocks and the duplicated rocks with each tree's
    walks in place (the instanced walk too, which shares bvh_rows.cu):
    in the same turns, `renders` timed renders and one under the profiler
    each (host wall, device time of each walk). The old walks are called
    through bare ctypes closures, the new through bvh_cuda's wrappers:
    each set's line gives both calls' host ms."""
    import torch
    from tpuprt_torch import render as R
    from tpuprt_torch.ops import bvh_cuda
    from tpuprt_torch.scene.data import to_device
    from tpuprt_torch.scene.parser import load_scene
    device = "cuda"
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as ex:
        old = [ex.submit(bind_old, old_dir, s)
               for s in ("bvh_tiles.cu", "bvh_rows.cu")]
        new = [ex.submit(bvh_cuda.build, s)
               for s in (bvh_cuda.KERNEL_SRC, bvh_cuda.ROWS_SRC)]
        old_fns = {k: v for f in old for k, v in f.result().items()}
        for f in new:
            f.result()
    emit(phase="build", old=old_dir, seconds=time.perf_counter() - t0)
    for src in (os.path.join(old_dir, "bvh_tiles.cu"),
                os.path.join(old_dir, "bvh_rows.cu"), bvh_cuda.KERNEL_SRC,
                bvh_cuda.ROWS_SRC):
        ptxas_report(src)

    def outputs(n, k=2):
        return [torch.empty(n, dtype=dt, device=device)
                for dt in (torch.float32, torch.int32, torch.int32)[:k]]

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def old_tiles(nodesT, nodeskip, nodemeta, child, rays, *, nn,
                  any_hit=False):
        out = outputs(rays.shape[1])
        assert old_fns["bvh_tiles_launch"](
            nodesT.data_ptr(), nodeskip.data_ptr(), nodemeta.data_ptr(),
            rays.data_ptr(), rays.shape[1], nn, int(any_hit),
            *(x.data_ptr() for x in out), stream()) == 0
        return tuple(out)

    def old_rows(nodes, rays, *, nn, max_depth, any_hit=False):
        out = outputs(rays.shape[1])
        assert old_fns["bvh_rows_launch"](
            nodes.data_ptr(), rays.data_ptr(), rays.shape[1], nn,
            int(any_hit), *(x.data_ptr() for x in out), stream()) == 0
        return tuple(out)

    def old_instanced(nodes, e_block, e_inst, e_start, e_stop, e_bbox, w2o12,
                      rays, *, cap, top, any_hit=False):
        out = outputs(rays.shape[1], 3)
        assert old_fns["bvh_instanced_launch"](
            nodes.data_ptr(), top.data_ptr(), top.shape[0],
            e_block.data_ptr(), e_inst.data_ptr(), e_start.data_ptr(),
            e_stop.data_ptr(), e_bbox.data_ptr(), w2o12.data_ptr(), cap,
            rays.data_ptr(), rays.shape[1], int(any_hit),
            *(x.data_ptr() for x in out), stream()) == 0
        return tuple(out)

    def same(res):
        ref = res["old"]
        return {k: all(bool(torch.equal(a, b)) for a, b in zip(ref, r))
                for k, r in res.items()}

    scene, opts = load_scene(SCENE)
    opts = opts._replace(chunk_size=1 << 17, half_readback=True)
    scene_d = to_device(scene, device)
    big = to_device(config5_huge()[0], device)
    shadow = capture_rays(scene, opts, device, bvh_cuda, "traverse_tiles",
                          4)[True]
    for label, bvh, rays, any_hit in (
            ("config4_big/camera", scene_d.accel,
             sort_packed(scene_d.accel, camera_rays(scene_d, opts, device)),
             False),
            (f"terrain{SCALE_TERRAIN_N}/random", big.accel,
             sort_packed(big.accel, torch.from_numpy(
                 random_rays(1 << 16, 2)).to(device)), False),
            (f"config4_big/shadow ({shadow.shape[1]} rays, "
             f"{int((shadow[6] <= shadow[7]).sum())} live)", scene_d.accel,
             shadow, True)):
        mode = "any" if any_hit else "nearest"
        tiles = (bvh.nodesT, bvh.nodeskip, bvh.nodemeta, bvh.child, rays)
        in_turns(f"bvh_tiles {label}, {mode}", {
            "old": lambda: old_tiles(*tiles, nn=bvh.n_nodes,
                                     any_hit=any_hit),
            "new": lambda: bvh_cuda.traverse_tiles(*tiles, nn=bvh.n_nodes,
                                                   any_hit=any_hit)},
            reps, same, new_first)
        kw = dict(nn=bvh.n_nodes, max_depth=bvh.max_depth, any_hit=any_hit)
        in_turns(f"bvh_rows {label}, {mode}", {
            "old": lambda: old_rows(bvh.nodes, rays, **kw),
            "new": lambda: bvh_cuda.traverse_rows(bvh.nodes, rays, **kw)},
            reps, same, new_first)
    del scene_d, big, shadow

    # Renders with each tree's walks in place, in the same turns.
    with open(SCENE) as f:
        rocks, dup, ropts = rocks_scenes(rocks_scene_text(
            f.read(), N_ROCKS, ROCK_SUBDIV, ROCK_SEED))
    ropts = ropts._replace(chunk_size=1 << 17, half_readback=True)
    rows_scene = dataclasses.replace(scene, accel=dataclasses.replace(
        scene.accel, nodesT=None, nodeskip=None, nodemeta=None))
    variants = {"old": [(bvh_cuda, "traverse_tiles", old_tiles),
                        (bvh_cuda, "traverse_rows", old_rows),
                        (bvh_cuda, "traverse_instanced", old_instanced)],
                "new": []}
    walks = ("bvh_tiles", "bvh_rows", "bvh_instanced")
    for label, sc, op in (("config4_big", scene, opts),
                          ("config4_big/rows", rows_scene, opts),
                          (f"rocks({N_ROCKS})", rocks, ropts),
                          ("rocks/duplicated", dup, ropts)):
        walls = {k: [] for k in variants}
        device_ms = {k: [] for k in variants}
        for v in turns(new_first):
            with contextlib.ExitStack() as stack:
                for p in variants[v]:
                    stack.enter_context(patched(*p))
                for _ in range(renders):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    R.render(sc, op, device=device)
                    walls[v].append(time.perf_counter() - t0)
                prof = profile_render(label, sc, op, device, tree=v)
            device_ms[v].append({k: prof["traversal_ms"][k] for k in walks
                                 if prof["traversal_ms"][k]})
        emit(phase="ab_render", scene=label, turns=turns(new_first),
             walls_s=walls, walk_device_ms=device_ms)


def light_phases(device, launches, res, rgb_b3, photons6, profile=False):
    """Phases 26-28 (the lights and textures), their launches into
    `launches`, their parity results into `res`. rgb_b3: phase 13's bench3
    image; photons6: phase 19's bench6 photon line."""
    import numpy as np
    import torch
    from tpuprt_torch import render as R
    from tpuprt_torch.ops import bvh_cuda, mt_cuda
    from tpuprt_torch.scene.data import to_device
    from tpuprt_torch.scene.parser import load_scene, load_scene_string
    # 26. Main path, every light and texture: config4_big lit (LIT_LIGHTS)
    # at 512x512 x 4 spp through the tile walk, its maps written beside the
    # scene text and named relative to it; the wall best of 2, the peak
    # device memory. Then the sky alone under "infinite" and under
    # "infinitesample", which estimate the same image, held to each other.
    with tempfile.TemporaryDirectory() as lit_dir:
        t0 = time.perf_counter()
        write_lit_maps(lit_dir)
        maps_s = time.perf_counter() - t0
        with open(SCENE) as f:
            base_text = f.read()
        paths = {}
        for kind in ("lit", "infinite", "infinitesample"):
            paths[kind] = os.path.join(lit_dir, f"config4_big_{kind}.pbrt")
            with open(paths[kind], "w") as f:
                f.write(lit_text(base_text, kind))
        t0 = time.perf_counter()
        lit, lit_opts = load_scene(paths["lit"])
        im = lit.images
        emit(phase="load", scene="config4_big/lit",
             seconds=time.perf_counter() - t0, write_maps_s=maps_s,
             triangles=lit.triangles.count, lights=list(
                 lit.lights.kinds_list), texture_nodes=len(
                 lit.textures.nodes), bump=lit.materials.has_bump,
             images=[[int(im.level_h[i, 0]), int(im.level_w[i, 0]),
                      im.nlevels[i]] for i in range(im.count)],
             image_bytes=im.texels.numel() * 4,
             env_dist_bytes=sum(4 * (e.cdf_v.numel() + e.func_v.numel())
                                for e in lit.env_importance))
        assert lit.triangles.count == 99458 + 2 * PATCH_QUADS ** 2
        lit_opts = lit_opts._replace(chunk_size=1 << 17, half_readback=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rgb, launches["config4_big/lit"], first_s, wall = render_path(
            "config4_big/lit", lit, lit_opts, device, ["bvh_tiles"])
        peak = torch.cuda.max_memory_allocated()
        walls = [wall]
        t0 = time.perf_counter()
        R.render(lit, lit_opts, device=device)
        walls.append(time.perf_counter() - t0)
        emit(phase="render", scene="config4_big/lit", shape=list(rgb.shape),
             spp=lit_opts.sampler.pixelsamples,
             launches=launches["config4_big/lit"], finite=True,
             first_render_s=first_s, wall_s=min(walls), walls_s=walls,
             samples_per_s=lit_opts.xres * lit_opts.yres *
             lit_opts.sampler.pixelsamples / min(walls),
             peak_device_bytes=peak, mean=float(rgb.mean()))
        if profile:
            profile_render("config4_big/lit", lit, lit_opts, device)
        # The tile walk on this scene's BVH: its camera rays in the front
        # end's order, and the render's largest call, a pass's fused
        # visibility batch (each light's shadow segment and the area and
        # sky lights' BSDF-strategy rays, 7 x 2^17 lanes, traced nearest).
        lit_d = to_device(lit, device)
        vis = capture_rays(lit, lit_opts, device, bvh_cuda,
                           "traverse_tiles", 4)[False]
        for label, rays in (
                ("camera", sort_packed(lit_d.accel, camera_rays(
                    lit_d, lit_opts, device))),
                ("visibility", vis)):
            res["bvh_tiles"] += tiles_parity(f"config4_big/lit/{label}",
                                             lit_d.accel, rays, reps=3)
        del lit, lit_d, vis
        # The shading layer on two devices: the same code at a small film
        # on the CPU and on the card, f32 readback on both.
        small = os.path.join(lit_dir, "config4_big_lit_small.pbrt")
        with open(small, "w") as f:
            f.write(lit_text(base_text, "lit", res=DEV_RES, spp=1))
        sc, so = load_scene(small)
        so = so._replace(half_readback=False)
        t0 = time.perf_counter()
        cpu_rgb, cpu_alpha = R.render(sc, so, device="cpu")
        cpu_s = time.perf_counter() - t0
        gpu_rgb, gpu_alpha = R.render(sc, so, device=device)
        near = np.isclose(gpu_rgb, cpu_rgb, atol=DEV_TOL,
                          rtol=DEV_TOL).all(-1)
        emit(phase="devices", scene="config4_big/lit",
             shape=list(gpu_rgb.shape), spp=1, cpu_s=cpu_s,
             share_close=float(near.mean()), share_limit=DEV_SHARE,
             tol=DEV_TOL, max_abs_diff=float(np.abs(gpu_rgb - cpu_rgb).max()),
             alpha_equal=bool(np.array_equal(gpu_alpha, cpu_alpha)),
             mean_cpu=float(cpu_rgb.mean()), mean_card=float(gpu_rgb.mean()))
        assert np.isfinite(gpu_rgb).all() and cpu_rgb.mean() > 0.01
        assert np.array_equal(gpu_alpha, cpu_alpha)
        assert near.mean() >= DEV_SHARE, near.mean()
        del sc, cpu_rgb, gpu_rgb
        env = {}
        for kind in ("infinite", "infinitesample"):
            sc, so = load_scene(paths[kind])
            so = so._replace(chunk_size=1 << 17, half_readback=True)
            env[kind], launches[f"config4_big/{kind}"], env_first, \
                env_wall = render_path(f"config4_big/{kind}", sc, so,
                                       device, ["bvh_tiles"])
        rel, mean = band(env["infinite"], env["infinitesample"])
        emit(phase="render", scene="config4_big/sky", spp=ENV_SPP,
             shape=list(env["infinite"].shape), finite=True,
             pair=["infinite", "infinitesample"], band_rel=rel,
             band_rel_limit=ENV_BAND_REL, band_mean=mean,
             band_mean_limit=ENV_BAND_MEAN, wall_s=env_wall,
             launches={k: launches[f"config4_big/{k}"]["bvh_tiles"]
                       for k in env})
        assert rel <= ENV_BAND_REL and mean <= ENV_BAND_MEAN, (rel, mean)
        del env

    # 27. Main path, a triangle-mesh emitter in path mode: bench3 with its
    # disk light as a 48-triangle fan and Accelerator "none" (60 prims, all
    # through mt_best) at 256x256 x 32 spp, held to phase 13's bench3.
    with open(BENCH3) as f:
        m3, m3_opts = load_scene_string(meshlight_text(f.read()))
    assert m3.accel is None and m3.triangles.count == 10 + FAN_TRIS
    m3_opts = m3_opts._replace(chunk_size=1 << 17, half_readback=True)
    rgb, launches["bench3/meshlight"], first_s, wall = render_path(
        "bench3/meshlight", m3, m3_opts, device, ["mt_best", "mt_best_any"])
    rel, mean = band(rgb, rgb_b3)
    emit(phase="render", scene="bench3/meshlight", shape=list(rgb.shape),
         spp=m3_opts.sampler.pixelsamples, triangles=m3.triangles.count,
         launches=launches["bench3/meshlight"], finite=True,
         against="bench3", band_rel=rel, band_rel_limit=MESH3_BAND_REL,
         band_mean=mean, band_mean_limit=MESH3_BAND_MEAN,
         first_render_s=first_s, wall_s=wall,
         samples_per_s=m3_opts.xres * m3_opts.yres *
         m3_opts.sampler.pixelsamples / wall)
    assert rel <= MESH3_BAND_REL and mean <= MESH3_BAND_MEAN, (rel, mean)
    # mt_best on the fan's sets: the camera rays, and the pass (three
    # calls: the bounce, its shadow rays, its BSDF-strategy rays) with the
    # most live shadow rays, as phase 11 takes bench3's.
    m3_d = to_device(m3, device)
    m3_tris = mt_cuda.pack_table(m3_d.triangles)
    res["mt_best"] += mt_parity("bench3/meshlight/camera", m3_tris,
                                camera_rays(m3_d, m3_opts, device),
                                modes=(False,))
    first = capture_rays(m3, m3_opts, device, mt_cuda, "mt_best", 0,
                         period=3)
    res["mt_best"] += mt_parity("bench3/meshlight/shadow", m3_tris,
                                first[(1, True)], modes=(True,))
    res["mt_best"] += mt_parity("bench3/meshlight/bsdf", m3_tris,
                                first[(2, False)], modes=(False,))
    del m3, m3_d, first

    # 28. Photon emission from triangles: bench6 with the same fan and
    # Accelerator "none", its maps built on the card (counts beside
    # bench6's of phase 19), then load -> maps -> render at 256x256 x 4
    # spp as bench_config6 times bench6.
    with open(BENCH6) as f:
        m6_text = meshlight_text(f.read())
    with tempfile.TemporaryDirectory() as d6:
        m6_path = os.path.join(d6, "bench6_meshlight.pbrt")
        with open(m6_path, "w") as f:
            f.write(m6_text)
        m6, m6_opts = load_scene(m6_path)
        assert m6.accel is None and m6.triangles.count == 10 + FAN_TRIS
        photons_m6 = {}
        photon_maps("bench6/meshlight", to_device(m6, device), m6_opts.photon,
                    m6_opts.seed, photons_m6)
        emit(phase="photons", scene="bench6/meshlight", beside="bench6",
             **{k: {label: {c: st[k][c] for c in ("photons", "stored",
                                                  "n_paths")}
                    for label, st in (("bench6", photons6),
                                      ("bench6/meshlight", photons_m6))}
                for k in ("caustic", "direct", "indirect")},
             paths_shot={"bench6": photons6["paths_shot"],
                         "bench6/meshlight": photons_m6["paths_shot"]})
        r = photon_render("bench6/meshlight", m6_path, device)
        launches["bench6/meshlight"] = r["launches"]
        del m6



def film_text(text, res=None, spp=None):
    """A scene file's text with its film at res x res (from config4_big's
    512 or bench3's 256) and `spp` pixel samples (from 4 or 32): the
    camera's raster transform is built from the text."""
    import re
    if res:
        text = re.sub(r'"integer xresolution" \[\d+\] "integer '
                      r'yresolution" \[\d+\]', f'"integer xresolution" '
                      f'[{res}] "integer yresolution" [{res}]', text, 1)
    if spp:
        text = re.sub(r'"integer pixelsamples" \[\d+\]',
                      f'"integer pixelsamples" [{spp}]', text, 1)
    return text


def counted(device, fn):
    """fn() with every kernel count set to 0 before and read after, the
    host wall (synchronized on the card) and the peak device memory:
    (result, launches, wall_s, peak_bytes or None)."""
    import torch
    from tpuprt_torch.ops import bvh_cuda, mt_cuda
    cuda = torch.device(device).type == "cuda"
    for c in (bvh_cuda.launches, mt_cuda.launches):
        for k in c:
            c[k] = 0
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {**bvh_cuda.launches, **mt_cuda.launches}
    return out, counts, wall, (torch.cuda.max_memory_allocated()
                               if cuda else None)


def unlaunched(device, counts, need):
    """The kernels of `need` that counts show unlaunched: on the card
    those with a count of 0; none on the CPU, where the wrappers run the
    plain versions (a rehearsal at a small size)."""
    import torch
    if torch.device(device).type != "cuda":
        return []
    return [k for k in need if not counts[k]]


def scan_render(label, scene, opts, device, need, **kw):
    """One render through render() under counted(): (rgb, alpha, line),
    failing unless every kernel in `need` launched."""
    import numpy as np
    from tpuprt_torch import render as R
    from tpuprt_torch.utils.stats import StatsRegistry
    stats = StatsRegistry()
    (rgb, alpha), counts, wall, peak = counted(device, lambda: R.render(
        scene, opts, device=device, stats=stats, **kw))
    missing = unlaunched(device, counts, need)
    if missing or not np.isfinite(rgb).all():
        raise AssertionError(f"{label}: launched no {missing} or not "
                             "finite")
    return rgb, alpha, dict(scene=label, driver=opts.driver, wall_s=wall,
                            chunks=stats.get("Film", "Wavefront chunks"),
                            chunk_lanes=stats.get("Film", "Chunk lanes"),
                            launches=counts, peak_device_bytes=peak)


def images_close(label, a, b, rgb_tol, alpha_tol):
    """Two renders (rgb, alpha) held per pixel: rgb within atol = rtol =
    rgb_tol, alpha within alpha_tol. Returns the largest differences."""
    import numpy as np
    np.testing.assert_allclose(a[0], b[0], atol=rgb_tol, rtol=rgb_tol,
                               err_msg=label)
    np.testing.assert_allclose(a[1], b[1], atol=alpha_tol, err_msg=label)
    return dict(rgb_max_abs_diff=float(np.abs(a[0] - b[0]).max()),
                alpha_max_abs_diff=float(np.abs(a[1] - b[1]).max()))


def scan_phase(device, launches, res4=None, res3=None, spp3=None):
    """Phase 29: the scan driver on the card against the pool, the
    strategies "one" and "weighted", checkpoint and resume. res4, res3,
    spp3 shrink the films for a rehearsal on the CPU."""
    from tpuprt_torch.io.exr import read_exr
    from tpuprt_torch.scene.parser import load_scene_string
    with open(SCENE) as f:
        c4, o4 = load_scene_string(film_text(f.read(), res4))
    # The pool's lane count, as phases 4 and 13 render; the scan chunks by
    # free memory (render.chunk_lanes) unless a checkpoint is asked for.
    o4 = o4._replace(chunk_size=1 << 17)
    ref4 = read_exr(GOLDEN)[0]
    for strategy in ("all", "one", "weighted"):
        o = o4._replace(direct_strategy=strategy)
        pool = scan_render(f"config4_big/{strategy}", c4, o._replace(
            driver="wavefront"), device, ["bvh_tiles"])
        scan = scan_render(f"config4_big/{strategy}", c4, o._replace(
            driver="scan"), device, ["bvh_tiles"])
        diff = images_close(f"config4_big/{strategy}", scan[:2], pool[:2],
                            SCAN_TOL, SCAN_ALPHA_TOL)
        if strategy == "all":
            launches["config4_big/scan"] = scan[2]["launches"]
        band_rel, band_mean = band(scan[0], ref4) if res4 is None \
            else (None, None)
        emit(phase="scan", strategy=strategy, scan=scan[2], pool=pool[2],
             tol=SCAN_TOL, alpha_tol=SCAN_ALPHA_TOL, band_rel_info=band_rel,
             band_mean_info=band_mean, **diff)
    # Checkpoint and resume: the film in 8 chunks (2^17 samples at full
    # size), the partial image and the checkpoint after 4, then the last 4
    # from the checkpoint.
    chunk = o4.xres * o4.yres * o4.sampler.pixelsamples // 8
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "film.npz")
        o = o4._replace(driver="scan", chunk_size=chunk,
                        writefrequency=4 * chunk,
                        filename=os.path.join(tmp, "partial.exr"))
        straight = scan_render("config4_big/checkpoint", c4, o, device,
                               ["bvh_tiles"], checkpoint_path=ck)
        assert os.path.exists(o.filename) and os.path.exists(ck)
        resumed = scan_render("config4_big/resumed", c4, o, device,
                              ["bvh_tiles"], checkpoint_path=ck,
                              resume=True)
    assert (straight[2]["chunks"], resumed[2]["chunks"]) == (8, 4)
    diff = images_close("config4_big/resumed", resumed[:2], straight[:2],
                        RESUME_TOL, RESUME_TOL)
    emit(phase="scan", check="checkpoint_resume", straight=straight[2],
         resumed=resumed[2], tol=RESUME_TOL, **diff)
    # bench3 in path mode at its full size, pool and scan.
    with open(BENCH3) as f:
        b3, o3 = load_scene_string(film_text(f.read(), res3, spp3))
    o3 = o3._replace(chunk_size=1 << 17)     # the pool's, as above
    pool = scan_render("bench3", b3, o3._replace(driver="wavefront"),
                       device, ["mt_best", "mt_best_any"])
    scan = scan_render("bench3", b3, o3._replace(driver="scan"), device,
                       ["mt_best", "mt_best_any"])
    diff = images_close("bench3", scan[:2], pool[:2], SCAN_TOL,
                        SCAN_ALPHA_TOL)
    launches["bench3/scan"] = scan[2]["launches"]
    emit(phase="scan", scan=scan[2], pool=pool[2], tol=SCAN_TOL,
         alpha_tol=SCAN_ALPHA_TOL, **diff)


def plain_route(name):
    """A stand-in for the kernel wrapper bvh_cuda.traverse_tiles or
    mt_cuda.mt_best that runs its plain version on the same tensors (on
    the card, too), as a NonDiff call: the gradient's plain route."""
    from tpuprt_torch.ops import bvh_cuda, mt_cuda
    if name == "bvh_tiles":
        def tiles(nodesT, nodeskip, nodemeta, child, rays, *, nn,
                  any_hit=False):
            return bvh_cuda.traverse_tiles_ref(nodesT, nodeskip, nodemeta,
                                               rays, nn=nn, any_hit=any_hit)
        return bvh_cuda, "traverse_tiles", bvh_cuda.nondiff(tiles)
    return mt_cuda, "mt_best", bvh_cuda.nondiff(mt_cuda.mt_best_ref)


def grad_checks(label, name, device, loss_of, params, fd_cases, fd_tol,
                adam_params, launches):
    """The checks of phases 30 and 31 on loss_of(*params) (render_loss_fn
    of a scene made from the parameter tensors; with f64=True the
    per-sample losses summed in float64 instead of the f32 mean), at
    `params`: the gradients through the kernel `name` and through its
    plain version, within ROUTE_RTOL of each other; autograd against a
    central difference of the float64 sum at each (parameter, index, eps)
    of fd_cases, within fd_tol; every gradient finite. Then ADAM_STEPS of
    torch.optim.Adam at ADAM_LR over the parameters adam_params names,
    from `params`: the last loss below half the first."""
    import torch
    params = [p.detach().clone() for p in params]

    def grads():
        ps = [p.clone().requires_grad_(True) for p in params]
        loss = loss_of(*ps)
        return loss.item(), torch.autograd.grad(loss, ps)
    (loss0, g_kernel), counts, grad_s, _ = counted(device, grads)
    if unlaunched(device, counts, [name]):
        raise AssertionError(f"{label}: the gradient launched no {name}")
    with patched(*plain_route(name)):
        _, g_plain = grads()
    route = []
    for gk, gp in zip(g_kernel, g_plain):
        if not (torch.isfinite(gk).all() and torch.isfinite(gp).all()):
            raise AssertionError(f"{label}: a gradient is not finite")
        err = float((gk - gp).abs().max())
        scale = float(gp.abs().max())
        route.append(dict(max_abs_diff=err, max_abs=scale))
        assert err <= ROUTE_RTOL * scale, (label, err, scale)
    fd = []
    with torch.no_grad():
        for i, idx, eps in fd_cases:
            def at(delta):
                ps = [p.clone() for p in params]
                ps[i][idx] += delta
                return float(loss_of(*ps, f64=True))
            num = (at(eps) - at(-eps)) / (2 * eps)
            g = float(g_kernel[i][idx])
            fd.append(dict(param=i, index=list(idx), eps=eps, autograd=g,
                           fd=num, rel=abs(g - num) / abs(num)))
            assert abs(g - num) <= fd_tol * abs(num), (label, g, num)

    def adam():
        ps = [p.clone().requires_grad_(i in adam_params)
              for i, p in enumerate(params)]
        opt = torch.optim.Adam([ps[i] for i in adam_params], lr=ADAM_LR)
        losses = []
        for _ in range(ADAM_STEPS):
            opt.zero_grad()
            loss = loss_of(*ps)
            loss.backward()
            opt.step()
            losses.append(loss.item())
        return losses
    losses, counts, adam_s, peak = counted(device, adam)
    if unlaunched(device, counts, [name]):
        raise AssertionError(f"{label}: Adam launched no {name}")
    assert losses[-1] < 0.5 * losses[0], (label, losses)
    launches[f"grad/{label}"] = counts
    emit(phase="grad", scene=label, loss=loss0, grad_s=grad_s,
         route=route, route_rtol=ROUTE_RTOL, fd=fd, fd_tol=fd_tol,
         adam_losses=losses, s_per_step=adam_s / ADAM_STEPS,
         peak_device_bytes=peak, launches_per_step={
             k: v / ADAM_STEPS for k, v in counts.items() if v})
    return g_kernel


def loss_ids(opts, device):
    """Every pixel's sample 0, as render_loss_fn takes them."""
    import torch
    lin = torch.arange(opts.xres * opts.yres, device=device)
    return ((lin % opts.xres).to(torch.int32),
            (lin // opts.xres).to(torch.int32),
            torch.zeros_like(lin, dtype=torch.int32))


def loss_fn(scene, opts, target, make):
    """loss_of(*params) for grad_checks: render_loss_fn of make(*params)
    over every pixel at 1 spp, or with f64 the per-sample losses summed in
    float64 over their count."""
    from tpuprt_torch.parallel import shard
    ids = loss_ids(opts, target.device)

    def loss_of(*ps, f64=False):
        sc = make(*ps)
        if f64:
            e = shard.sample_losses(sc, opts, *ids, target,
                                    device=target.device)
            return e.double().sum() / e.numel()
        return shard.render_loss_fn(sc, opts, *ids, target,
                                    device=target.device)
    return loss_of


def grad_phases(device, launches, res4=None, res3=None):
    """Phases 30 and 31: gradients of render_loss_fn on the card, on
    config4_big (the tile walk) and bench3 (mt_best, path mode). res4 and
    res3 shrink the films for a rehearsal on the CPU."""
    import torch
    from tpuprt_torch import render as R
    from tpuprt_torch.scene.data import LIGHT_DISTANT
    from tpuprt_torch.scene.parser import load_scene_string
    # 30. config4_big at 1 spp: the checkerboard's two colours, the
    # distant light's L, a translation of the terrain's vertices; the
    # target the scan render at the file's values; everything taken from
    # the colours at half.
    with open(SCENE) as f:
        c4, o4 = load_scene_string(film_text(f.read(), res4, 1))
    o4 = o4._replace(driver="scan")
    target = torch.from_numpy(R.render(c4, o4, device=device)[0]).to(device)
    sc = R.on_device(c4, device)
    nodes = sc.textures.nodes
    kids = list(next(m for m in nodes if m.kind == "checkerboard2d")
                .children)
    distant = sc.lights.kinds_list.index(LIGHT_DISTANT)
    cols = torch.arange(3, device=device)
    kid_rows = torch.tensor(kids, device=device)[:, None]

    def c4_scene(colours, light_L, shift):
        fp = sc.textures.fparams.clone()
        fp[kid_rows, cols[None]] = colours
        spec = sc.lights.spectrum.clone()
        spec[distant] = light_L
        return dataclasses.replace(
            sc, textures=dataclasses.replace(sc.textures, fparams=fp),
            lights=dataclasses.replace(sc.lights, spectrum=spec),
            triangles=dataclasses.replace(
                sc.triangles, verts=sc.triangles.verts + shift))
    colours = sc.textures.fparams[kid_rows, cols[None]]
    start = [0.5 * colours, sc.lights.spectrum[distant].clone(),
             torch.zeros_like(sc.triangles.verts)]
    g = grad_checks("config4_big", "bvh_tiles", device,
                    loss_fn(sc, o4, target, c4_scene), start,
                    [(0, (0, 0), FD4_EPS), (1, (0,), FD4_EPS)], FD4_TOL,
                    (0,), launches)
    assert float(g[2].abs().max()) > 0, "the translation has no gradient"
    # 31. bench3 at 1 spp, path mode: the red wall's Kd from BENCH3_KD0.
    with open(BENCH3) as f:
        b3, o3 = load_scene_string(film_text(f.read(), res3, 1))
    o3 = o3._replace(driver="scan")
    target = torch.from_numpy(R.render(b3, o3, device=device)[0]).to(device)
    sc3 = R.on_device(b3, device)
    fp3 = sc3.textures.fparams
    row = int(torch.nonzero((fp3[:, 0:3] == torch.tensor(
        BENCH3_KD, device=device)).all(1))[0, 0])

    def b3_scene(kd):
        fp = fp3.clone()
        fp[row, 0:3] = kd
        return dataclasses.replace(sc3, textures=dataclasses.replace(
            sc3.textures, fparams=fp))
    grad_checks("bench3", "mt_best", device, loss_fn(sc3, o3, target,
                                                     b3_scene),
                [torch.tensor(BENCH3_KD0, device=device)],
                [(0, (0,), FD3_EPS)], FD3_TOL, (0,), launches)



def fd_case(name, device, res):
    """tests/test_grad.py's finite-difference scene `name` at res x res:
    (scene on `device`, opts, sample ids, moved(scene, cx), the target's
    cx, its BOUNDARY_FD row). Built with the port's builder, as the test
    builds tpuprt's."""
    import numpy as np
    import torch
    from tpuprt_torch import render as R
    from tpuprt_torch.cameras import cameras as cam
    from tpuprt_torch.core import transform as tf
    from tpuprt_torch.samplers.samplers import SamplerConfig
    from tpuprt_torch.scene.build import SceneBuilder
    terms, spp, cx_t, n_edge, seed, eps, tol = BOUNDARY_FD[name]
    b = SceneBuilder()
    dark = b.matte(kd=(0.0, 0.0, 0.0))
    rows = None
    if name == "occluder":
        # A black quad tilted 15 degrees in its plane (test_grad.py:137).
        c, s = np.cos(0.26), np.sin(0.26)
        sq = np.asarray([[-0.6, -0.6], [0.6, -0.6], [0.6, 0.6],
                         [-0.6, 0.6]], np.float32) @ np.asarray(
                             [[c, s], [-s, c]], np.float32)
        b.add_trianglemesh(np.eye(4), [[0, 1, 2], [0, 2, 3]],
                           np.concatenate([sq, np.ones((4, 1), np.float32)],
                                          axis=1), material=dark)
    elif name == "sphere_rim":
        b.add_sphere(np.eye(4), 0.8, material=dark)
        rows = "sphere"
    else:
        fl, grey = b.matte(kd=(0.7, 0.7, 0.7)), b.matte(kd=(0.2, 0.2, 0.2))
        b.add_trianglemesh(np.eye(4), [[0, 1, 2], [0, 2, 3]], np.asarray(
            [[-3, 0, -3], [3, 0, -3], [3, 0, 3], [-3, 0, 3]], np.float32),
            material=fl)
        b.add_trianglemesh(np.eye(4), [[0, 1, 2], [0, 2, 3]], np.asarray(
            [[-0.5, 1.5, -0.5], [0.5, 1.5, -0.5], [0.5, 1.5, 0.5],
             [-0.5, 1.5, 0.5]], np.float32), material=grey)
        rows = [4, 5, 6, 7]
        if name == "point_shadow":
            b.add_point_light(tf.translate([0.0, 4.0, 0.0]), (25.0,) * 3)
        elif name == "distant_shadow":
            # Its shadow rays end at |light origin - p| (lights.py), so the
            # origin sits beyond the occluder.
            b.add_distant_light(tf.translate([0.0, 10.0, 0.0]), (3.0,) * 3,
                                frm=(0.3, 4.0, 0.2), to=(0.0, 0.0, 0.0))
        else:
            lid = b.add_trianglemesh(np.eye(4), [[0, 1, 2], [0, 2, 3]],
                                     np.asarray([[-0.6, 4, -0.6],
                                                 [0.6, 4, -0.6],
                                                 [0.6, 4, 0.6],
                                                 [-0.6, 4, 0.6]],
                                                np.float32), material=grey)
            b.add_area_light_mesh(lid, L=(14.0,) * 3)
    if rows is None or rows == "sphere":
        b.add_infinite_light(np.eye(4), L=(1.0, 1.0, 1.0))
        eye, at, fov = [0, 0, -4], [0, 0, 0], 45.0
    else:
        eye, at, fov = [0, 0.8, -2.8], [0, 0, 0.3], 32.0
    b.set_camera(cam.build_projective(
        0, tf.look_at(eye, at, [0, 1, 0]), tf.perspective(fov, 1e-2, 100.0),
        cam.default_screen_window(res, res), res, res))
    scene = R.on_device(b.build(), device)
    sampler = SamplerConfig(kind="stratified", xsamples=1, ysamples=1,
                            jitter=False) if spp == 1 else \
        SamplerConfig(kind="lowdiscrepancy", pixelsamples=spp)
    opts = R.RenderOptions(
        xres=res, yres=res, sampler=sampler, filter_kind="box",
        filter_xwidth=0.5, filter_ywidth=0.5,
        integrator="whitted" if rows in (None, "sphere") else
        "directlighting", max_depth=0, chunk_size=res * res * spp)

    def moved(sc, cx):
        if rows == "sphere":
            q = sc.quadrics
            o2w, w2o = q.o2w.clone(), q.w2o.clone()
            o2w[0, 0, 3] = o2w[0, 0, 3] + cx
            w2o[0, 0, 3] = w2o[0, 0, 3] - cx
            return dataclasses.replace(sc, quadrics=dataclasses.replace(
                q, o2w=o2w, w2o=w2o))
        v = sc.triangles.verts
        m = torch.zeros_like(v)
        m[slice(None) if rows is None else rows, 0] = 1.0
        return dataclasses.replace(sc, triangles=dataclasses.replace(
            sc.triangles, verts=v + m * cx))
    lin = torch.arange(res * res * spp, device=device)
    ids = [(lin // spp % res).to(torch.int32),
           (lin // spp // res).to(torch.int32), (lin % spp).to(torch.int32)]
    return scene, opts, ids, moved, cx_t, BOUNDARY_FD[name]


def boundary_phases(device, launches, res=None, res4=None):
    """Phase 32: the boundary gradients on the card. The five
    finite-difference cases at BOUNDARY_RES (res on the CPU) and
    grad/config4_big with the boundary terms (res4 on the CPU)."""
    import torch
    from tpuprt_torch import render as R
    from tpuprt_torch.diff import silhouette as sil
    from tpuprt_torch.parallel import shard
    from tpuprt_torch.scene.parser import load_scene_string
    res = res or BOUNDARY_RES
    for name in BOUNDARY_FD:
        scene, opts, ids, moved, cx_t, row = fd_case(name, device, res)
        terms, spp, _, n_edge, seed, eps, tol = row
        target = torch.from_numpy(R.render(moved(scene, cx_t), opts._replace(
            driver="scan"), device=device)[0]).to(device)

        def loss(cx):
            return sil.render_loss_with_silhouette(
                moved(scene, cx), opts, *ids, target, n_edge_samples=n_edge,
                seed=seed, terms=terms, device=device)

        def grad():
            cx = torch.zeros((), device=device, requires_grad=True)
            return float(torch.autograd.grad(loss(cx), cx)[0])
        sil.live_lanes.update(dict.fromkeys(sil.TERMS, 0))
        g, counts, grad_s, peak = counted(device, grad)
        live = dict(sil.live_lanes)
        with torch.no_grad():
            fd = (float(loss(eps)) - float(loss(-eps))) / (2 * eps)
        # The sphere's scene has no triangle: its rays meet the quadric by
        # plain torch, no kernel.
        need = {"area_shadow": ["mt_best", "mt_best_any"],
                "sphere_rim": []}.get(name, ["mt_best"])
        if unlaunched(device, counts, need):
            raise AssertionError(f"boundary/{name}: launched no {need}")
        launches[f"boundary/{name}"] = counts
        emit(phase="boundary", scene=name, res=res, terms=list(terms),
             n_edge_samples=n_edge, seed=seed, autograd=g, fd=fd, eps=eps,
             rel=abs(g - fd) / abs(fd), tol=tol, grad_s=grad_s,
             peak_device_bytes=peak, launches=counts, live_lanes=live)
        assert all(live[t] > 0 for t in terms), (name, live)
        assert fd < 0 and g < 0 and abs(g - fd) < tol * abs(fd), (name, g,
                                                                  fd)
    # grad/config4_big at 1 spp with the boundary terms over the terrain's
    # edges: the primary term's samples live; the distant light's shadow
    # term runs and has none (no face turns from the sun; the border
    # edges' casts leave the terrain), which live_lanes shows.
    with open(SCENE) as f:
        c4, o4 = load_scene_string(film_text(f.read(), res4, 1))
    o4 = o4._replace(driver="scan")
    target = torch.from_numpy(R.render(c4, o4, device=device)[0]).to(device)
    sc = R.on_device(c4, device)
    t0 = time.perf_counter()
    topo = sil.mesh_edges(sc.triangles.idx.cpu().numpy())
    edges_s = time.perf_counter() - t0
    ids = loss_ids(o4, device)
    shift0 = torch.zeros_like(sc.triangles.verts)

    def grads(boundary):
        shift = shift0.clone().requires_grad_(True)
        s = dataclasses.replace(sc, triangles=dataclasses.replace(
            sc.triangles, verts=sc.triangles.verts + shift))
        if boundary:
            loss = sil.render_loss_with_silhouette(
                s, o4, *ids, target, topology=topo, device=device)
        else:
            loss = shard.render_loss_fn(s, o4, *ids, target, device=device)
        return loss.item(), torch.autograd.grad(loss, shift)[0]
    steps = {}
    for boundary in (False, True):
        sil.live_lanes.update(dict.fromkeys(sil.TERMS, 0))
        out, counts, wall, peak = counted(device, lambda: [
            grads(boundary) for _ in range(BOUNDARY_STEPS)])
        if unlaunched(device, counts, ["bvh_tiles", "bvh_tiles_any"]):
            raise AssertionError("grad/config4_big: the tile walk idle")
        steps[boundary] = dict(s_per_step=wall / BOUNDARY_STEPS,
                               peak_device_bytes=peak,
                               launches_per_step={
                                   k: v / BOUNDARY_STEPS
                                   for k, v in counts.items() if v},
                               live_lanes_per_step={
                                   k: v / BOUNDARY_STEPS
                                   for k, v in sil.live_lanes.items()},
                               loss=out[0][0], grad=out[0][1])
    launches["grad/config4_big/boundary"] = {
        k: int(v) for k, v in steps[True]["launches_per_step"].items()}
    g_kernel, g_interior = steps[True]["grad"], steps[False]["grad"]
    with patched(*plain_route("bvh_tiles")):
        _, g_plain = grads(True)
    if not (torch.isfinite(g_kernel).all() and torch.isfinite(g_plain).all()):
        raise AssertionError("grad/config4_big/boundary: not finite")
    err = float((g_kernel - g_plain).abs().max())
    scale = float(g_plain.abs().max())
    boundary_part = float((g_kernel - g_interior).abs().max())
    emit(phase="boundary", scene="config4_big", res=o4.xres, spp=1,
         triangles=sc.triangles.count, edges=len(topo[0]),
         mesh_edges_s=edges_s, steps=BOUNDARY_STEPS,
         interior={k: v for k, v in steps[False].items() if k != "grad"},
         boundary={k: v for k, v in steps[True].items() if k != "grad"},
         route_max_abs_diff=err, route_max_abs=scale, route_rtol=ROUTE_RTOL,
         boundary_part_max_abs=boundary_part)
    # The value is the interior loss, up to the rounding of adding and
    # taking off the surrogate (tests/test_grad.py:544's 1e-5).
    assert abs(steps[True]["loss"] - steps[False]["loss"]) < 1e-5, steps
    assert err <= ROUTE_RTOL * scale and boundary_part > 0, (err, scale)
    assert steps[True]["live_lanes_per_step"]["primary"] > 0, steps[True]


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def shard_work(mesh, device, res4, res):
    """What each world of phase 33 computes: render_sharded of config4_big
    (res4 on the CPU) twice and train_step_sharded with the boundary terms
    on the point-light shadow scene (res on the CPU). Returns (rgb, alpha,
    the renders' walls, the first's launches, loss, the vertices' gradient
    as numpy)."""
    import torch
    from tpuprt_torch import render as R
    from tpuprt_torch.parallel import shard
    from tpuprt_torch.scene.parser import load_scene_string
    with open(SCENE) as f:
        c4, o4 = load_scene_string(film_text(f.read(), res4))
    o4 = o4._replace(chunk_size=1 << 17)
    (rgb, alpha), counts, first, _ = counted(
        device, lambda: shard.render_sharded(c4, o4, mesh))
    wall = (first, counted(device, lambda: shard.render_sharded(
        c4, o4, mesh))[2])
    if unlaunched(device, counts, ["bvh_tiles"]):
        raise AssertionError("render_sharded: the tile walk idle")
    scene, opts, ids, moved, cx_t, row = fd_case("point_shadow", device,
                                                 res or BOUNDARY_RES)
    target = torch.from_numpy(R.render(moved(scene, cx_t), opts._replace(
        driver="scan"), device=device)[0])
    loss, g = shard.train_step_sharded(
        scene, opts, target, *ids, mesh, boundary=True,
        n_edge_samples=row[3], seed=row[4])
    return (rgb, alpha, wall, counts, float(loss),
            g.triangles.verts.cpu().numpy())


def shard_rank(rank, world, port, out, device, res4, res):
    """One spawned rank of phase 33's world of 2: gloo, both ranks on
    `device` (the one card), its results to out/rank{rank}.npz."""
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch.distributed as dist
    from tpuprt_torch.parallel import multihost
    mesh = multihost.init_distributed(f"localhost:{port}", world, rank,
                                      backend="gloo", device=device)
    rgb, alpha, wall, counts, loss, verts = shard_work(mesh, device, res4,
                                                       res)
    np.savez(os.path.join(out, f"rank{rank}.npz"), rgb=rgb, alpha=alpha,
             wall=wall, loss=loss, verts=verts,
             bvh_tiles=counts["bvh_tiles"])
    dist.destroy_process_group()


def shard_phase(device, launches, res4=None, res=None):
    """Phase 33: render_sharded of config4_big over a world of 1 (NCCL on
    the card) against render_chunked, a world of 2 processes sharing the
    device (gloo, spawned here) against the world of 1, and
    train_step_sharded with the boundary terms on 2 ranks against 1."""
    import multiprocessing
    import numpy as np
    import torch.distributed as dist
    from tpuprt_torch import render as R
    from tpuprt_torch.parallel import multihost
    from tpuprt_torch.scene.parser import load_scene_string
    cuda = device != "cpu"
    mesh = multihost.init_distributed(f"localhost:{free_port()}", 1, 0,
                                      device=device)
    try:
        rgb1, alpha1, wall1, counts1, loss1, verts1 = shard_work(
            mesh, device, res4, res)
    finally:
        dist.destroy_process_group()
    launches["config4_big/shard"] = counts1
    with open(SCENE) as f:
        c4, o4 = load_scene_string(film_text(f.read(), res4))
    chunked = R.render_chunked(R.on_device(c4, device), o4, device)
    d_chunked = images_close("shard/1 vs render_chunked", (rgb1, alpha1),
                             chunked, SHARD_TOL, SHARD_TOL)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        port = free_port()
        procs = [ctx.Process(target=shard_rank, args=(
            r, 2, port, tmp, device, res4, res)) for r in range(2)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=600)
        spawn_wall = time.perf_counter() - t0
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if codes != [0, 0]:
            raise AssertionError(f"shard: the ranks exited {codes}")
        ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
                 for r in range(2)]
    d_two = [images_close(f"shard/2 rank {r} vs 1", (z["rgb"], z["alpha"]),
                          (rgb1, alpha1), SHARD_TOL, SHARD_TOL)
             for r, z in enumerate(ranks)]
    scale = float(np.abs(verts1).max())
    step = [dict(loss_rel=abs(float(z["loss"]) - loss1) / abs(loss1),
                 grad_max_rel=float(np.abs(z["verts"] - verts1).max()) /
                 scale) for z in ranks]
    emit(phase="shard", scene="config4_big", res=o4.xres,
         spp=o4.sampler.pixelsamples, one_rank=dict(
             backend="nccl" if cuda else "gloo", walls_s=wall1,
             launches=counts1, vs_render_chunked=d_chunked),
         two_ranks=dict(backend="gloo", walls_s=[z["wall"].tolist()
                                                 for z in ranks],
                        bvh_tiles_launches=[int(z["bvh_tiles"])
                                            for z in ranks],
                        spawn_to_exit_s=spawn_wall, vs_one_rank=d_two),
         train_step=dict(scene="point_shadow", res=res or BOUNDARY_RES,
                         loss=loss1, vertex_grad_max_abs=scale,
                         two_vs_one=step, rtol=SHARD_TOL), tol=SHARD_TOL)
    assert scale > 0 and all(s["loss_rel"] <= SHARD_TOL and
                             s["grad_max_rel"] <= SHARD_TOL
                             for s in step), step


def peak_render(label, scene, opts, device, need, **kw):
    """render_path with the peak device memory of its two renders:
    (rgb, launches, first_s, wall_s, peak_bytes; None on the CPU)."""
    import torch
    if torch.device(device).type != "cuda":
        return (*render_path(label, scene, opts, device, [], **kw), None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = render_path(label, scene, opts, device, need, **kw)
    return (*out, torch.cuda.max_memory_allocated())


def ref_render(label, text_of, ref_path, device, need, limits):
    """The scene text_of(res) at its reference EXR's size (res x res,
    tools/shading_refs.py), through load_scene_string -> render() under
    counted() -> write_exr, held inside `limits` (blurred rel, mean) of the reference
    by test_golden._compare's measures. Returns the phase's line."""
    import numpy as np
    from tpuprt_torch import render as R
    from tpuprt_torch.io.exr import read_exr, write_exr
    from tpuprt_torch.scene.parser import load_scene_string
    ref, _ = read_exr(ref_path)
    scene, opts = load_scene_string(text_of(ref.shape[0]))
    # f32 readback, then the EXR writer's half pixels as the reference
    # has them: the f16 readback clips at 0, and a Mitchell or sinc filter
    # leaves some pixels negative, which the writer keeps.
    opts = opts._replace(chunk_size=1 << 17)
    (rgb, alpha), counts, wall, peak = counted(device, lambda: R.render(
        scene, opts, device=device))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, opts.filename)
        write_exr(out, rgb, alpha)
        rgb, _ = read_exr(out)
    missing = unlaunched(device, counts, need)
    if missing or rgb.shape != ref.shape or not np.isfinite(rgb).all():
        raise AssertionError(f"{label}: launched no {missing}, or bad "
                             f"image {rgb.shape}")
    rel, mean = band(rgb, ref)
    line = dict(phase="render", scene=label, shape=list(rgb.shape),
                reference=os.path.relpath(ref_path, ROOT),
                spp=opts.sampler.pixelsamples, launches=counts,
                band_rel=rel, band_rel_limit=limits[0], band_mean=mean,
                band_mean_limit=limits[1], wall_s=wall,
                peak_device_bytes=peak)
    emit(**line)
    assert rel <= limits[0] and mean <= limits[1], (rel, mean)
    return line


def splat_timing(device, n=1 << 17, res=512, reps=5):
    """The film splat alone on the card: n samples (a pool pass's lanes at
    bench.py's 2^17) at random points of a res x res film, through
    film.add_samples with each filter at its default width and a box of
    width 1.5; device ms (timed) and host ms per call."""
    import math
    import numpy as np
    import torch
    from tpuprt_torch.film import film as film_mod
    from tpuprt_torch.filters.filters import DEFAULT_WIDTHS
    rng = np.random.default_rng(MAP_SEED)
    ix, iy, alpha = (torch.from_numpy(rng.uniform(0, res, n).astype(
        np.float32)).to(device) for _ in range(3))
    L = torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32)).to(
        device)
    film = film_mod.make_film(res, res, device=device)
    for kind, (xw, yw) in list(DEFAULT_WIDTHS.items()) + [("box",
                                                           (1.5, 1.5))]:
        ms, _, host = timed(lambda: film_mod.add_samples(
            film, ix, iy, L, alpha, kind, xw, yw), reps)
        emit(phase="splat", filter=kind, width=[xw, yw], samples=n,
             window=(math.floor(2 * xw) + 1) * (math.floor(2 * yw) + 1),
             ms=ms, host_ms=host)


def shading_phases(device, launches, res):
    """Phases 34-35: every material, camera and pixel filter on the card.

    34. bench3's box in the other materials (materials_text, Mitchell by
    default) at 256x256 x 32 spp, path, depth 5, bench.py's pool: mt_best
    launched in both modes, finite, walls and samples/s, peak memory; the
    BSDF-strategy batch (nearest) of the pass with the most live ones and
    the shadow batch (any hit) of the pass with the most live shadow rays
    bit-equal to the plain version;
    the scene at its reference's size inside golden3's limits of
    scenes/bench3_materials.exr.
    35. config4_big at 512x512 x 4 spp, directlighting, through the tile
    walk: its box filter beside cameras_text's "mitchell", "thinlens",
    "ortho" and "env", each launched and finite, walls and peak memory;
    the film splat alone by filter (splat_timing); then "thinlens" at its
    reference's size inside phase 4's band of
    scenes/config4_thinlens.exr."""
    from tpuprt_torch.ops import mt_cuda
    from tpuprt_torch.scene.data import to_device
    from tpuprt_torch.scene.parser import load_scene, load_scene_string
    with open(BENCH3) as f:
        b3_text = f.read()
    t0 = time.perf_counter()
    scene, opts = load_scene_string(materials_text(b3_text))
    opts = opts._replace(chunk_size=1 << 17, half_readback=True)
    emit(phase="load", scene="bench3/materials",
         seconds=time.perf_counter() - t0,
         materials=scene.materials.kind.tolist(),
         lobe_kinds=list(scene.materials.lobe_kinds),
         filter=[opts.filter_kind, opts.filter_xwidth, opts.filter_ywidth])
    assert opts.filter_kind == "mitchell" and scene.accel is None
    label = "bench3/materials"
    rgb, launches[label], first_s, wall, peak = peak_render(
        label, scene, opts, device, ["mt_best", "mt_best_any"])
    spp = opts.sampler.pixelsamples
    emit(phase="render", scene=label, shape=list(rgb.shape), spp=spp,
         launches=launches[label], finite=True, first_render_s=first_s,
         wall_s=wall, samples_per_s=opts.xres * opts.yres * spp / wall,
         peak_device_bytes=peak)
    # A pass calls mt_best three times (bounce, shadow, BSDF-strategy
    # rays): the BSDF-strategy batch of the pass with the most live ones,
    # the shadow batch of the pass with the most live shadow rays.
    tris = mt_cuda.pack_table(to_device(scene, device).triangles)
    for (k, any_hit), kind in (((2, False), "bsdf"), ((1, True), "shadow")):
        rays = capture_rays(scene, opts, device, mt_cuda, "mt_best", 0,
                            period=3, by=k if kind == "bsdf" else None)
        res["mt_best"] += mt_parity(f"{label}/{kind}", tris,
                                    rays[(k, any_hit)], modes=(any_hit,))
    del rays, tris
    ref_render(f"{label}/ref", lambda r: materials_text(b3_text, res=r),
               MATERIALS_EXR, device, ["mt_best", "mt_best_any"],
               (BAND3_REL, BAND3_MEAN))

    with open(SCENE) as f:
        c4_text = f.read()
    for kind in ("box",) + tuple(CAMERAS_4):
        t0 = time.perf_counter()
        scene, opts = (load_scene(SCENE) if kind == "box" else
                       load_scene_string(cameras_text(c4_text, kind)))
        load_s = time.perf_counter() - t0
        opts = opts._replace(chunk_size=1 << 17, half_readback=True)
        label = "config4_big" + ("" if kind == "box" else f"/{kind}")
        key = f"{label}/35" if kind == "box" else label
        rgb, launches[key], first_s, wall, peak = peak_render(
            label, scene, opts, device, ["bvh_tiles"])
        emit(phase="render", scene=label, camera=scene.camera.kind,
             lens_radius=float(scene.camera.lens_radius),
             filter=[opts.filter_kind, opts.filter_xwidth,
                     opts.filter_ywidth], load_s=load_s,
             shape=list(rgb.shape), spp=opts.sampler.pixelsamples,
             launches=launches[key], finite=True, first_render_s=first_s,
             wall_s=wall, peak_device_bytes=peak)
        del scene
    splat_timing(device)
    ref_render("config4_big/thinlens/ref",
               lambda r: cameras_text(c4_text, "thinlens", res=r),
               THINLENS_EXR, device, ["bvh_tiles"], (BAND_REL, BAND_MEAN))


def split_scene_files(d, text):
    """config4_big's text written into directory d as pbrt-v1 users split
    a scene: top.pbrt (the film, sampler and integrator, a SearchPath,
    Include "view/camera.pbrt" with the LookAt, a CoordinateSystem "eye"
    and the Camera, then WorldBegin, Identity and Include
    "world/world.pbrt"); world/world.pbrt includes "lights.pbrt" beside
    itself, takes a CoordinateSystem "w0" / Translate / CoordSysTransform
    "w0" whose net transform is the identity, one MakeNamedMaterial
    line (an unknown statement) and one parameter nothing reads on the
    terrain's Shape: two warnings. Returns top.pbrt's path."""
    head, world = text.split("WorldBegin\n", 1)
    lines = head.splitlines()
    look = next(ln for ln in lines if ln.startswith("LookAt"))
    cam = next(ln for ln in lines if ln.startswith("Camera"))
    lights, body = world.split("Texture", 1)
    body = "Texture" + body[:body.rindex("WorldEnd")]
    assert lights.startswith("LightSource") and \
        body.count('Shape "trianglemesh"') == 1
    files = {
        "top.pbrt": "\n".join(ln for ln in lines if ln not in (look, cam)) +
        '\nSearchPath "shaders:plugins"\nInclude "view/camera.pbrt"\n'
        'WorldBegin\nIdentity\nInclude "world/world.pbrt"\nWorldEnd\n',
        "view/camera.pbrt": f'{look}\nCoordinateSystem "eye"\n{cam}\n',
        "world/lights.pbrt": lights,
        "world/world.pbrt": 'Include "lights.pbrt"\n'
        'CoordinateSystem "w0"\nTranslate 0.25 -0.5 1\n'
        'CoordSysTransform "w0"\n'
        'MakeNamedMaterial "terrain" "string type" ["matte"]\n' +
        body.replace('Shape "trianglemesh"',
                     'Shape "trianglemesh" "float alpha" [1]'),
    }
    for name, content in files.items():
        os.makedirs(os.path.dirname(os.path.join(d, name)), exist_ok=True)
        with open(os.path.join(d, name), "w") as f:
            f.write(content)
    return os.path.join(d, "top.pbrt")


def operability_phase(device, launches, c4_walls, res=None):
    """Phase 38: the CLI on the card. config4_big split into files
    (split_scene_files) rendered by tpuprt_torch.cli.main([top, -o, out])
    in this process under counted(): rc 0, bvh_tiles launched, the EXR
    inside phase 4's band of bench4.exr and, against the library path's
    render of scenes/config4_big.pbrt with the same options (f16
    readback), each value within LOOP_REL or one f16 step (2^-10
    relative: two f32 sums that the splat's atomic adds order differently
    may round to neighbouring halves), exactly two warnings more, and
    "Samples taken" 512 x 512 x 4 in its stats table; a warm second run;
    then ``python3 -m tpuprt_torch top -o out2 --quiet`` once in a child
    process (the entry point without JAX), its EXR as the first. The
    walls beside phase 4's (c4_walls: first, warm). Then
    apply_imaging_pipeline ("maxwhite", gamma 2.2, bloom 0.2) on the image
    on the card and on the CPU, their largest difference on the 0-255
    scale (at most TONEMAP_TOL), each one's wall. res shrinks the film
    for a rehearsal on the CPU (no band there, and the CPU stands in for
    the card)."""
    import contextlib
    import io
    import numpy as np
    import torch
    from tpuprt_torch import cli
    from tpuprt_torch import render as R
    from tpuprt_torch.io.exr import read_exr
    from tpuprt_torch.scene.parser import load_scene, load_scene_string
    from tpuprt_torch.tonemaps.tonemaps import apply_imaging_pipeline
    from tpuprt_torch.utils import errors
    from tpuprt_torch.utils.stats import _suffixed

    def close(a, b):
        """Per value: |a - b| within LOOP_REL or one f16 step of b."""
        tol = np.maximum(LOOP_REL * np.abs(b), np.abs(b) * 2.0 ** -10)
        err = np.abs(a - b)
        return bool((err <= tol).all()), int((a != b).sum()), float(
            (err / np.maximum(np.abs(b), 1e-30)).max())

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    with open(SCENE) as f:
        text = film_text(f.read(), res)
    dev = [] if cuda else ["--device", "cpu"]
    with tempfile.TemporaryDirectory() as d:
        top = split_scene_files(d, text)
        out, out2 = os.path.join(d, "cli.exr"), os.path.join(d, "cli2.exr")
        warned = errors.counts["warning"]
        stdout, stderr = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(stdout), \
                contextlib.redirect_stderr(stderr):
            rc, counts, first_s, peak = counted(
                device, lambda: cli.main([top, "-o", out] + dev))
        warnings = errors.counts["warning"] - warned
        launches["config4_big/cli"] = counts
        rgb, alpha = read_exr(out)
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(io.StringIO()):
            cli.main([top, "-o", out, "--quiet"] + dev)
        sync()
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-m", "tpuprt_torch", top, "-o", out2,
             "--quiet"] + dev, cwd=ROOT, capture_output=True, text=True,
            timeout=600)
        child_s = time.perf_counter() - t0
        if child.returncode != 0:
            raise AssertionError(f"python -m tpuprt_torch failed: "
                                 f"{child.stderr[-2000:]}")
        rgb2, _ = read_exr(out2)
    table = stdout.getvalue()
    taken = next((ln.split()[-1] for ln in table.splitlines()
                  if "Samples taken" in ln), None)
    scene, opts = load_scene(SCENE) if res is None else \
        load_scene_string(text)
    lib, lib_alpha = R.render(scene, opts._replace(half_readback=True),
                              device=device)
    rel, mean = band(rgb, read_exr(GOLDEN)[0]) if res is None else (0, 0)
    same, n_diff, max_rel = close(rgb, lib)
    same2, n_diff2, max_rel2 = close(rgb2, rgb)
    emit(phase="operability", scene="config4_big/cli", rc=rc,
         shape=list(rgb.shape), launches=counts,
         bvh_tiles_any=counts["bvh_tiles_any"], first_wall_s=first_s,
         warm_wall_s=warm_s, child_process_wall_s=child_s,
         library_first_wall_s=c4_walls[0], library_wall_s=c4_walls[1],
         peak_device_bytes=peak, band_rel=rel, band_rel_limit=BAND_REL,
         band_mean=mean, band_mean_limit=BAND_MEAN,
         vs_library=dict(values_differ=n_diff, max_rel_diff=max_rel,
                         within=same),
         child_vs_first=dict(values_differ=n_diff2, max_rel_diff=max_rel2,
                             within=same2),
         warnings=warnings, samples_taken=taken,
         progress_drawn="Rendering: [" in stderr.getvalue())
    assert rc == 0 and not unlaunched(device, counts, ["bvh_tiles"]), \
        (rc, counts)
    assert np.isfinite(rgb).all() and np.array_equal(alpha, lib_alpha)
    assert rel <= BAND_REL and mean <= BAND_MEAN, (rel, mean)
    assert same and same2, (max_rel, max_rel2)
    assert warnings == 2 and taken == _suffixed(
        opts.xres * opts.yres * opts.sampler.pixelsamples), (warnings, taken)

    # The tone map on the card and on the CPU.
    kw = dict(tonemap="maxwhite", gamma=2.2, bloom_radius=0.2)
    img = torch.from_numpy(rgb)
    apply_imaging_pipeline(img.to(device), **kw)      # warm the card
    sync()
    t0 = time.perf_counter()
    on_card = apply_imaging_pipeline(img.to(device), **kw).cpu()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = apply_imaging_pipeline(img, **kw)
    cpu_s = time.perf_counter() - t0
    diff = float((on_card - on_cpu).abs().max())
    emit(phase="operability", check="tonemap", args=kw, shape=list(
         on_card.shape), max_abs_diff_0_255=diff, limit=TONEMAP_TOL,
         card_s=card_s, cpu_s=cpu_s)
    assert diff <= TONEMAP_TOL and bool(torch.isfinite(on_card).all()), diff


def bench6_fog_text(text):
    """bench6's text with a thin homogeneous Volume filling the box."""
    cut = text.rindex("WorldEnd")
    return text[:cut] + (
        'Volume "homogeneous" "color sigma_a" [0.05 0.05 0.05]\n'
        '  "color sigma_s" [0.15 0.15 0.15] "point p0" [-1 -1 -1]\n'
        '  "point p1" [1 1 1]\n') + text[cut:]


def volume_phases(device, launches, res, res4=None, res3=None, spp3=None):
    """Phase 36: volumes on the card.

    config4_big/fog (fog_text: a homogeneous box over the terrain,
    "single") at 512x512 x 4 spp, directlighting "all", through the tile
    walk, and bench3/smoke (smoke_text: a 32^3 volumegrid, "single") at
    256x256 x 32 spp in path mode through mt_best: each through the pool
    (walls first and warm, peak memory, f32 readback), against the scan
    driver per pixel (SCAN_TOL), the kernel against its plain version on
    every k-th ray of the scan's largest any-hit call (a chunk's
    single-scattering shadow rays), and at its reference's film, emission
    only (VOL_REF_INTEGRATOR), within VOL_REF_REL, VOL_REF_MEAN of
    tpuprt's image. single_box (single_text: "single" under Accelerator
    "none", mt_best in both modes) within the same limits of tpuprt's
    "single" image (scenes/single_box.exr). bench6/fog (bench6_fog_text: photonmap, which leaves
    the pool for the chunked driver over volumes): load -> maps -> render
    timed, finite, peak memory, mt_best's launches. res4, res3, spp3
    shrink the films for a rehearsal on the CPU (bench6/fog at res3)."""
    import numpy as np
    from tpuprt_torch import render as R
    from tpuprt_torch.ops import bvh_cuda, mt_cuda
    from tpuprt_torch.scene.data import to_device
    from tpuprt_torch.scene.parser import load_scene_string
    from tpuprt_torch.utils.stats import StatsRegistry
    with open(SCENE) as f:
        c4 = f.read()
    with open(BENCH3) as f:
        b3 = f.read()
    for label, text, need, ref, ref_text in (
            ("config4_big/fog", fog_text(c4, res4), ["bvh_tiles"], FOG_EXR,
             lambda r: fog_text(c4, res=r, integrator=VOL_REF_INTEGRATOR)),
            ("bench3/smoke", smoke_text(b3, res3, spp3),
             ["mt_best", "mt_best_any"], SMOKE_EXR,
             lambda r: smoke_text(b3, res=r, spp=4,
                                  integrator=VOL_REF_INTEGRATOR))):
        t0 = time.perf_counter()
        scene, opts = load_scene_string(text)
        emit(phase="load", scene=label, seconds=time.perf_counter() - t0,
             volumes=scene.volumes.count,
             grids=list(scene.volumes.grids),
             volume_integrator=opts.volume_integrator,
             integrator=opts.integrator)
        # f32 readback: the pool's image is held to the scan's per pixel.
        opts = opts._replace(chunk_size=1 << 17)
        alpha = []
        rgb, launches[label], first_s, wall, peak = peak_render(
            label, scene, opts, device, need, alpha=alpha)
        spp = opts.sampler.pixelsamples
        emit(phase="render", scene=label, shape=list(rgb.shape), spp=spp,
             launches=launches[label], finite=True, first_render_s=first_s,
             wall_s=wall, samples_per_s=opts.xres * opts.yres * spp / wall,
             peak_device_bytes=peak, mean=float(rgb.mean()))
        scan = opts._replace(driver="scan")
        srgb, salpha, line = scan_render(f"{label}/scan", scene, scan,
                                         device, need)
        launches[f"{label}/scan"] = line["launches"]
        emit(phase="scan", check="pool", tol=SCAN_TOL, **line,
             **images_close(label, (rgb, alpha[0]), (srgb, salpha),
                            SCAN_TOL, SCAN_ALPHA_TOL))
        del rgb, srgb, salpha
        # The largest any-hit call, a chunk's single-scattering march (32
        # shadow rays a lane, step-major), taken from the scan (cheaper
        # than the pool, the same kernel); every k-th ray, about 2^17.
        if need == ["bvh_tiles"]:
            rays = capture_rays(scene, scan, device, bvh_cuda,
                                "traverse_tiles", 4)[True]
            res["bvh_tiles"] += tiles_parity(
                f"{label}/single", to_device(scene, device).accel,
                rays[:, ::max(1, rays.shape[1] >> 17)].contiguous())
        else:
            rays = capture_rays(scene, scan, device, mt_cuda, "mt_best",
                                0)[True]
            res["mt_best"] += mt_parity(
                f"{label}/single", mt_cuda.pack_table(to_device(
                    scene, device).triangles),
                rays[:, ::max(1, rays.shape[1] >> 17)].contiguous(),
                modes=(True,))
        del rays, scene
        ref_render(f"{label}/ref", ref_text, ref, device, need,
                   (VOL_REF_REL, VOL_REF_MEAN))
    # "single" itself held to tpuprt's image: single_text's small scene
    # (scenes/single_box.exr, tpuprt's eager render on the CPU).
    ref_render("single_box/ref", lambda r: single_text(res=r), SINGLE_EXR,
               device, ["mt_best", "mt_best_any"],
               (VOL_REF_REL, VOL_REF_MEAN))

    with open(BENCH6) as f:
        b6 = film_text(bench6_fog_text(f.read()), res3)

    def load_render():
        t0 = time.perf_counter()
        scene, opts = load_scene_string(b6)
        out = R.render(scene, opts._replace(half_readback=True),
                       device=device, stats=stats)
        return out, opts, time.perf_counter() - t0
    stats = StatsRegistry()
    ((rgb, _), opts, _), launches["bench6/fog"], first_s, peak = counted(
        device, load_render)
    wall = load_render()[2]
    counts = launches["bench6/fog"]
    missing = unlaunched(device, counts, ["mt_best", "mt_best_any"])
    emit(phase="render", scene="bench6/fog", shape=list(rgb.shape),
         spp=opts.sampler.pixelsamples, driver="chunked",
         preprocess_s=stats.get("Performance", "Preprocess seconds"),
         launches=counts,
         mt_best_nearest=counts["mt_best"] - counts["mt_best_any"],
         mt_best_any=counts["mt_best_any"], finite=bool(
             np.isfinite(rgb).all()), first_wall_s=first_s, wall_s=wall,
         peak_device_bytes=peak)
    assert not missing and np.isfinite(rgb).all(), missing


def instancing_phases(device, launches, res, res4=None, n_rocks=N_ROCKS):
    """Phase 37: the rest of instancing on the card.

    rocks/loop: the rocks scene (N_ROCKS instances on config4_big's
    terrain) with the rock a Loop subdivision surface (loop_rock, 1280
    triangles) at 512x512 x 4 spp through the tile and instanced walks:
    its prototype's tables bit-equal to the same scene's with the port's
    tessellation written inline as a trianglemesh, the images within
    LOOP_REL per pixel (the film's atomic adds). rocks/lamps: the rocks
    and LAMPS instanced quad lamps (lamps_text; every LAMP_MIRROR-th
    mirrored), directlighting "one" at 512x512 x 4 spp, held to the same
    lamps written inline by LAMP_DIFF and LAMP_MAX; the instanced walk
    against its plain version on every k-th ray of the render's largest
    call (a pass's shadow and BSDF-strategy rays, nearest). res4, n_rocks
    shrink the scene for a rehearsal on the CPU."""
    import numpy as np
    from tpuprt_torch.ops import bvh_cuda
    from tpuprt_torch.scene.data import to_device
    from tpuprt_torch.scene.parser import load_scene_string
    with open(SCENE) as f:
        base = film_text(f.read(), res4)
    imgs, protos = {}, {}
    for kind in ("loop", "inline"):
        t0 = time.perf_counter()
        scene, opts = load_scene_string(rocks_scene_text(
            base, n_rocks, ROCK_SUBDIV, ROCK_SEED,
            rock=loop_rock(inline=kind == "inline")))
        load_s = time.perf_counter() - t0
        opts = opts._replace(chunk_size=1 << 17)
        label = "rocks/loop" + ("" if kind == "loop" else "/inline")
        imgs[kind], launches[label], first_s, wall, peak = peak_render(
            label, scene, opts, device, ["bvh_tiles", "bvh_instanced"])
        emit(phase="render", scene=label, load_s=load_s,
             proto_triangles=scene.instances.n_tris,
             instances=scene.instances.count, shape=list(imgs[kind].shape),
             launches=launches[label], first_render_s=first_s, wall_s=wall,
             peak_device_bytes=peak)
        assert scene.instances.n_tris == 1280
        protos[kind] = (scene.instances.verts, scene.instances.idx,
                        scene.instances.nodes)
        del scene
    # The prototype's vertices, triangles and BLAS bit-equal; the images
    # equal up to the film's atomic adds, whose order the card does not
    # fix (a pixel sums its samples in any order).
    same = all(bool((a == b).all()) for a, b in zip(protos["loop"],
                                                     protos["inline"]))
    a, b = imgs["loop"], imgs["inline"]
    err = float((np.abs(a - b) / np.maximum(np.abs(b), 1e-30)).max())
    emit(phase="render", scene="rocks/loop", check="inline tessellation",
         tables_bit_equal=same, values_differ=int((a != b).sum()),
         max_rel_diff=err, limit=LOOP_REL)
    assert same and err <= LOOP_REL, (same, err)

    rocks = rocks_scene_text(base, n_rocks, ROCK_SUBDIV, ROCK_SEED)
    for kind in ("instanced", "inline"):
        t0 = time.perf_counter()
        scene, opts = load_scene_string(lamps_text(
            rocks, inline=kind == "inline"))
        load_s = time.perf_counter() - t0
        opts = opts._replace(chunk_size=1 << 17, direct_strategy="one")
        label = "rocks/lamps" + ("" if kind == "instanced" else "/inline")
        imgs[kind], launches[label], first_s, wall, peak = peak_render(
            label, scene, opts, device, ["bvh_tiles", "bvh_instanced"])
        emit(phase="render", scene=label, load_s=load_s,
             lights=scene.lights.count,
             area_geoms=list(scene.lights.area_geoms_present),
             shape=list(imgs[kind].shape), launches=launches[label],
             first_render_s=first_s, wall_s=wall, peak_device_bytes=peak,
             mean=float(imgs[kind].mean()))
        if kind == "instanced":
            # A pass's shadow and BSDF-strategy rays go to one nearest
            # walk (an area light must be named at the hit).
            rays = capture_rays(scene, opts, device, bvh_cuda,
                                "traverse_instanced", 7)[False]
            res["bvh_instanced"] += instanced_parity(
                f"{label}/shadow", to_device(scene, device).instances,
                rays[:, ::max(1, rays.shape[1] >> 17)].contiguous())
            del rays
        del scene
    a, b = imgs["instanced"], imgs["inline"]
    diff = float(np.abs(a - b).mean() / b.mean())
    top = float(abs(a.max() - b.max()) / b.max())
    emit(phase="render", scene="rocks/lamps", check="inline lamps",
         rel_mean_abs_diff=diff, limit=LAMP_DIFF, brightest_rel_diff=top,
         brightest_limit=LAMP_MAX)
    assert diff < LAMP_DIFF and top <= LAMP_MAX, (diff, top)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--exr", help="also keep config4_big's rendered image "
                    "here")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one more render of each scene: "
                    "device time by kernel and the device's idle share")
    ap.add_argument("--old", metavar="DIR",
                    help="instead of the smoke run, time the bvh_tiles.cu "
                    "and bvh_rows.cu of commit 2a258fc, in DIR, against the "
                    "checkout's")
    ap.add_argument("--new-first", action="store_true",
                    help="with --old, run the trees in the turns new, old, "
                    "old, new")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np
    from tpuprt_torch.io.exr import read_exr
    from tpuprt_torch.ops import bvh_cuda, mt_cuda
    from tpuprt_torch.scene.data import to_device
    from tpuprt_torch.scene.parser import load_scene, load_scene_string

    device = "cuda"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    if args.old:
        ab_main(args.old, new_first=args.new_first)
        print(smi, flush=True)
        return 0

    # 1. Build the kernel sources from the checkout, one nvcc each, at once.
    def build(src):
        t0 = time.perf_counter()
        bvh_cuda.build(src)
        return time.perf_counter() - t0
    srcs = (bvh_cuda.KERNEL_SRC, bvh_cuda.ROWS_SRC, mt_cuda.MT_SRC)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(srcs)) as ex:
        secs = list(ex.map(build, srcs))
    emit(phase="build", sources=[os.path.relpath(s, ROOT) for s in srcs],
         seconds=secs, wall_seconds=time.perf_counter() - t0)

    # 2. Kernels vs plain versions at config4_big (NN <= 22000).
    t0 = time.perf_counter()
    scene, opts = load_scene(SCENE)
    load_s = time.perf_counter() - t0
    scene_d = to_device(scene, device)
    bvh = scene_d.accel
    emit(phase="load", scene="config4_big", seconds=load_s,
         triangles=scene.triangles.count, nn=bvh.n_nodes)
    assert bvh.n_nodes <= 22000, bvh.n_nodes
    res = {k: [] for k in REPLACES}
    cam_rays = sort_packed(bvh, camera_rays(scene_d, opts, device))
    rnd_rays = sort_packed(bvh, torch.from_numpy(random_rays(1 << 18, 1))
                           .to(device))
    for name, fn in (("bvh_tiles", tiles_parity), ("bvh_rows", rows_parity)):
        res[name] += fn("config4_big/camera", bvh, cam_rays)
        res[name] += fn("config4_big/random", bvh, rnd_rays)
    del cam_rays, rnd_rays

    # 3. Kernels vs plain versions above 22000 nodes (1M triangles):
    # config5_huge's scene, rendered in phase 17.
    t0 = time.perf_counter()
    c5, c5_opts, ntris = config5_huge()
    c5_load_s = time.perf_counter() - t0
    big = to_device(c5, device)
    emit(phase="load", scene=f"terrain({SCALE_TERRAIN_N})",
         seconds=c5_load_s, triangles=ntris, nn=big.accel.n_nodes)
    assert big.accel.n_nodes > 22000, big.accel.n_nodes
    rays = sort_packed(big.accel, torch.from_numpy(random_rays(1 << 16, 2))
                       .to(device))
    label = f"terrain{SCALE_TERRAIN_N}/random"
    res["bvh_tiles"] += tiles_parity(label, big.accel, rays, reps=3)
    res["bvh_rows"] += rows_parity(label, big.accel, rays, reps=3)
    del big, rays

    # 3b. The row walk on a tree deeper than the tile walk takes and than
    # its stack's local levels (the scratch path), built by hand.
    deep = deep_tree(DEEP_LEVELS, 6)
    from tpuprt_torch.accel import bvh_build
    assert bvh_build.build_tiles(deep.nodes.numpy(), np.full(
        (deep.n_nodes, 8), -1, np.int32), deep.n_nodes) is None
    scratch = bvh_cuda.rows_stack_scratch(deep.max_depth, 1, "cpu")
    assert scratch is not None, deep.max_depth
    emit(phase="load", scene=f"deep_tree({DEEP_LEVELS})", nn=deep.n_nodes,
         max_depth=deep.max_depth, scratch_entries=scratch.shape[0])
    deep = to_device(deep, device)
    res["bvh_rows"] += rows_parity(
        f"deep_tree({DEEP_LEVELS})/random", deep,
        torch.from_numpy(deep_rays(1 << 16, 7)).to(device))
    del deep
    understated_depth()

    # 4. Main path, tile walk: load_scene -> render -> write_exr with
    # bench.py's settings for config4_big (2^17 lanes, f16 readback).
    ref, _ = read_exr(GOLDEN)
    opts = opts._replace(chunk_size=1 << 17, half_readback=True)
    launches = {}
    rgb, launches["config4_big"], first_s, wall = render_path(
        "config4_big", scene, opts, device, ["bvh_tiles"], args.exr)
    rel, mean = band(rgb, ref)
    emit(phase="render", scene="config4_big", shape=list(rgb.shape),
         spp=opts.sampler.pixelsamples, launches=launches["config4_big"],
         finite=True, band_rel=rel, band_rel_limit=BAND_REL, band_mean=mean,
         band_mean_limit=BAND_MEAN, first_render_s=first_s, wall_s=wall,
         rays_per_s=CONFIG4_REF_RAYS / wall)
    assert rel <= BAND_REL and mean <= BAND_MEAN, (rel, mean)
    c4_walls = (first_s, wall)
    if args.profile:
        profile_render("config4_big", scene, opts, device)

    # 5. Main path, row walk: the same scene with its BVH in row format
    # only, as build_bvh leaves a tree the tile walk rejects.
    rows_scene = dataclasses.replace(scene, accel=dataclasses.replace(
        scene.accel, nodesT=None, nodeskip=None, nodemeta=None))
    rgb, launches["config4_big/rows"], first_s, wall = render_path(
        "config4_big/rows", rows_scene, opts, device, ["bvh_rows"])
    rel, mean = band(rgb, ref)
    emit(phase="render", scene="config4_big/rows", shape=list(rgb.shape),
         launches=launches["config4_big/rows"], finite=True, band_rel=rel,
         band_rel_limit=BAND_REL, band_mean=mean, band_mean_limit=BAND_MEAN,
         first_render_s=first_s, wall_s=wall,
         rays_per_s=CONFIG4_REF_RAYS / wall)
    assert rel <= BAND_REL and mean <= BAND_MEAN, (rel, mean)
    # Every 8th of config4_big's camera rays (2^17, spread over the whole
    # film: the first 2^17 are the top rows, all sky), for phase 8.
    cam = camera_rays(scene_d, opts, device)
    c4_rays = cam[:, ::cam.shape[1] // MT_CONFIG4_RAYS].contiguous()
    del cam
    del rows_scene, scene_d, bvh

    # 6. The instanced walk vs its plain version on the rocks scene.
    t0 = time.perf_counter()
    with open(SCENE) as f:
        base_text = f.read()
    text = rocks_scene_text(base_text, N_ROCKS, ROCK_SUBDIV, ROCK_SEED)
    rocks, dup, ropts = rocks_scenes(text)
    inst = rocks.instances
    emit(phase="load", scene=f"rocks({N_ROCKS})",
         seconds=time.perf_counter() - t0,
         triangles=rocks.triangles.count, instances=inst.count,
         proto_triangles=inst.n_tris, entries=inst.n_entries,
         proto_rows=int(inst.nodes.shape[0]), nn=rocks.accel.n_nodes,
         duplicated_triangles=dup.triangles.count,
         duplicated_nn=dup.accel.n_nodes)
    rocks_d = to_device(rocks, device)
    inst_d = rocks_d.instances
    # In lane order, as accel/instances.intersect hands rays to the walk.
    res["bvh_instanced"] += instanced_parity(
        "rocks/camera", inst_d, camera_rays(rocks_d, ropts, device))
    res["bvh_instanced"] += instanced_parity(
        "rocks/random", inst_d,
        torch.from_numpy(random_rays(1 << 18, 3)).to(device))
    ties, _ = load_scene_string(rocks_scene_text(
        base_text, N_ROCKS, ROCK_SUBDIV, ROCK_SEED, dup_every=DUP_EVERY))
    ties_d = to_device(ties, device)
    res["bvh_instanced"] += instanced_parity(
        f"rocks_ties(+{N_ROCKS // DUP_EVERY})/camera", ties_d.instances,
        camera_rays(ties_d, ropts, device), exact=True)
    del rocks_d, inst_d, ties, ties_d

    # 7. Main path, instancing: the rocks scene rendered through the tile
    # and instanced walks, against the same rocks duplicated.
    ropts = ropts._replace(chunk_size=1 << 17, half_readback=True)
    rgb, launches["rocks"], first_s, wall = render_path(
        "rocks", rocks, ropts, device, ["bvh_tiles", "bvh_instanced"])
    rgb_dup, launches["rocks/duplicated"], _, dup_wall = render_path(
        "rocks/duplicated", dup, ropts, device, ["bvh_tiles"])
    close = np.isclose(rgb, rgb_dup, atol=DUP_CLOSE, rtol=DUP_CLOSE).all(-1)
    share = float(close.mean())
    dmean = float(abs(rgb.mean() - rgb_dup.mean()) / rgb_dup.mean())
    samples = ropts.xres * ropts.yres * ropts.sampler.pixelsamples
    emit(phase="render", scene=f"rocks({N_ROCKS})", shape=list(rgb.shape),
         spp=ropts.sampler.pixelsamples, launches=launches["rocks"],
         finite=True, first_render_s=first_s, wall_s=wall,
         samples_per_s=samples / wall, duplicated_wall_s=dup_wall,
         duplicated_launches=launches["rocks/duplicated"],
         share_close_to_duplicated=share, share_limit=DUP_SHARE,
         close_atol_rtol=DUP_CLOSE, rel_mean_diff=dmean,
         rel_mean_diff_limit=DUP_MEAN)
    assert share >= DUP_SHARE and dmean <= DUP_MEAN, (share, dmean)
    if args.profile:
        profile_render(f"rocks({N_ROCKS})", rocks, ropts, device)
    del rocks, dup

    # 8. mt_best vs its plain version: config2/none, config4_big and the
    # adversarial set.
    t0 = time.perf_counter()
    c2, c2_opts = load_scene_string(config2_none_text())
    emit(phase="load", scene="config2/none", seconds=time.perf_counter() - t0,
         triangles=c2.triangles.count, quadrics=c2.quadrics.count,
         accel=None)
    assert c2.accel is None and c2.triangles.count == 1282
    c2_d = to_device(c2, device)
    tris = mt_cuda.pack_table(c2_d.triangles)
    res["mt_best"] = mt_parity("config2/camera", tris,
                               camera_rays(c2_d, c2_opts, device))
    res["mt_best"] += mt_parity(
        "config2/random", tris,
        torch.from_numpy(random_rays(1 << 18, 4)).to(device))
    c4_tris = mt_cuda.pack_table(to_device(scene.triangles, device))
    res["mt_best"] += mt_parity("config4_big/camera", c4_tris, c4_rays,
                                reps=3, modes=(False,))
    adv_tris, adv_rays = (torch.from_numpy(a).to(device)
                          for a in adversarial_mt_set(5))
    res["mt_best"] += mt_parity("adversarial", adv_tris, adv_rays)
    mt_pairs_parity("adversarial", adv_tris, adv_rays)
    del c2_d, tris, c4_rays, adv_tris, adv_rays

    # 9. Main path, no accelerator: config2/none at the file's settings
    # (128x128 x 32 spp) with bench.py's pool.
    ref2, _ = read_exr(GOLDEN2)
    c2_opts = c2_opts._replace(chunk_size=1 << 17, half_readback=True)
    rgb, launches["config2/none"], first_s, wall = render_path(
        "config2/none", c2, c2_opts, device, ["mt_best"])
    rel, mean = band(rgb, ref2)
    emit(phase="render", scene="config2/none", shape=list(rgb.shape),
         spp=c2_opts.sampler.pixelsamples, launches=launches["config2/none"],
         finite=True, band_rel=rel, band_rel_limit=BAND2_REL, band_mean=mean,
         band_mean_limit=BAND2_MEAN, first_render_s=first_s, wall_s=wall,
         samples_per_s=c2_opts.xres * c2_opts.yres *
         c2_opts.sampler.pixelsamples / wall)
    assert rel < BAND2_REL and mean < BAND2_MEAN, (rel, mean)
    if args.profile:
        profile_render("config2/none", c2, c2_opts, device)

    # 10. Main path, no accelerator, full width: config4_big with every
    # camera and shadow ray against all 99,458 triangles.
    none_scene = dataclasses.replace(scene, accel=None)
    rgb, launches["config4_big/none"], first_s, wall = render_path(
        "config4_big/none", none_scene, opts, device,
        ["mt_best", "mt_best_any"])
    rel, mean = band(rgb, ref)
    emit(phase="render", scene="config4_big/none", shape=list(rgb.shape),
         spp=opts.sampler.pixelsamples, launches=launches["config4_big/none"],
         finite=True, band_rel=rel, band_rel_limit=BAND_REL, band_mean=mean,
         band_mean_limit=BAND_MEAN, first_render_s=first_s, wall_s=wall,
         rays_per_s=CONFIG4_REF_RAYS / wall)
    assert rel <= BAND_REL and mean <= BAND_MEAN, (rel, mean)
    if args.profile:
        dispatch_turns("config4_big/none", none_scene, opts, device,
                       ("split", "fused"))
    # The render's own shadow batch (three fused any-hit segments of 2^17
    # lanes) through mt_best in any-hit mode.
    shadow = capture_rays(none_scene, opts, device, mt_cuda, "mt_best",
                          0)[True]
    res["mt_best"] += mt_parity("config4_big/shadow", c4_tris, shadow,
                                reps=3, modes=(True,), plain_reps=1)
    del shadow, c4_tris

    # 11. mt_best vs its plain version on bench3: its camera rays, and one
    # pass's NEE shadow batch (any hit) and BSDF-strategy batch (nearest)
    # as the render hands them to the kernel. A pass calls mt_best three
    # times (the bounce's rays, its shadow rays, its BSDF-strategy rays);
    # the pass with the most live shadow rays is taken: the first pass
    # covers the top rows, the ceiling above the down-facing light, where
    # no shadow ray is traced.
    t0 = time.perf_counter()
    b3, b3_opts = load_scene(BENCH3)
    emit(phase="load", scene="bench3", seconds=time.perf_counter() - t0,
         triangles=b3.triangles.count, quadrics=b3.quadrics.count,
         accel=None, integrator=b3_opts.integrator,
         max_depth=b3_opts.max_depth)
    assert b3.accel is None and b3_opts.integrator == "path"
    b3_opts = b3_opts._replace(chunk_size=1 << 17, half_readback=True)
    b3_d = to_device(b3, device)
    b3_tris = mt_cuda.pack_table(b3_d.triangles)
    res["mt_best"] += mt_parity("bench3/camera", b3_tris,
                                camera_rays(b3_d, b3_opts, device),
                                modes=(False,))
    first = capture_rays(b3, b3_opts, device, mt_cuda, "mt_best", 0,
                         period=3)
    shadow = first[(1, True)]
    res["mt_best"] += mt_parity("bench3/shadow", b3_tris, shadow,
                                modes=(True,))
    res["mt_best"] += mt_parity("bench3/bsdf", b3_tris, first[(2, False)],
                                modes=(False,))
    # What the front end's sort of any-hit rays (ray_order: key, argsort)
    # costs per call on this batch.
    box = (b3_d.world_bound_lo, b3_d.world_bound_hi)
    sort_ms, _, sort_host = timed(lambda: mt_cuda.ray_order(
        box, shadow[0:3].T, shadow[3:6].T, shadow[6], shadow[7]))
    emit(phase="sort", scene="bench3", set="bench3/shadow",
         rays=shadow.shape[1], ray_order_ms=sort_ms, host_ms=sort_host)
    del b3_d, b3_tris, first, shadow

    # 12. Main path, path mode: config3 at test_golden's 64 spp.
    c3, c3_opts = load_scene(CONFIG3)
    c3_opts = c3_opts._replace(
        sampler=c3_opts.sampler._replace(pixelsamples=CONFIG3_SPP),
        chunk_size=1 << 17, half_readback=True)
    ref3, _ = read_exr(GOLDEN3)
    rgb, launches["config3"], first_s, wall = render_path(
        "config3", c3, c3_opts, device, ["mt_best", "mt_best_any"])
    rel, mean = band(rgb, ref3)
    emit(phase="render", scene="config3", shape=list(rgb.shape),
         spp=CONFIG3_SPP, launches=launches["config3"], finite=True,
         band_rel=rel, band_rel_limit=BAND3_REL, band_mean=mean,
         band_mean_limit=BAND3_MEAN, first_render_s=first_s, wall_s=wall,
         samples_per_s=c3_opts.xres * c3_opts.yres * CONFIG3_SPP / wall)
    assert rel < BAND3_REL and mean < BAND3_MEAN, (rel, mean)

    # 13. Main path, path mode at full size: bench3 with bench.py's pool.
    rgb, launches["bench3"], first_s, wall = render_path(
        "bench3", b3, b3_opts, device, ["mt_best", "mt_best_any"])
    rgb_b3 = rgb                     # phase 27's reference
    emit(phase="render", scene="bench3", shape=list(rgb.shape),
         spp=b3_opts.sampler.pixelsamples, launches=launches["bench3"],
         finite=True, first_render_s=first_s, wall_s=wall,
         rays_per_s=BENCH3_REF_RAYS / wall,
         rays_per_s_first=BENCH3_REF_RAYS / first_s,
         samples_per_s=b3_opts.xres * b3_opts.yres *
         b3_opts.sampler.pixelsamples / wall)
    if args.profile:
        dispatch_turns("config2/none", c2, c2_opts, device)
        dispatch_turns("bench3", b3, b3_opts, device, ("split", "fused"))
    del b3, c2

    # 14. Main path, Whitted: config1 as its file asks, bench.py's pool.
    def golden_render(label, path, golden, band_limits, walks=(), need=(),
                      text=None):
        t0 = time.perf_counter()
        sc, so = load_scene_string(text) if text else load_scene(path)
        emit(phase="load", scene=label, seconds=time.perf_counter() - t0,
             triangles=sc.triangles.count, quadrics=sc.quadrics.count,
             accel=type(sc.accel).__name__, integrator=so.integrator,
             sampler=so.sampler._asdict())
        so = so._replace(chunk_size=1 << 17, half_readback=True)
        sc_d = to_device(sc, device)
        if walks:
            cam = camera_rays(sc_d, so, device)
            cam = cam[:, ::cam.shape[1] // WALK_RAYS].contiguous()
            for any_hit in walks:
                walk_timing(f"{label}/camera", sc_d, cam, any_hit)
            del cam
        rgb, launches[label], first_s, wall = render_path(label, sc, so,
                                                          device, need)
        rel, mean = band(rgb, read_exr(golden)[0])
        spp = smp.samples_per_pixel(so.sampler)
        emit(phase="render", scene=label, shape=list(rgb.shape), spp=spp,
             launches=launches[label], finite=True, band_rel=rel,
             band_rel_limit=band_limits[0], band_mean=mean,
             band_mean_limit=band_limits[1], first_render_s=first_s,
             wall_s=wall, samples_per_s=so.xres * so.yres * spp / wall)
        assert rel < band_limits[0] and mean < band_limits[1], (rel, mean)
        if args.profile:
            profile_render(label, sc, so, device)

    from tpuprt_torch.samplers import samplers as smp
    golden_render("config1", CONFIG1, GOLDEN1, (BAND1_REL, BAND1_MEAN))
    # 15. Main path, the uniform grid: config2 as its file asks.
    golden_render("config2/grid", CONFIG2, GOLDEN2, (BAND2_REL, BAND2_MEAN),
                  walks=(False,))
    # 16. Main path, the kd-tree: config4 as its file asks.
    golden_render("config4/kdtree", CONFIG4, GOLDEN4,
                  (BAND4_REL, BAND4_MEAN), walks=(False, True))

    # 17. Main path at 1M triangles: config5_huge with bench.py's options.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rgb, launches["config5_huge"], first_s, wall = render_path(
        "config5_huge", c5, c5_opts, device, ["bvh_tiles"])
    emit(phase="render", scene="config5_huge", shape=list(rgb.shape),
         spp=c5_opts.sampler.pixelsamples, triangles=ntris,
         launches=launches["config5_huge"], finite=True,
         load_s=c5_load_s, first_render_s=first_s, wall_s=wall,
         rays_per_s=CONFIG5_REF_RAYS / wall,
         peak_device_bytes=torch.cuda.max_memory_allocated())
    if args.profile:
        profile_render("config5_huge", c5, c5_opts, device)
    del c5

    # 18. mt_best vs its plain version on bench6 (photonmap, 10 triangles,
    # a disk light, a mirror sphere): the first shooting batch's rays at
    # depth 0 and 2, and, from a render with the maps built, its biggest
    # final-gather block (nearest) and NEE shadow batch (any hit).
    from tpuprt_torch.integrators import photonmap as pm
    t0 = time.perf_counter()
    b6, b6_opts = load_scene(BENCH6)
    prm6 = b6_opts.photon
    emit(phase="load", scene="bench6", seconds=time.perf_counter() - t0,
         triangles=b6.triangles.count, quadrics=b6.quadrics.count,
         accel=None, integrator=b6_opts.integrator, photon=prm6._asdict())
    assert b6.accel is None and b6_opts.integrator == "photonmap"
    b6_d = to_device(b6, device)
    b6_tris = mt_cuda.pack_table(b6_d.triangles)
    shots = []

    def shot_spy(rays, tris, any_hit=False):
        shots.append(rays.clone())
        return real_mt(rays, tris, any_hit=any_hit)
    with patched(mt_cuda, "mt_best", shot_spy) as real_mt:
        pm.shoot_batch(b6_d, 0, prm6.batch, prm6.shoot_depth, b6_opts.seed)
    for depth in (0, 2):
        res["mt_best"] += mt_parity(f"bench6/shoot_depth{depth}", b6_tris,
                                    shots[depth], modes=(False,))
    del shots

    # 19. bench6's photon maps, built on the card.
    photons6 = {}
    maps6 = photon_maps("bench6", b6_d, prm6, b6_opts.seed, photons6)
    got = capture_rays(b6, b6_opts, device, mt_cuda, "mt_best", 0,
                       maps=maps6)
    assert got[False].shape[1] > b6_opts.chunk_size, got[False].shape
    res["mt_best"] += mt_parity("bench6/gather", b6_tris, got[False],
                                modes=(False,))
    res["mt_best"] += mt_parity("bench6/shadow", b6_tris, got[True],
                                modes=(True,))
    if args.profile:
        lookup_turns("bench6/gather", b6_d, maps6, got[False])
    del got, maps6, b6_d, b6_tris

    # 20. Main path, photonmap: config6 as its file asks (64x64 x 4 spp,
    # final gather of 8) inside golden6's band.
    golden_render("config6", CONFIG6, GOLDEN6, (BAND6_REL, BAND6_MEAN),
                  need=["mt_best", "mt_best_any"])
    # 21. Main path, photonmap at full size: bench6 (final gather of 16)
    # and bench6ng (none) as bench.py's bench_config6 times them.
    for label, path in (("bench6", BENCH6), ("bench6ng", BENCH6NG)):
        r = photon_render(label, path, device,
                          ref_exr=path.replace(".pbrt", ".exr"))
        launches[label] = r["launches"]
    if args.profile:
        profile_render("bench6", b6, b6_opts._replace(half_readback=True),
                       device, ranges=(
                           ("photon_lookup", pm, "lphoton"),
                           ("photon_radiance", pm, "photon_radiance"),
                           ("build_maps", pm, "build_maps")))
    del b6
    # 22. A BVH that holds quadrics: config2 with Accelerator "bvh" (its
    # plain skip-link walk timed on 2^17 camera rays), inside golden2's
    # band.
    with open(CONFIG2) as f:
        c2_bvh = f.read().replace('Accelerator "grid"', 'Accelerator "bvh"')
    golden_render("config2/bvh", CONFIG2, GOLDEN2, (BAND2_REL, BAND2_MEAN),
                  walks=(False, True), text=c2_bvh)

    # 23. mt_best vs its plain version on the chunked paths' sets.
    for label, (tris, rays, any_hit) in gi_sets(device).items():
        res["mt_best"] += mt_parity(label, tris, rays, modes=(any_hit,))
    # 24. Main path, the chunked driver: configs 7-10 at test_golden's
    # settings inside their bands.
    for name, (spp, rel_lim, mean_lim) in GI_GOLDEN.items():
        r = gi_render(name, gi_text(name, spp=spp), device, 1,
                      os.path.join(ROOT, "scenes", f"golden{name[6:]}.exr"),
                      (rel_lim, mean_lim))
        launches[name] = r["launches"]
    # 25. The same four at bench6's film, each file's spp, as bench.py's
    # bench_config6 times bench6: the first run and the best of 2.
    for name in GI_GOLDEN:
        label = f"{name}/{GI_RES}"
        r = gi_render(label, gi_text(name, res=GI_RES), device, 2)
        launches[label] = r["launches"]
        if args.profile:
            scene, opts = load_scene_string(gi_text(name, res=GI_RES))
            profile_render(label, scene, opts._replace(half_readback=True),
                           device)

    # 26-28. The lights and textures.
    light_phases(device, launches, res, rgb_b3, photons6, args.profile)
    del rgb_b3
    # 29. The scan driver against the pool; 30-31. gradients.
    t0 = time.perf_counter()
    scan_phase(device, launches)
    grad_phases(device, launches)
    emit(phase="scan_grad", seconds=time.perf_counter() - t0)
    # 32. The boundary gradients; 33. several devices.
    t0 = time.perf_counter()
    boundary_phases(device, launches)
    shard_phase(device, launches)
    emit(phase="boundary_shard", seconds=time.perf_counter() - t0)
    # 34. Every material; 35. every camera and pixel filter.
    t0 = time.perf_counter()
    shading_phases(device, launches, res)
    emit(phase="shading", seconds=time.perf_counter() - t0)

    # 36-37. Volumes and the rest of instancing.
    t0 = time.perf_counter()
    volume_phases(device, launches, res)
    emit(phase="volumes", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    instancing_phases(device, launches, res)
    emit(phase="instancing", seconds=time.perf_counter() - t0)
    # 38. The CLI.
    t0 = time.perf_counter()
    operability_phase(device, launches, c4_walls)
    emit(phase="operability", seconds=time.perf_counter() - t0)

    print(smi, flush=True)
    path_of = {"bvh_tiles": "config4_big", "bvh_rows": "config4_big/rows",
               "bvh_instanced": "rocks", "mt_best": "config4_big/none"}
    source = {"bvh_tiles": bvh_cuda.KERNEL_SRC, "bvh_rows": bvh_cuda.ROWS_SRC,
              "bvh_instanced": bvh_cuda.ROWS_SRC, "mt_best": mt_cuda.MT_SRC}
    kernels = []
    for name, rs in res.items():
        # The camera rays, nearest; mt_best on config4_big's, the shape of
        # its main path at full width.
        timed_on = rs[0]
        if name == "mt_best":
            timed_on = next(r for r in rs if r["set"] == "config4_big/camera")
        src = source[name]
        entry = dict(
            name=name, route="cuda", source=os.path.relpath(src, ROOT),
            replaces=REPLACES[name], also_replaces=ALSO_REPLACES.get(name),
            launches=launches[path_of[name]][name],
            launches_any_hit=launches[path_of[name]].get(name + "_any"),
            # The instanced walk's any-hit result may be another hit than
            # the plain version's (its entries come in another order): only
            # its mask is held there.
            max_abs_err=max(r["max_abs_err"] for r in rs
                            if r["mode"] == "nearest" or
                            name != "bvh_instanced"),
            ms=timed_on["ms"], plain_ms=timed_on["plain_ms"],
            bound_ms=timed_on["bound_ms"], bound_by=timed_on["bound_by"],
            library_ms=None, steps_per_ray=timed_on.get("steps_per_ray"),
            timed_on=f"{timed_on['set']}, {timed_on['mode']}",
            launches_on=path_of[name],
            parity=[{k: r[k] for k in ("set", "mode", "hit_mask_mismatch",
                                       "id_mismatch", "t_rel_max", "ms",
                                       "plain_ms", "bound_ms",
                                       "fmad_floor_ms")}
                    for r in rs])
        if name == "bvh_tiles":
            # The scan driver's and the gradients' paths (phases 29, 30).
            entry["config4_big_scan_launches"] = \
                launches["config4_big/scan"]["bvh_tiles"]
            entry["config4_big_grad_launches"] = \
                launches["grad/config4_big"]["bvh_tiles"]
            # The boundary step's (phase 32, per step) and the sharded
            # render's over a world of 1 (phase 33), by mode.
            for p in ("grad/config4_big/boundary", "config4_big/shard"):
                key = p.replace("/", "_")
                entry[f"{key}_launches"] = launches[p]["bvh_tiles"]
                entry[f"{key}_launches_any_hit"] = \
                    launches[p]["bvh_tiles_any"]
            entry["config5_huge_launches"] = \
                launches["config5_huge"]["bvh_tiles"]
            # The lights and textures path (phase 26) and its sets.
            entry["config4_big_lit_launches"] = \
                launches["config4_big/lit"]["bvh_tiles"]
            # The cameras and filters (phase 35), by mode.
            for p in ("config4_big/mitchell", "config4_big/thinlens",
                      "config4_big/ortho", "config4_big/env"):
                key = p.replace("/", "_")
                entry[f"{key}_launches"] = launches[p]["bvh_tiles"]
                entry[f"{key}_launches_any_hit"] = \
                    launches[p]["bvh_tiles_any"]
            entry["light_sets"] = light_sets(rs, "config4_big/lit/")
            # The volumes (phase 36) by mode, and the instanced scenes'
            # top-level walk (phase 37).
            for p in ("config4_big/fog", "config4_big/fog/scan",
                      "rocks/loop", "rocks/lamps", "rocks/lamps/inline"):
                key = p.replace("/", "_")
                entry[f"{key}_launches"] = launches[p]["bvh_tiles"]
                entry[f"{key}_launches_any_hit"] = \
                    launches[p]["bvh_tiles_any"]
            entry["volume_sets"] = light_sets(rs, "config4_big/fog/")
            # The CLI's render of the split config4_big (phase 38).
            entry["config4_big_cli_launches"] = \
                launches["config4_big/cli"]["bvh_tiles"]
            entry["config4_big_cli_launches_any_hit"] = \
                launches["config4_big/cli"]["bvh_tiles_any"]
        if name == "bvh_instanced":
            # The Loop-subdivided rocks and the instanced lamps (phase
            # 37), the lamps' set.
            for p in ("rocks/loop", "rocks/lamps"):
                entry[f"{p.replace('/', '_')}_launches"] = \
                    launches[p]["bvh_instanced"]
            entry["lamp_sets"] = light_sets(rs, "rocks/lamps/")
        if name == "mt_best":
            # bench3's path: its launches by mode and its camera set.
            b3_cam = next(r for r in rs if r["set"] == "bench3/camera")
            entry.update(
                # The triangle-mesh emitters (phases 27 and 28).
                **{f"{p.replace('/', '_')}_launches": launches[p]["mt_best"]
                   for p in ("bench3/meshlight", "bench6/meshlight")},
                **{f"{p.replace('/', '_')}_launches_any_hit":
                   launches[p]["mt_best_any"]
                   for p in ("bench3/meshlight", "bench6/meshlight")},
                bench3_launches=launches["bench3"]["mt_best"],
                bench3_launches_any_hit=launches["bench3"]["mt_best_any"],
                # The scan driver's and the gradients' paths (phases 29,
                # 31): launches by mode.
                **{f"{p.replace('/', '_')}_launches": launches[p]["mt_best"]
                   for p in ("bench3/scan", "grad/bench3")},
                **{f"{p.replace('/', '_')}_launches_any_hit":
                   launches[p]["mt_best_any"]
                   for p in ("bench3/scan", "grad/bench3")},
                bench3_camera={k: b3_cam[k] for k in (
                    "ms", "host_ms", "plain_ms", "bound_ms", "bound_by")},
                # The photonmap paths: launches by mode, bench6's sets.
                **{f"{p}_launches": launches[p]["mt_best"]
                   for p in ("config6", "bench6", "bench6ng")},
                **{f"{p}_launches_any_hit": launches[p]["mt_best_any"]
                   for p in ("config6", "bench6", "bench6ng")},
                bench6_sets={r["set"]: {k: r[k] for k in (
                    "rays", "mode", "ms", "host_ms", "plain_ms", "bound_ms",
                    "bound_by")} for r in rs if r["set"].startswith(
                        "bench6/")},
                # The chunked driver's paths (configs 7-10 at test_golden's
                # settings and at 256^2): launches by mode, their sets.
                gi_launches={p: {"nearest": launches[p]["mt_best"] -
                                 launches[p]["mt_best_any"],
                                 "any": launches[p]["mt_best_any"]}
                             for p in launches if p.startswith(
                                 tuple(GI_GOLDEN))},
                gi_sets={r["set"]: {k: r[k] for k in (
                    "rays", "mode", "ms", "host_ms", "plain_ms", "bound_ms",
                    "bound_by")} for r in rs if r["set"].startswith(
                        tuple(GI_GOLDEN))},
                # The mesh emitter's sets (phase 27).
                light_sets=light_sets(rs, "bench3/meshlight/"),
                # The materials (phase 34): launches by mode, its sets.
                bench3_materials_launches=launches[
                    "bench3/materials"]["mt_best"],
                bench3_materials_launches_any_hit=launches[
                    "bench3/materials"]["mt_best_any"],
                materials_sets=light_sets(rs, "bench3/materials/"),
                # The volumes (phase 36): launches by mode, the set.
                **{f"{p.replace('/', '_')}_launches": launches[p]["mt_best"]
                   for p in ("bench3/smoke", "bench3/smoke/scan",
                             "bench6/fog")},
                **{f"{p.replace('/', '_')}_launches_any_hit":
                   launches[p]["mt_best_any"]
                   for p in ("bench3/smoke", "bench3/smoke/scan",
                             "bench6/fog")},
                volume_sets=light_sets(rs, "bench3/smoke/"),
                # One boundary gradient of each FD scene (phase 32), by
                # mode.
                boundary_launches={
                    p[len("boundary/"):]: {
                        "nearest": launches[p]["mt_best"] -
                        launches[p]["mt_best_any"],
                        "any": launches[p]["mt_best_any"]}
                    for p in launches if p.startswith("boundary/")})
        kernels.append(entry)
    emit(kernels=kernels,
         library_note="no PyTorch call computes a BVH walk or a nearest "
         "ray-triangle hit")
    emit(ok=True, device=dict(platform="gpu",
                              kind=torch.cuda.get_device_name(0),
                              count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
