"""Wavefront rendering with path regeneration (port of
tpuprt/integrators/path_wavefront.py, modes "path", "directlighting" with
its strategies "all", "one" and "weighted", "whitted" and "photonmap").

One fixed-size lane pool; the moment a lane's path ends, its radiance is
splatted to the film and the lane restarts with the next (pixel, sample)
from a global cursor. Every random stream is a pure function of (pixel,
sample index, bounce, purpose) with the reference's purposes and salts, so
each camera sample computes what the JAX package computes, and the
developed image matches it up to the order of the film's sums.

Mode "path" is path.cpp:58-145: one-light MIS next-event estimation, Le
only on the first vertex and after a specular bounce, the full BSDF
continuation, Russian roulette with probability 0.5 from bounce 3 on.
Mode "directlighting" is directlighting.cpp: at every vertex every light
("all"), one light picked uniformly ("one") or by its power ("weighted"),
and a specular-only continuation. Mode "whitted" is whitted.cpp:44-140:
every light with one sample and no MIS, a specular-only continuation that
carries the ray differentials across bounces. Mode "photonmap" is
photonmap.cpp:299-431: Le at every hit, at every vertex the photon maps'
radiance core (integrators/photonmap.photon_radiance: all lights' direct
lighting, the caustic map, the indirect map or the final gather), and the
specular-only continuation.

On a CUDA device the host issues a pass's several thousand small ops one
at a time, far slower than the card runs them. Where a pass is known to
run without a host sync (`graphed`), render() runs the first pass eagerly,
records the next as a CUDA graph whose last ops write its results back
over the state it read, and replays that graph for every later pass.

Volumes (path_wavefront.py:219-261) compose as the chunked driver does
(render.compose_volumes): on bounce 0 the camera segment's transmittance
multiplies the throughput before any radiance is added, and the volume
integrator's Lv is added once; in mode "path" every later segment is
attenuated too (path.cpp:89). Both are computed on the lanes they apply to
only: Lv, whose single-scattering march costs 32 shadow rays a lane, on
the live bounce-0 lanes, each of whose draws is keyed by (pixel, sample,
step, purpose), so no sample's value changes.
"""
from __future__ import annotations

import math
import warnings

import torch

from ..accel import intersect as isect
from ..bsdf import bsdf as B
from ..cameras import cameras as cam_mod
from ..core import rng, vecmath as vm
from ..film import film as film_mod
from ..lights import lights as lt
from .. import ops
from ..samplers import samplers as smp
from ..scene.data import LIGHT_AREA, BvhAccel, SceneData
from ..utils.progress import ProgressReporter
from ..utils.stats import span
from ..volumes import regions as vr
from . import common, photonmap, volume

_EPS = vm.RAY_EPSILON
# Each mode's salt of the per-pixel hash (path_wavefront.py:220-221).
SALTS = {"path": 0xBA5E, "directlighting": 0xD112, "whitted": 0x817,
         "photonmap": 0x9B1}
# Russian roulette from this bounce on (path_wavefront.py:434, :478).
RR_START = 3
# The modes whose pass showed no host sync on the card, one frame each
# under torch.cuda.set_sync_debug_mode("warn") (PERF.md §6); photonmap's
# lookups in its photon grids read counts on the host.
GRAPH_MODES = frozenset({"path", "directlighting", "whitted"})


def _regen(scene: SceneData, cfg, lin, seed, xres, yres, xstart, xcount,
           ystart, spp):
    """Fresh camera rays (+x/+y differentials) for linear sample ids.
    lin is int64 (the reference's uint32 ids, path_wavefront.py:85)."""
    s_idx = (lin % spp).to(torch.int32)
    pix = lin // spp
    px = (xstart + pix % xcount).to(torch.int32)
    py = (ystart + pix // xcount).to(torch.int32)
    cs = smp.camera_samples(cfg, px, py, s_idx, seed)
    ix, iy = cs["image_x"], cs["image_y"]
    # The differential rays keep the lens and time samples
    # (path_wavefront.py:91-99).
    lens = (cs["lens_u"], cs["lens_v"], cs["time"], xres, yres)
    o, d, mint, maxt, _ = cam_mod.generate_rays(scene.camera, ix, iy, *lens)
    o_rx, d_rx = cam_mod.generate_rays(scene.camera, ix + 1.0, iy, *lens)[:2]
    o_ry, d_ry = cam_mod.generate_rays(scene.camera, ix, iy + 1.0, *lens)[:2]
    return dict(px=px, py=py, s_idx=s_idx, ix=ix, iy=iy, o=o, d=d,
                mint=mint, maxt=maxt, rx_o=o_rx, rx_d=d_rx, ry_o=o_ry,
                ry_d=d_ry)


def _volumes(scene: SceneData, st, t, hit, alive, first, ph, seed, path,
             vol_integrator):
    """The pass's volume terms (the module's docstring): (throughput, L)
    with the segments' transmittance and bounce 0's Lv."""
    seg_end = torch.where(hit, t, st["maxt"])
    ph_cam = rng.hash_u32(st["px"], st["py"], seed, 0xF0)
    u_cam = rng.uniform(ph_cam, st["s_idx"], 0x7A)
    u = torch.where(first, u_cam, rng.uniform(
        ph, st["s_idx"], st["bounce"], 0x77)) if path else u_cam
    with span("sync"):
        k = torch.nonzero(alive if path else first & alive).squeeze(1)
    tp = st["throughput"].clone()
    tp[k] = tp[k] * vr.transmittance(scene.volumes, st["o"][k], st["d"][k],
                                     st["mint"][k], seg_end[k], u[k])
    with span("sync"):
        k = torch.nonzero(first & alive).squeeze(1)
    seg = (st["o"][k], st["d"][k], st["mint"][k], seg_end[k])
    Lv = volume.li_single(scene, *seg, ph_cam[k], st["s_idx"][k], seed) \
        if vol_integrator == "single" else \
        volume.li_emission(scene, *seg, u_cam[k])
    L = st["L"].clone()
    L[k] = L[k] + Lv
    return tp, L


def _step(scene: SceneData, film, st, cursor, cfg, seed, max_depth, total,
          xres, yres, xstart, xcount, ystart, spp, filter_kind,
          filter_xwidth, filter_ywidth, mode, strategy="all", sel=None,
          maps=None, prm=None, vol_integrator="emission"):
    """One wavefront pass (path_wavefront.py:181-420) in `mode` ("path",
    "directlighting" with its `strategy` and, for "weighted", the light
    distribution `sel`, "whitted" or "photonmap", whose PhotonMaps and
    PhotonParams are `maps` and `prm`) with the volume integrator
    `vol_integrator`: bounce every live lane once, splat + regenerate
    finished lanes. Returns (state, cursor, lanes live at the pass's start,
    lanes that hit: its NEE shadow rays), the counts as device tensors."""
    alive = st["alive"]
    n_active = alive.sum()
    px, py, s_idx, bounce = st["px"], st["py"], st["s_idx"], st["bounce"]
    ro, rd = st["o"], st["d"]
    throughput, L = st["throughput"], st["L"]
    specular, alpha = st["specular"], st["alpha"]
    first = bounce == 0
    path = mode == "path"
    ph = rng.hash_u32(px, py, seed, SALTS[mode])

    t, pid, hit = isect.intersect_ids(scene, ro, rd, st["mint"], st["maxt"])

    if vr.present(scene.volumes):
        throughput, L = _volumes(scene, st, t, hit, alive, first, ph, seed,
                                 path, vol_integrator)

    if scene.lights.infinite_meta:
        # Escape radiance on a miss of a live lane: in path mode only on
        # the first vertex or after a specular bounce.
        take_le = ~hit & alive
        if path:
            take_le = take_le & (first | specular)
        Lesc = lt.le_escaped(scene, rd)
        L = L + torch.where(take_le[..., None], throughput * Lesc, 0.0)
        alpha = torch.where(take_le & first & torch.any(Lesc > 0, -1), 1.0,
                            alpha)
    alive = alive & hit
    alpha = torch.where(first & hit, 1.0, alpha)
    # Vertices shaded this pass: tpuprt's count of NEE shadow rays
    # (path_wavefront.py:277-279).
    n_shadow = alive.sum()

    dg = isect.hit_geometry(scene, pid, ro, rd, t)
    # Whitted needs the differentials at every bounce (they propagate
    # through its specular continuation), the others at the first.
    dg = isect.compute_differentials(dg, st["rx_o"], st["rx_d"],
                                     st["ry_o"], st["ry_d"],
                                     alive if mode == "whitted"
                                     else first & alive)
    if LIGHT_AREA in scene.lights.kinds_present:
        # Emitted radiance at a live hit (path_wavefront.py:286-289): in
        # path mode only on the first vertex or after a specular bounce.
        emit_ok = alive & (first | specular) if path else alive
        Le = lt.area_emission(scene, dg["area_light"], dg["nn"], -rd)
        L = L + torch.where(emit_ok[..., None], throughput * Le, 0.0)
    bsdf = common.make_bsdf_at(scene, dg)
    p, ns = dg["p"], bsdf.nn
    wo = -rd
    if scene.lights.count > 0:
        with span("light"):
            if mode == "whitted":
                Ld = common.whitted_ld(scene, p, ns, wo, bsdf, ph, s_idx,
                                       bounce, alive)
            elif mode == "photonmap":
                Ld = photonmap.photon_radiance(scene, maps, prm, bsdf, wo,
                                               p, ns, alive, ph, s_idx,
                                               bounce)
            else:
                # Path mode samples one light uniformly (path.cpp:
                # 99-110).
                Ld = common.direct_ld(scene, cfg,
                                      "one" if path else strategy, sel, p,
                                      ns, wo, bsdf, ph, px, py, s_idx,
                                      bounce, seed, alive)
            L = L + torch.where(alive[..., None], throughput * Ld, 0.0)

    if path:
        # The full BSDF continuation (path_wavefront.py:319-322).
        c1, c2 = smp.integrator_2d(cfg, px, py, s_idx, bounce, 20, seed)
        c3 = smp.integrator_1d(cfg, px, py, s_idx, bounce, 21, seed)
        bs = B.sample_f(bsdf, wo, c1, c2, c3, B.ALL)
    else:
        # Specular-only continuation (directlighting.cpp, whitted.cpp,
        # photonmap.cpp:366-425).
        c1 = rng.uniform(ph, s_idx, bounce, 0x5A, 1)
        c2 = rng.uniform(ph, s_idx, bounce, 0x5A, 2)
        c3 = rng.uniform(ph, s_idx, bounce, 0x5A, 3)
        bs = B.sample_f(bsdf, wo, c1, c2, c3,
                        B.SPECULAR | B.REFLECTION | B.TRANSMISSION)
    cont = alive & bs["valid"] & (bs["pdf"] > 0.0) & \
        ~torch.all(bs["f"] == 0.0, dim=-1) & (bounce < max_depth)
    scale = bs["f"] * (vm.absdot(bs["wi"], ns) /
                       torch.clamp(bs["pdf"], min=1e-20))[..., None]
    throughput = torch.where(cont[..., None], throughput * scale, throughput)
    specular = torch.where(cont, bs["specular"], specular)
    rx_o, rx_d, ry_o, ry_d = st["rx_o"], st["rx_d"], st["ry_o"], st["ry_d"]
    if mode == "whitted":
        # The continuation carries its ray differentials (whitted.cpp:
        # 88-136).
        nrxo, nrxd, nryo, nryd = common.specular_ray_differentials(
            dg, ns, wo, bs["wi"], rx_d, ry_d, bs["eta"],
            (bs["flags"] & B.TRANSMISSION) > 0)
        m = cont[..., None]
        rx_o, rx_d = torch.where(m, nrxo, rx_o), torch.where(m, nrxd, rx_d)
        ry_o, ry_d = torch.where(m, nryo, ry_o), torch.where(m, nryd, ry_d)
    alive = cont
    if path:
        # Russian roulette (path_wavefront.py:352-359).
        u_rr = rng.uniform(ph, s_idx, bounce, 30)
        do_rr = bounce >= RR_START
        alive = alive & (~do_rr | (u_rr < 0.5))
        throughput = torch.where((alive & do_rr)[..., None],
                                 throughput / 0.5, throughput)
    ro, rd = p, bs["wi"]
    bounce = bounce + 1

    with span("film"):           # finish and splat
        finished = st["alive"] & ~alive
        bad = torch.any(~torch.isfinite(L) | (L < 0.0), dim=-1)
        Ls = torch.where((finished & ~bad)[..., None], L, 0.0)
        film_mod.add_samples(film, torch.where(finished, st["ix"], -1e6),
                             torch.where(finished, st["iy"], -1e6), Ls,
                             torch.where(finished, alpha, 0.0),
                             filter_kind, filter_xwidth, filter_ywidth)

    with span("camera"):         # regenerate
        dead = ~alive
        slot = torch.cumsum(dead.to(torch.int64), 0) - dead.to(torch.int64)
        new_lin = cursor + slot
        regen = dead & (new_lin < total)
        fresh = _regen(scene, cfg, torch.where(regen, new_lin, 0), seed,
                       xres, yres, xstart, xcount, ystart, spp)

        def sel(new, old):
            m = regen
            while m.dim() < new.dim():
                m = m[..., None]
            return torch.where(m, new, old)

        st_out = dict(
            alive=alive | regen,
            px=sel(fresh["px"], px), py=sel(fresh["py"], py),
            s_idx=sel(fresh["s_idx"], s_idx),
            bounce=torch.where(regen, 0, bounce),
            ix=sel(fresh["ix"], st["ix"]), iy=sel(fresh["iy"], st["iy"]),
            o=sel(fresh["o"], ro), d=sel(fresh["d"], rd),
            mint=sel(fresh["mint"], torch.full_like(st["mint"], _EPS)),
            maxt=sel(fresh["maxt"], torch.full_like(st["maxt"], 1e30)),
            rx_o=sel(fresh["rx_o"], rx_o), rx_d=sel(fresh["rx_d"], rx_d),
            ry_o=sel(fresh["ry_o"], ry_o), ry_d=sel(fresh["ry_d"], ry_d),
            throughput=sel(torch.ones_like(throughput), throughput),
            L=sel(torch.zeros_like(L), L),
            alpha=torch.where(regen, 0.0, alpha),
            specular=torch.where(regen, False, specular),
        )
        cursor = cursor + regen.sum()
    return st_out, cursor, n_active, n_shadow


def _init(scene, cfg, seed, n_lanes, total, xres, yres, xstart, xcount,
          ystart, spp, device):
    """Initial fill: lanes 0..n_lanes-1 take the first sample ids."""
    lin0 = torch.arange(n_lanes, dtype=torch.int64, device=device)
    fresh = _regen(scene, cfg, torch.clamp(lin0, max=total - 1), seed, xres,
                   yres, xstart, xcount, ystart, spp)
    z3 = torch.zeros((n_lanes, 3), dtype=torch.float32, device=device)
    st = {k: fresh[k] for k in ("px", "py", "s_idx", "ix", "iy", "o", "d",
                                "mint", "maxt", "rx_o", "rx_d", "ry_o",
                                "ry_d")}
    st.update(alive=lin0 < total,
              bounce=torch.zeros(n_lanes, dtype=torch.int32, device=device),
              throughput=z3 + 1.0, L=z3,
              alpha=torch.zeros(n_lanes, dtype=torch.float32, device=device),
              specular=torch.zeros(n_lanes, dtype=torch.bool, device=device))
    return st


def graphed(scene: SceneData, mode: str, device) -> bool:
    """Whether render() records a pass as a CUDA graph and replays it: on
    a CUDA device, in a mode of GRAPH_MODES, where the kernels walk the
    main aggregate (the brute force, or a BVH of triangles only) and there
    are no volume regions. The grid's, the kd-tree's and a quadric BVH's
    plain walks and the volume terms pick their rays with nonzero, whose
    count the host reads."""
    accel = scene.accel
    kernel_walk = accel is None or \
        isinstance(accel, BvhAccel) and not accel.n_quadrics
    return torch.device(device).type == "cuda" and mode in GRAPH_MODES \
        and kernel_walk and not vr.present(scene.volumes)


def recorded_launches(counters, record):
    """Run `record`, a capture, and return by counter what the kernels'
    launch counters (ops.launch_counters) rose by meanwhile, with each
    counter set back: a capture launches nothing, its replays that much."""
    before = [dict(c) for c in counters]
    record()
    rose = [{k: c[k] - b[k] for k in c} for c, b in zip(counters, before)]
    for c, b in zip(counters, before):
        c.update(b)
    return rose


def count_launches(counters, rose):
    """Add one replay's launches (recorded_launches) to the counters."""
    for c, r in zip(counters, rose):
        for k, v in r.items():
            c[k] += v


def in_place(step, st, cursor):
    """step(st, cursor) with its state and cursor copied over st and
    cursor: the pass's counts (n_active, n_shadow)."""
    out, cur, n_active, n_shadow = step(st, cursor)
    for k, v in out.items():
        st[k].copy_(v)
    cursor.copy_(cur)
    return n_active, n_shadow


class _PassGraph:
    """One in_place pass recorded as a CUDA graph on the state's device, so
    that each replay() runs the next pass on the same tensors. n_active and
    n_shadow hold the last replay's counts."""

    def __init__(self, step, st, cursor):
        self.device = st["alive"].device
        self.graph = torch.cuda.CUDAGraph()
        self.counters = ops.launch_counters()
        self.launches = recorded_launches(
            self.counters, lambda: self._record(step, st, cursor))

    def _record(self, step, st, cursor):
        # The state's device, which need not be the current one, records
        # on a stream other than its default one.
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side), \
                    warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                self.graph.capture_begin()
                self.n_active, self.n_shadow = in_place(step, st, cursor)
                self.graph.capture_end()
            torch.cuda.current_stream().wait_stream(side)
        for w in caught:
            # PyTorch only warns of a graph that recorded no kernel, whose
            # replays would leave the frame at its first passes.
            if "Graph is empty" in str(w.message):
                raise RuntimeError(f"the pool's pass on {self.device} was "
                                   f"recorded as an empty graph: {w.message}")
            warnings.warn_explicit(w.message, w.category, w.filename,
                                   w.lineno)

    def replay(self):
        with torch.cuda.device(self.device):
            self.graph.replay()
        count_launches(self.counters, self.launches)


def render(scene: SceneData, opts, device, maps=None, progress=False,
           stats=None):
    """Full-frame wavefront render of a scene whose tables live on
    `device`. Returns (rgb, alpha) as numpy f32 arrays. Mode "photonmap"
    renders with `maps` (photonmap.PhotonMaps on `device`), shooting them
    first when none are given (path_wavefront.py:541-545). progress: a
    ProgressReporter bar over the samples started, read once a pass.
    stats: a StatsRegistry, given tpuprt's counters (path_wavefront.py:
    608-614), summed on the device and read once after the last pass, and
    where `graphed` holds, "Wavefront / Graph passes": the passes replayed
    from the graph recorded for this call (freed when it returns)."""
    if opts.integrator not in SALTS:
        raise NotImplementedError(
            f'integrator "{opts.integrator}" has no wavefront pool (path, '
            'directlighting, whitted and photonmap have)')
    strategy = opts.direct_strategy
    # "weighted" picks by the lights' power, its distribution built once a
    # render (tpuprt builds it at every pass, with the same result).
    sel = common.weighted_selection(scene) \
        if strategy == "weighted" and opts.integrator == "directlighting" \
        else None
    prm = None
    if opts.integrator == "photonmap":
        prm = opts.photon or photonmap.PhotonParams()
        if maps is None:
            maps = photonmap.build_maps(scene, prm, opts.seed)
    film = film_mod.make_film(opts.xres, opts.yres, opts.crop, device)
    xstart, xcount, ystart, ycount = film_mod.pixel_extent(film)
    spp = smp.samples_per_pixel(opts.sampler)
    total = xcount * ycount * spp
    n_lanes = int(min(opts.chunk_size, total))
    kw = dict(cfg=opts.sampler, seed=opts.seed, total=total, xres=opts.xres,
              yres=opts.yres, xstart=xstart, xcount=xcount, ystart=ystart,
              spp=spp)
    with span("camera"):
        st = _init(scene, n_lanes=n_lanes, device=device, **kw)
        # Filled on the device: a tensor copied from the host would wait
        # for the device.
        cursor = torch.full((), n_lanes, dtype=torch.int64, device=device)
    # Loose bound against bugs: every sample ends within max_depth + 1
    # passes of its regeneration.
    pass_limit = math.ceil(total * (opts.max_depth + 2) / n_lanes) + \
        opts.max_depth + 8
    rep = ProgressReporter(total, "Rendering") if progress else None

    def step(st, cursor):
        return _step(scene, film, st, cursor, max_depth=opts.max_depth,
                     filter_kind=opts.filter_kind,
                     filter_xwidth=opts.filter_xwidth,
                     filter_ywidth=opts.filter_ywidth, mode=opts.integrator,
                     strategy=strategy, sel=sel, maps=maps, prm=prm,
                     vol_integrator=opts.volume_integrator, **kw)

    record = graphed(scene, opts.integrator, device)
    graph = None
    segments = shadow = 0
    passes = replays = done = 0
    for _ in range(pass_limit):
        # The pass's film, camera and light spans nest inside "shade".
        with span("shade"):
            if graph is None and record and passes:
                # The frame's ints (seed, crop, total) are baked in.
                graph = _PassGraph(step, st, cursor)
            if graph is None:
                st, cursor, n_active, n_shadow = step(st, cursor)
            else:
                graph.replay()
                replays += 1
                n_active, n_shadow = graph.n_active, graph.n_shadow
        passes += 1
        if stats is not None:
            segments, shadow = segments + n_active, shadow + n_shadow
        if rep is not None:
            with span("sync"):
                started = int(cursor)
            rep.update(started - done)
            done = started
        with span("sync"):
            live = bool(st["alive"].any())
        if not live:
            break
    if rep is not None:
        rep.done()
    if stats is not None:
        with span("sync"):
            segments = float(segments)
        with span("sync"):
            shadow = float(shadow)
        stats.add("Wavefront", "Passes", passes)
        if record:
            stats.add("Wavefront", "Graph passes", replays)
        stats.add("Wavefront", "Path segments traced", segments)
        stats.add("Wavefront", "Shadow rays traced", shadow)
        stats.add_ratio("Wavefront", "Lane occupancy", segments,
                        float(passes) * n_lanes)
        stats.add("Camera", "Samples taken", total)
    with span("film"):
        rgb, alpha = film_mod.develop(film)
        if opts.half_readback:
            rgb, alpha = film_mod.to_half(rgb, alpha)
    return film_mod.readback(rgb), film_mod.readback(alpha)
