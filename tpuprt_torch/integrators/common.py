"""Direct-lighting estimators shared by the wavefront integrators (port of
tpuprt/integrators/common.py: make_bsdf_at with bump mapping,
specular_ray_differentials,
batched_visibility, estimate_direct_multi, estimate_direct,
uniform_sample_one_light and uniform_sample_all_lights;
core/transport.cpp:31-70, 123-194), the direct lighting of the
directlighting, path and whitted integrators, which the pool and the scan
forms share, and the scan driver's Li loop.

The two-strategy MIS of EstimateDirect (light sampling with visibility +
BSDF sampling, power heuristic) is kept exactly, as is the reference's
dispatch of the rays: on a scene with an accelerator every light's shadow
and BSDF-strategy rays go to the traversal in ONE call per bounce;
without one, each segment is its own launch in its own mode.
"""
from __future__ import annotations

import dataclasses

import torch

from ..accel import intersect as isect
from ..bsdf import bsdf as B
from ..core import mc, rng, spectrum, vecmath as vm
from ..lights import lights as lt
from ..materials import factory as _factory
from ..samplers import samplers
from ..scene.data import (AREA_GEOM_QUADRIC, AREA_GEOM_TRIS, LIGHT_AREA,
                          LIGHT_INFINITE, QUADRIC_SPHERE, SceneData)
from ..textures import graph as _tex
from ..utils.stats import span
from ..volumes import regions as vr

_EPS = vm.RAY_EPSILON


def map_bsdf(bsdf: B.BsdfBatch, fn) -> B.BsdfBatch:
    """fn applied to every tensor of a BSDF batch and its lobes."""
    def tensors(obj):
        return dataclasses.replace(obj, **{
            f.name: fn(getattr(obj, f.name)) for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)})
    return dataclasses.replace(tensors(bsdf), lobes=tensors(bsdf.lobes))


def make_bsdf_at(scene: SceneData, dg):
    """Evaluate textures + assemble lobes at hit points (GetBSDF chain,
    core/primitive.cpp:126-133), bump-mapping the shading frame first when
    a material has a displacement texture."""
    tex_vals = _tex.eval_graph(scene.textures, scene.images, dg)
    if scene.materials.has_bump:
        dg = _bump(scene, dg, tex_vals)
    lobes = _factory.make_lobes(scene.materials, dg["material"], tex_vals)
    nn, sn, tn, ng = B.make_frame(dg["sn"], dg["dpdu"], dg["nn"])
    return B.BsdfBatch(nn=nn, sn=sn, tn=tn, ng=ng, lobes=lobes)


def _bump(scene: SceneData, dg, tex_vals):
    """Material::Bump (core/material.cpp:29-71; tpuprt/integrators/
    common.py:41-83): the displacement at u- and v-shifted points, dpdu
    and dpdv perturbed, the shading normal recomputed and turned to the
    geometric normal's side. Lanes whose material has no bump texture pass
    through. The shifted points are new dicts over the same tensors, with
    only p and u (or v) replaced."""
    bid = scene.materials.bump[dg["material"].long()]     # -1 = none
    n_nodes = tex_vals.shape[0]
    lanes = torch.arange(dg["u"].shape[0], device=bid.device)
    safe = torch.clamp(bid, 0, max(n_nodes - 1, 0)).long()

    def disp_of(tv):
        return tv[safe, lanes, 0]

    zero = torch.zeros_like(dg["u"])
    du = 0.5 * (torch.abs(dg.get("dudx", zero)) +
                torch.abs(dg.get("dudy", zero)))
    du = torch.where(du == 0.0, 0.01, du)
    dv = 0.5 * (torch.abs(dg.get("dvdx", zero)) +
                torch.abs(dg.get("dvdy", zero)))
    dv = torch.where(dv == 0.0, 0.01, dv)
    dg_u = dict(dg, p=dg["p"] + du[..., None] * dg["dpdu"], u=dg["u"] + du)
    dg_v = dict(dg, p=dg["p"] + dv[..., None] * dg["dpdv"], v=dg["v"] + dv)
    u_disp = disp_of(_tex.eval_graph(scene.textures, scene.images, dg_u))
    v_disp = disp_of(_tex.eval_graph(scene.textures, scene.images, dg_v))
    disp = disp_of(tex_vals)

    dpdu_b = dg["dpdu"] + ((u_disp - disp) / du)[..., None] * dg["sn"] + \
        disp[..., None] * dg["dndu"]
    dpdv_b = dg["dpdv"] + ((v_disp - disp) / dv)[..., None] * dg["sn"] + \
        disp[..., None] * dg["dndv"]
    nb = vm.normalize(vm.cross(dpdu_b, dpdv_b))
    # Toward the geometric normal (material.cpp:63-70; the handedness flip
    # is already in dg["nn"]).
    nb = torch.where((vm.dot(dg["nn"], nb) < 0.0)[..., None], -nb, nb)
    has = (bid >= 0)[..., None]
    return dict(dg, sn=torch.where(has, nb, dg["sn"]),
                dpdu=torch.where(has, dpdu_b, dg["dpdu"]),
                dpdv=torch.where(has, dpdv_b, dg["dpdv"]))


def specular_ray_differentials(dg, ns, wo, wi, rx_d, ry_d, eta, is_trans):
    """Ray differentials of a specular reflected or transmitted ray
    (tpuprt/integrators/common.py:86-139; whitted.cpp:88-136): from the
    incoming auxiliary directions rx_d, ry_d and dg's first-order
    derivatives (dpdx, dpdy, dndu, dndv, dudx .. dvdy), the continuation's
    (rx_o, rx_d, ry_o, ry_d). eta: sample_f's eta; is_trans picks the
    refraction formula per lane. tpuprt's two deliberate corrections of
    pbrt-v1's refraction derivative are kept: the Snell ratio etai/etat
    (1/eta entering, eta leaving) and the sign of the mu term."""
    p = dg["p"]
    rx_o = p + dg["dpdx"]
    ry_o = p + dg["dpdy"]
    dndx = dg["dndu"] * dg["dudx"][..., None] + \
        dg["dndv"] * dg["dvdx"][..., None]
    dndy = dg["dndu"] * dg["dudy"][..., None] + \
        dg["dndv"] * dg["dvdy"][..., None]
    dwodx = -rx_d - wo
    dwody = -ry_d - wo
    dDNdx = vm.dot(dwodx, ns) + vm.dot(wo, dndx)
    dDNdy = vm.dot(dwody, ns) + vm.dot(wo, dndy)
    wodn = vm.dot(wo, ns)
    refl_rx = wi - dwodx + 2.0 * (wodn[..., None] * dndx +
                                  dDNdx[..., None] * ns)
    refl_ry = wi - dwody + 2.0 * (wodn[..., None] * dndy +
                                  dDNdy[..., None] * ns)
    w = -wo
    eta_r = torch.where(wodn > 0.0, 1.0 / torch.clamp(eta, min=1e-6), eta)
    widn = vm.dot(wi, ns)
    widn_safe = torch.where(torch.abs(widn) < 1e-6,
                            torch.where(widn < 0, -1e-6, 1e-6), widn)
    wdn = vm.dot(w, ns)
    mu = eta_r * wdn - widn
    dmu_fac = eta_r - (eta_r * eta_r * wdn) / widn_safe
    dmudx = dmu_fac * dDNdx
    dmudy = dmu_fac * dDNdy
    trans_rx = wi - eta_r[..., None] * dwodx + \
        (mu[..., None] * dndx + dmudx[..., None] * ns)
    trans_ry = wi - eta_r[..., None] * dwody + \
        (mu[..., None] * dndy + dmudy[..., None] * ns)
    m = is_trans[..., None]
    return (rx_o, torch.where(m, trans_rx, refl_rx),
            ry_o, torch.where(m, trans_ry, refl_ry))


def batched_visibility(scene: SceneData, segs, needs):
    """Resolve ray segments (tpuprt/integrators/common.py:148-215).

    segs:  list of (o f32[N,3], d f32[N,3], mint f32[N], maxt f32[N]).
    needs: list of "any" | "nearest" per segment.
    Returns per segment: (t, pid, hit) for "nearest", occluded booleans for
    "any". On a scene with an accelerator, several segments go to the
    traversal in ONE call: a nearest walk if any segment needs "nearest",
    else an any-hit walk; the BVH's front end sorts the fused batch for
    coherence, the grid and the kd-tree take it unsorted (common.py:
    193-194). Without an accelerator, or for one segment, each
    segment is its own launch in its own mode (common.py:166-174): a
    "nearest" segment through intersect_ids, an "any" one through occluded
    (mt_best's any-hit mode on the brute force).
    """
    if scene.accel is None or len(segs) == 1:
        return [isect.intersect_ids(scene, *s) if nd == "nearest"
                else isect.occluded(scene, *s) for s, nd in zip(segs, needs)]
    O = torch.cat([s[0] for s in segs], dim=0)
    D = torch.cat([s[1] for s in segs], dim=0)
    MINT = torch.cat([s[2] for s in segs], dim=0)
    MAXT = torch.cat([s[3] for s in segs], dim=0)
    sizes = [s[0].shape[0] for s in segs]
    if any(nd == "nearest" for nd in needs):
        t, pid, hit = isect.intersect_ids(scene, O, D, MINT, MAXT)
        return [(ti, pi, hi) if nd == "nearest" else hi
                for nd, ti, pi, hi in zip(needs, t.split(sizes),
                                          pid.split(sizes),
                                          hit.split(sizes))]
    return list(isect.occluded(scene, O, D, MINT, MAXT).split(sizes))


def estimate_direct_multi(scene: SceneData, specs, p, n, wo,
                          bsdf: B.BsdfBatch, active):
    """Sum of EstimateDirect (core/transport.cpp:123-194) over several
    lights, their visibility and BSDF-strategy rays resolved together by
    batched_visibility.

    specs: list of dicts with light_id i32[N], ls1, ls2, ls3, bs1, bs2, bcs
    (sampler streams) and static_kind: the light's LIGHT_* kind when every
    lane samples the same light, else None (the kind is read per lane).
    With volumes, the light-sampled radiance is attenuated by the shadow
    segment's transmittance, jittered by ls3 (common.py:288-292).
    """
    lights = scene.lights
    has_area = LIGHT_AREA in lights.kinds_present

    # ---- Phase 1: sample lights + BSDF, emit ray segments ---------------
    segs, needs, plan = [], [], []
    for sp in specs:
        sk = sp["static_kind"]
        smp = lt.sample(scene, sp["light_id"], p, n, sp["ls1"], sp["ls2"],
                        sp["ls3"])
        f_val = B.f(bsdf, wo, smp["wi"])
        # Lanes with a provably-zero contribution get DEGENERATE rays
        # (mint 1 > maxt -1): the kernel finishes them at the root.
        usable = active & (smp["pdf"] > 0.0) & \
            ~torch.all(smp["Li"] == 0.0, dim=-1)
        need_vis = usable & ~torch.all(f_val == 0.0, dim=-1)
        rec = dict(sp=sp, smp=smp, f_val=f_val, need_vis=need_vis,
                   seg1=len(segs), seg2=-1)
        segs.append((p, smp["wi"], torch.where(need_vis, _EPS, 1.0),
                     torch.where(need_vis, smp["vis_maxt"], -1.0)))
        needs.append("any")
        # Strategy 2 exists only for non-delta lights (transport.cpp:166):
        # a light known to be delta skips the BSDF sample and its ray; with
        # a per-lane light, the delta lanes' rays are degenerate.
        if sk is None or not lt.is_delta(sk):
            bs = B.sample_f(bsdf, wo, sp["bs1"], sp["bs2"], sp["bcs"],
                            B.ALL & ~B.SPECULAR)
            go = active & ~smp["delta"] & bs["valid"] & \
                (bs["pdf"] > 0.0) & ~torch.all(bs["f"] == 0.0, dim=-1)
            rec.update(bs=bs, go=go, seg2=len(segs))
            segs.append((p, bs["wi"], torch.where(go, _EPS, 1.0),
                         torch.where(go, 1e30, -1.0)))
            # The ray must identify an area light at its hit; an infinite
            # light's needs only the escape predicate (transport.cpp:
            # 166-188).
            needs.append("nearest" if has_area and
                         (sk is None or sk == LIGHT_AREA) else "any")
        plan.append(rec)

    vis = batched_visibility(scene, segs, needs)

    # ---- Phase 2: resolve contributions ---------------------------------
    Ld = torch.zeros(p.shape[:-1] + (3,), dtype=torch.float32,
                     device=p.device)
    q = scene.quadrics
    for rec in plan:
        sp, smp = rec["sp"], rec["smp"]
        light_id = sp["light_id"]
        kind = lights.kind[light_id] if sp["static_kind"] is None \
            else sp["static_kind"]
        wi, light_pdf, Li = smp["wi"], smp["pdf"], smp["Li"]
        unocc = rec["need_vis"] & ~vis[rec["seg1"]]
        if vr.present(scene.volumes):
            Li = Li * vr.transmittance(scene.volumes, p, wi,
                                       torch.full_like(light_pdf, _EPS),
                                       smp["vis_maxt"], sp["ls3"])
        bsdf_pdf = B.pdf(bsdf, wo, wi, B.ALL & ~B.SPECULAR)
        w_mis = torch.where(smp["delta"], 1.0,
                            mc.power_heuristic(1.0, light_pdf, 1.0, bsdf_pdf))
        contrib = rec["f_val"] * Li * (
            vm.absdot(wi, n) * w_mis /
            torch.clamp(light_pdf, min=1e-20))[..., None]
        Ldi = torch.where(unocc[..., None], contrib, 0.0)

        if rec["seg2"] >= 0:
            bs = rec["bs"]
            wi2, bpdf = bs["wi"], bs["pdf"]
            lpdf2 = lt.pdf(scene, light_id, p, n, wi2)
            is_inf = kind == LIGHT_INFINITE
            if needs[rec["seg2"]] == "nearest":
                # An area light's radiance where the ray's nearest hit is
                # on it (transport.cpp:166-180), with the pdf of that hit
                # for a disk or cylinder (a sphere keeps its cone pdf); an
                # infinite light's where the ray escapes.
                t2, pid2, hit2 = vis[rec["seg2"]]
                dg2 = isect.hit_geometry_light(scene, pid2, p, wi2, t2)
                on_light = hit2 & (dg2["area_light"] == light_id) & \
                    (kind == LIGHT_AREA)
                Li2 = torch.where(on_light[..., None], lt.area_emission(
                    scene, dg2["area_light"], dg2["nn"], -wi2), 0.0)
                Li2 = torch.where((~hit2 & is_inf)[..., None],
                                  lt.env_radiance(scene, light_id, wi2), Li2)
                geom = lights.area_geom_kind[light_id]
                use_hit_pdf = geom == AREA_GEOM_TRIS
                if q is not None and q.count > 0:
                    qid = torch.clamp(lights.area_first[light_id], 0,
                                      q.count - 1).long()
                    use_hit_pdf = use_hit_pdf | (
                        (geom == AREA_GEOM_QUADRIC) &
                        (q.kind[qid] != QUADRIC_SPHERE))
                # A lane off the light takes a finite stand-in hit (p +
                # wi2): a miss's far hit point would make the pdf's
                # backward 0 * inf = NaN (tpuprt's gradient is NaN there).
                use = on_light & use_hit_pdf
                lpdf2 = torch.where(use, lt.pdf_area_from_hit(
                    scene, light_id, p, wi2,
                    torch.where(use[..., None], dg2["p"], p + wi2),
                    dg2["nn"]), lpdf2)
            else:
                esc = ~vis[rec["seg2"]] & is_inf
                Li2 = torch.where(esc[..., None],
                                  lt.env_radiance(scene, light_id, wi2), 0.0)
            ok2 = rec["go"] & (lpdf2 > 0.0) & \
                ~torch.all(Li2 == 0.0, dim=-1)
            w2 = mc.power_heuristic(1.0, bpdf, 1.0, lpdf2)
            contrib2 = bs["f"] * Li2 * (
                vm.absdot(wi2, n) * w2 /
                torch.clamp(bpdf, min=1e-20))[..., None]
            Ldi = Ldi + torch.where(ok2[..., None], contrib2, 0.0)
        Ld = Ld + Ldi
    return Ld


def estimate_direct(scene: SceneData, light_id, p, n, wo, bsdf: B.BsdfBatch,
                    ls1, ls2, ls3, bs1, bs2, bcs, active):
    """EstimateDirect (core/transport.cpp:123-194) for a wavefront, each
    lane with its own light_id i32[N] (its kind read per lane); `active`
    lanes need the estimate, the others return 0."""
    return estimate_direct_multi(
        scene, [dict(light_id=light_id, ls1=ls1, ls2=ls2, ls3=ls3, bs1=bs1,
                     bs2=bs2, bcs=bcs, static_kind=None)],
        p, n, wo, bsdf, active)


def uniform_sample_one_light(scene: SceneData, p, n, wo, bsdf, u_num,
                             ls1, ls2, ls3, bs1, bs2, bcs, active):
    """UniformSampleOneLight (core/transport.cpp:51-70): one light per lane,
    chosen uniformly by u_num, its estimate times the light count."""
    n_lights = scene.lights.count
    if n_lights == 0:
        return torch.zeros(p.shape[:-1] + (3,), dtype=torch.float32,
                           device=p.device)
    light_id = torch.clamp((u_num * n_lights).to(torch.int32),
                           max=n_lights - 1)
    return float(n_lights) * estimate_direct(
        scene, light_id, p, n, wo, bsdf, ls1, ls2, ls3, bs1, bs2, bcs, active)


def uniform_sample_all_lights(scene: SceneData, p, n, wo, bsdf, sample_fn,
                              active):
    """UniformSampleAllLights (core/transport.cpp:31-50) with one sample a
    light; sample_fn(i, purpose) -> a pair of per-lane uniforms for light i
    (purposes 0: light, 1: its third uniform, 2: BSDF, 3: BSDF
    component). Every light's kind is known per light (kinds_list), so a
    delta light costs no BSDF-strategy ray."""
    specs = []
    for i, kind in enumerate(scene.lights.kinds_list):
        ls1, ls2 = sample_fn(i, 0)
        bs1, bs2 = sample_fn(i, 2)
        specs.append(dict(
            light_id=torch.full(p.shape[:-1], i, dtype=torch.int32,
                                device=p.device),
            ls1=ls1, ls2=ls2, ls3=sample_fn(i, 1)[0], bs1=bs1, bs2=bs2,
            bcs=sample_fn(i, 3)[0], static_kind=kind))
    if not specs:
        return torch.zeros(p.shape[:-1] + (3,), dtype=torch.float32,
                           device=p.device)
    return estimate_direct_multi(scene, specs, p, n, wo, bsdf, active)


def weighted_selection(scene: SceneData):
    """The "weighted" strategy's light distribution (tpuprt/integrators/
    directlighting.py:38-40): Distribution1D over the luminance of each
    light's power, the stationary limit of pbrt-v1's running averages."""
    return mc.distribution1d_build(spectrum.luminance(lt.power(scene)))


def direct_ld(scene: SceneData, cfg, strategy: str, sel, p, ns, wo, bsdf,
              ph, px, py, s_idx, depth, seed, alive):
    """Direct lighting at a vertex (tpuprt/integrators/directlighting.py:
    64-103, path_wavefront.py:105-143; the path integrator's is "one",
    path.py:99-110): "all" samples every light with its own streams
    (purposes 100 + 4i, 101 + 4i, 102 + 4i) and resolves all their rays in
    one call; "one" picks one light uniformly by purpose 10 and scales by
    the light count; "weighted" picks by `sel` (weighted_selection) and
    divides by the pick's pmf. Both take their samples from purposes
    11-13 and rng.uniform(ph, s_idx, depth, 16)."""
    ls3 = rng.uniform(ph, s_idx, depth, 16)
    if strategy == "all":
        specs = []
        for i, kind in enumerate(scene.lights.kinds_list):
            lid = torch.full(p.shape[:-1], i, dtype=torch.int32,
                             device=p.device)
            l1, l2 = samplers.integrator_2d(cfg, px, py, s_idx, depth,
                                            100 + 4 * i, seed)
            b1, b2 = samplers.integrator_2d(cfg, px, py, s_idx, depth,
                                            101 + 4 * i, seed)
            bc = samplers.integrator_1d(cfg, px, py, s_idx, depth,
                                        102 + 4 * i, seed)
            specs.append(dict(light_id=lid, ls1=l1, ls2=l2, ls3=ls3, bs1=b1,
                              bs2=b2, bcs=bc, static_kind=kind))
        return estimate_direct_multi(scene, specs, p, ns, wo, bsdf, alive)
    u_num = samplers.integrator_1d(cfg, px, py, s_idx, depth, 10, seed)
    ls1, ls2 = samplers.integrator_2d(cfg, px, py, s_idx, depth, 11, seed)
    bs1, bs2 = samplers.integrator_2d(cfg, px, py, s_idx, depth, 12, seed)
    bcs = samplers.integrator_1d(cfg, px, py, s_idx, depth, 13, seed)
    if strategy == "weighted":
        lid, pmf = mc.distribution1d_sample_discrete(*sel, u_num)
        return estimate_direct(scene, lid.to(torch.int32), p, ns, wo, bsdf,
                               ls1, ls2, ls3, bs1, bs2, bcs, alive) / \
            torch.clamp(pmf, min=1e-12)[..., None]
    if strategy != "one":
        raise ValueError(f"unknown direct lighting strategy {strategy!r}")
    return uniform_sample_one_light(scene, p, ns, wo, bsdf, u_num, ls1, ls2,
                                    ls3, bs1, bs2, bcs, alive)


def whitted_ld(scene: SceneData, p, ns, wo, bsdf, ph, s_idx, depth, alive):
    """Whitted's direct lighting (whitted.cpp:74-81; tpuprt/integrators/
    path_wavefront.py:146-178): every light, one sample each, no MIS,
    streams rng.uniform(ph, s_idx, depth, i, 1..3); all the lights' shadow
    rays resolved in one batched_visibility call, every segment "any"."""
    samples, segs = [], []
    for i in range(scene.lights.count):
        lid = torch.full(p.shape[:-1], i, dtype=torch.int32, device=p.device)
        sm = lt.sample(scene, lid, p, ns, rng.uniform(ph, s_idx, depth, i, 1),
                       rng.uniform(ph, s_idx, depth, i, 2),
                       rng.uniform(ph, s_idx, depth, i, 3))
        f_val = B.f(bsdf, wo, sm["wi"])
        need = alive & (sm["pdf"] > 0.0) & \
            ~torch.all(sm["Li"] == 0.0, dim=-1) & \
            ~torch.all(f_val == 0.0, dim=-1)
        samples.append((sm, f_val, need))
        # Provably-zero lanes get degenerate rays (mint 1 > maxt -1).
        segs.append((p, sm["wi"], torch.where(need, _EPS, 1.0),
                     torch.where(need, sm["vis_maxt"], -1.0)))
    Ld = torch.zeros_like(p)
    if not segs:
        return Ld
    vis = batched_visibility(scene, segs, ["any"] * len(segs))
    for (sm, f_val, need), occ in zip(samples, vis):
        contrib = f_val * sm["Li"] * (
            vm.absdot(sm["wi"], ns) /
            torch.clamp(sm["pdf"], min=1e-20))[..., None]
        Ld = Ld + torch.where((need & ~occ)[..., None], contrib, 0.0)
    return Ld


def live_window(live):
    """(mint, maxt) of rays that start at a hit point: RAY_EPSILON to
    infinity on `live` lanes, an empty window (1 > -1) elsewhere, which
    the traversal finishes at once."""
    return torch.where(live, _EPS, 1.0), torch.where(live, 1e30, -1.0)


def scan_li(scene: SceneData, o, d, mint, maxt, rx, ry, ph, s_idx,
            n_depths: int, max_depth: int, shade,
            carry_differentials: bool = False):
    """Li of the integrators that tpuprt writes as a scan over depths with a
    specular-only continuation (whitted.py:28-137, directlighting.py:
    28-131, photonmap.py:469-528, igi.py:160-252, irradiancecache.py:
    246-316, exphotonmap.py:247-383), on a chunk of camera rays: at each of
    `n_depths` depths the live lanes' nearest hit, the escaped infinite
    lights' radiance, the emitted radiance, the terms of
    shade(depth, idx, ph, s_idx, dg, bsdf, wo, throughput) (added in
    order; idx the live lanes' chunk indices, the other arguments theirs),
    and the continuation by rng.uniform(ph, s_idx, depth, 0x5A, 1..3)
    while depth < max_depth. The live lanes are compacted after the hit
    and after the continuation, so a dead lane costs nothing and no
    sample's value changes. rx, ry: the +x/+y differential rays (o, d) or
    None, applied at the first hit; with carry_differentials (Whitted,
    whitted.cpp:88-136) at every hit, carried through each specular
    bounce. Returns (L, alpha, t_first). Autograd sees every radiance
    term; L gathers them by index_add_, which writes no tensor autograd
    saved."""
    n, dev = o.shape[0], o.device
    L = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    alpha = torch.zeros(n, dtype=torch.float32, device=dev)
    t_first = maxt.clone()
    idx = torch.arange(n, device=dev)
    ro, rd, tp = o, d, torch.ones_like(o)
    # The live lanes' differential rays (rx_o, rx_d, ry_o, ry_d).
    diff = None if rx is None else (rx[0], rx[1], ry[0], ry[1])
    for depth in range(n_depths):
        first = depth == 0
        t, pid, hit = isect.intersect_ids(
            scene, ro, rd, *((mint, maxt) if first else live_window(
                torch.ones(ro.shape[0], dtype=torch.bool, device=dev))))
        if first:
            t_first = torch.where(hit, t, maxt)
        if scene.lights.infinite_meta:
            Lesc = lt.le_escaped(scene, rd)
            L.index_add_(0, idx, torch.where((~hit)[..., None], tp * Lesc,
                                             0.0))
            if first:
                alpha = torch.where(~hit & torch.any(Lesc > 0, -1), 1.0,
                                    alpha)
        with span("sync"):
            keep = torch.nonzero(hit).squeeze(1)
        if first:
            # index_fill_ takes 1.0 as a kernel argument, where an indexed
            # write would copy it from the host and wait for the device.
            alpha.index_fill_(0, keep, 1.0)
        idx, ro, rd, tp, t, pid = (x[keep] for x in (idx, ro, rd, tp, t,
                                                      pid))
        if diff is not None:
            diff = tuple(x[keep] for x in diff)
        if idx.numel() == 0:
            break
        dg = isect.hit_geometry(scene, pid, ro, rd, t)
        if diff is not None:
            dg = isect.compute_differentials(
                dg, *diff, torch.ones_like(t, dtype=torch.bool))
            if not carry_differentials:
                diff = None
        wo = -rd
        L.index_add_(0, idx, tp * lt.area_emission(scene, dg["area_light"],
                                                   dg["nn"], wo))
        bsdf = make_bsdf_at(scene, dg)
        ph_l, s_l = ph[idx], s_idx[idx]
        with span("light"):
            for term in shade(depth, idx, ph_l, s_l, dg, bsdf, wo, tp):
                L.index_add_(0, idx, term)
        if depth >= max_depth or depth + 1 == n_depths:
            break
        u = [rng.uniform(ph_l, s_l, depth, 0x5A, k) for k in (1, 2, 3)]
        bs = B.sample_f(bsdf, wo, *u, B.SPECULAR | B.REFLECTION |
                        B.TRANSMISSION)
        cont = bs["valid"] & (bs["pdf"] > 0.0) & \
            ~torch.all(bs["f"] == 0.0, dim=-1)
        scale = bs["f"] * (vm.absdot(bs["wi"], bsdf.nn) /
                           torch.clamp(bs["pdf"], min=1e-20))[..., None]
        if diff is not None:
            diff = specular_ray_differentials(
                dg, bsdf.nn, wo, bs["wi"], diff[1], diff[3], bs["eta"],
                (bs["flags"] & B.TRANSMISSION) > 0)
        with span("sync"):
            keep = torch.nonzero(cont).squeeze(1)
        idx, ro, rd, tp = idx[keep], dg["p"][keep], bs["wi"][keep], \
            (tp * scale)[keep]
        if diff is not None:
            diff = tuple(x[keep] for x in diff)
        if idx.numel() == 0:
            break
    return L, alpha, t_first
