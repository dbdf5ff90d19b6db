"""Bidirectional path tracing (port of tpuprt/integrators/bidirectional.py;
bidirectional.cpp:80-210).

An eye subpath and a light subpath of MAX_VERTS = 4 vertices each
(generatePath, bidirectional.cpp:133-170, Russian roulette with
probability 0.2 after two vertices); at every eye prefix one light's
direct lighting weighted by the directWt recurrence (bidirectional.cpp:
113-132), and every (eye prefix, light prefix) connection with its own
visibility ray, weighted 1 / (nEye + nLight) (weightPath,
bidirectional.cpp:185-188).

tpuprt's three documented divergences from the reference are kept: the
light path starts with Le nLights / pdf (the reference overwrites it with
lightWeight / lightPdf, dropping the spectrum, bidirectional.cpp:106);
emitted radiance at the first eye vertex and escaped radiance of the
camera ray count (the reference drops both); connection directions are
normalized before the BSDFs see them.

tpuprt launches one visibility test per connection, 16 a chunk. Here the
rays of the connections that can contribute go to one any-hit call, and
each lane's terms are added in tpuprt's order.
"""
from __future__ import annotations

import torch

from ..accel import intersect as isect
from ..bsdf import bsdf as B
from ..core import rng, vecmath as vm
from ..lights import emission, lights as lt
from ..scene.data import SceneData
from . import common

_EPS = vm.RAY_EPSILON
MAX_VERTS = 4


def generate_path(scene: SceneData, o, d, ph, stream: int):
    """generatePath (bidirectional.cpp:133-170; tpuprt bidirectional.py:
    41-80) from rays (o, d): per vertex a dict of p, ng (the geometric
    normal), wi (toward the previous vertex), wo (the continuation),
    f_cont (f at wi, wo), cosw, bw (the continuation's pdf), rrw (the
    roulette's weight), valid, area_light and bsdf. Streams
    rng.uniform(ph, vertex, stream, k)."""
    n, dev = o.shape[0], o.device
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    verts = []
    for v in range(MAX_VERTS):
        t, pid, hit = isect.intersect_ids(scene, o, d,
                                          *common.live_window(alive))
        valid = alive & hit
        dg = isect.hit_geometry(scene, pid, o, d, t)
        bsdf = common.make_bsdf_at(scene, dg)
        wi = -d
        # Russian roulette after two vertices (bidirectional.cpp:152-157).
        survive = torch.ones_like(alive) if v < 2 else \
            rng.uniform(ph, v, stream, 0xEE) <= 0.2
        rrw = torch.full((n,), 5.0 if v >= 2 else 1.0, device=dev)
        rrw = torch.where(survive, rrw, 1.0)
        bs = B.sample_f(bsdf, wi, *(rng.uniform(ph, v, stream, k)
                                    for k in (1, 2, 3)), B.ALL)
        cont_ok = bs["valid"] & (bs["pdf"] > 0.0) & \
            ~(torch.all(bs["f"] == 0.0, -1) & (bs["pdf"] == 0.0))
        verts.append(dict(
            p=dg["p"], ng=dg["nn"], wi=wi, wo=bs["wi"],
            f_cont=B.f(bsdf, wi, bs["wi"]),
            cosw=vm.absdot(bs["wi"], dg["nn"]),
            bw=torch.clamp(bs["pdf"], min=1e-20), rrw=rrw, valid=valid,
            area_light=dg["area_light"], bsdf=bsdf))
        alive = valid & survive & cont_ok & (bs["pdf"] > 0.0)
        o, d = dg["p"], bs["wi"]
    return verts


def _prefixes(verts, valid):
    """The prefix throughputs (evalPath, bidirectional.cpp:189-196): entry
    i the product over vertices k < i of f cos / (bw rrw)."""
    ps = [torch.ones_like(verts[0]["p"])]
    for k in range(MAX_VERTS - 1):
        v = verts[k]
        step = v["f_cont"] * (v["cosw"] / v["bw"])[..., None] / \
            v["rrw"][..., None]
        ps.append(ps[-1] * torch.where(valid[k][..., None], step, 0.0))
    return ps


def li(scene: SceneData, o, d, mint, maxt, cfg, px, py, s_idx,
       max_depth: int = 5, seed: int = 0, rx=None, ry=None):
    """Li (bidirectional.cpp:80-132; tpuprt bidirectional.py:88-183) for a
    chunk of camera rays: (L f32[N, 3], alpha f32[N], t_first f32[N])."""
    del cfg, max_depth, rx, ry  # MAX_VERTS is the reference's fixed bound
    n, dev = o.shape[0], o.device
    ph = rng.hash_u32(rng.hash_u32(px, py, seed, 0xBD12), s_idx, 0xBD13)
    L = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    eye = generate_path(scene, o, d, ph, 0xE)
    # The first hit for the film (alpha, t_first).
    t0, _, hit0 = isect.intersect_ids(scene, o, d, mint, maxt)
    alpha = torch.where(hit0, 1.0, 0.0)
    t_first = torch.where(hit0, t0, maxt)
    # Divergence: escaped and emitted radiance at the first eye vertex.
    if scene.lights.infinite_meta:
        Lesc = lt.le_escaped(scene, d)
        L = L + torch.where((~hit0)[..., None], Lesc, 0.0)
        alpha = torch.where(~hit0 & torch.any(Lesc > 0, -1), 1.0, alpha)
    e0 = eye[0]
    L = L + torch.where(e0["valid"][..., None], lt.area_emission(
        scene, e0["area_light"], e0["ng"], e0["wi"]), 0.0)
    if scene.lights.count == 0:
        return L, alpha, t_first

    # The light subpath's start (bidirectional.cpp:94-112).
    lid, pick_pdf = emission.pick_light_uniform(scene,
                                                rng.uniform(ph, 0x17, 0))
    em = emission.sample_emission(scene, lid, *(rng.uniform(ph, 0x17, k)
                                                for k in (1, 2, 3, 4, 5)))
    le_ok = em["pdf"] > 0.0
    # The correct factor Le nLights / pdf (the reference drops Le).
    Le = em["Le"] / torch.clamp(em["pdf"] * pick_pdf, min=1e-20)[..., None]
    Le = torch.where(le_ok[..., None], Le, 0.0)
    light = generate_path(scene, em["o"], em["d"], ph, 0x11)
    eye_ok = [v["valid"] for v in eye]
    light_ok = [v["valid"] & le_ok for v in light]
    EP, LP = _prefixes(eye, eye_ok), _prefixes(light, light_ok)

    # Every term first; one any-hit call for the connections' rays; then
    # the sums in tpuprt's order (per eye prefix: its direct lighting, its
    # four connections).
    direct, conns = [], []
    direct_wt = torch.ones((n, 3), dtype=torch.float32, device=dev)
    for i in range(1, MAX_VERTS + 1):
        ev, ev_ok = eye[i - 1], eye_ok[i - 1]
        direct_wt = direct_wt / ev["rrw"][..., None]
        u = [rng.uniform(ph, i, 0xD1, k) for k in range(1, 8)]
        Ld = common.uniform_sample_one_light(
            scene, ev["p"], ev["ng"], ev["wi"], ev["bsdf"], u[6], *u[:6],
            ev_ok)
        direct.append(torch.where(ev_ok[..., None],
                                  direct_wt * Ld / float(i), 0.0))
        direct_wt = direct_wt * ev["f_cont"] * (ev["cosw"] /
                                                ev["bw"])[..., None]
        for j in range(1, MAX_VERTS + 1):
            lv = light[j - 1]
            to_l = lv["p"] - ev["p"]
            d2 = torch.clamp(vm.length_sq(to_l), min=1e-12)
            w = to_l * torch.rsqrt(d2)[..., None]
            f_e = B.f(ev["bsdf"], ev["wi"], w)
            f_l = B.f(lv["bsdf"], -w, lv["wi"])
            G = vm.absdot(ev["ng"], w) * vm.absdot(lv["ng"], w) / d2
            contrib = EP[i - 1] * f_e * f_l * LP[j - 1] * Le * (
                G / (ev["rrw"] * lv["rrw"]))[..., None] / float(i + j)
            need = ev_ok & light_ok[j - 1] & torch.any(contrib != 0.0, -1)
            conns.append((contrib, need, ev["p"], w,
                          torch.sqrt(d2) * (1.0 - 1e-3)))
    _, NEED, P, W, MAXT = (torch.cat(x) for x in zip(*conns))
    sel = torch.nonzero(NEED).squeeze(1)
    occ = torch.zeros_like(NEED)
    occ[sel] = isect.occluded(scene, P[sel], W[sel], torch.full(
        sel.shape, _EPS, dtype=torch.float32, device=dev), MAXT[sel])
    occ = occ.view(len(conns), n)
    for i in range(MAX_VERTS):
        L = L + direct[i]
        for j in range(MAX_VERTS):
            c = i * MAX_VERTS + j
            contrib, need = conns[c][:2]
            L = L + torch.where((need & ~occ[c])[..., None], contrib, 0.0)
    return L, alpha, t_first
