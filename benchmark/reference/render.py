"""The reference's shading, light transport and film, plain torch.

pbrt-v1's semantics as the renderer under test states them:
- the perspective camera, one ray through image_x, image_y and, with
  differentials, two more through image_x + 1 and image_y + 1
  (core/camera.cpp, core/shape.cpp:52-106 for the uv differentials);
- the matte material as a Lambertian lobe, glass as specular reflection
  and transmission under a dielectric Fresnel term, mirror as specular
  reflection (materials/*.cpp, core/reflection.cpp); the checkerboard with
  its closed-form box filter (textures/checkerboard.cpp:69-107);
- infinite (cosine-hemisphere sampling, flipped to the other side by a
  third uniform), distant and disk area lights;
- EstimateDirect's two strategies with the power heuristic
  (core/transport.cpp:123-194): "all" lights for directlighting, one light
  picked uniformly for path; path.cpp's Le on the first and post-specular
  vertices, the full BSDF continuation and Russian roulette (probability
  0.5 from bounce 3);
- stated choices of the renderer kept for parity: a distant light's
  shadow ray ends at the distance from the point to its light's origin; a
  triangle with no uv takes its frame from its normal; camera rays start
  at t = 0; a sample lands in the pixel floor(image_x), floor(image_y)
  (box filter of half a pixel); a sample whose radiance is negative or not
  finite counts as black.
Every sample stream is keyed by (pixel, sample, bounce, purpose)
(sampling.py), so each sample is computed on its own.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import sampling as S
from .scene import load  # noqa: F401  (a configuration's reader)
from .geometry import (BIG, RAY_EPS, Geometry, cross, dot, frame_of,
                       normalize)

INV_PI = 1.0 / math.pi
INV_2PI = 1.0 / (2.0 * math.pi)
MATTE, GLASS, MIRROR = 0, 1, 2
SALT = {"path": 0xBA5E, "directlighting": 0xD112}
RR_START = 3


def concentric(u1, u2):
    sx, sy = 2.0 * u1 - 1.0, 2.0 * u2 - 1.0
    zero = (sx == 0) & (sy == 0)
    big_x = torch.abs(sx) > torch.abs(sy)
    r = torch.where(big_x, torch.abs(sx), torch.abs(sy))

    def div(n, d):
        return n / torch.where(torch.abs(d) < 1e-20,
                               torch.full_like(d, 1e-20), d)
    a = torch.where(big_x, div(sy, sx), div(sx, sy))
    th = torch.where(big_x, torch.where(sx >= 0, a, 4.0 + a),
                     torch.where(sy >= 0, 2.0 - a, 6.0 - a)) * (math.pi / 4)
    return (torch.where(zero, torch.zeros_like(r), r * torch.cos(th)),
            torch.where(zero, torch.zeros_like(r), r * torch.sin(th)))


def power(f, g):
    return f * f / torch.clamp(f * f + g * g, min=1e-20)


def fresnel_dielectric(cosi, etai, etat):
    cosi = torch.clamp(cosi, -1.0, 1.0)
    enter = cosi > 0
    ei = torch.where(enter, etai, etat)
    et = torch.where(enter, etat, etai)
    sint = ei / et * torch.sqrt(torch.clamp(1.0 - cosi * cosi, min=1e-12))
    cost = torch.sqrt(torch.clamp(1.0 - sint * sint, min=1e-12))
    ci = torch.abs(cosi)
    par = (et * ci - ei * cost) / torch.clamp(et * ci + ei * cost, min=1e-12)
    perp = (ei * ci - et * cost) / torch.clamp(ei * ci + et * cost,
                                               min=1e-12)
    return torch.where(sint >= 1.0, torch.ones_like(ci),
                       (par * par + perp * perp) * 0.5)


class Reference:
    """A scene (reference.scene.Scene) ready to render on `device` in
    `dtype`. `params` may replace the checkerboard's colours and a distant
    light's radiance by tensors (autograd flows into them): keys
    "tex1", "tex2", "distant_L"."""

    def __init__(self, sc, device, dtype=torch.float32, params=None):
        self.sc, self.dt, self.dev = sc, dtype, device
        self.g = Geometry(sc, device, dtype)
        # The rays the integrator traces, by what each needs back: the
        # nearest hit (camera and continuation rays, the BSDF strategy's
        # ray toward an area light) or any hit (shadow rays, the BSDF
        # strategy's ray toward an infinite light).
        self.rays = {"nearest": 0, "any": 0}
        params = params or {}

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
        kinds, r1, r2, eta = [], [], [], []
        self.checker_mat, self.checker = -1, None
        for i, m in enumerate(sc.materials):
            if m["kind"] == "matte":
                kinds.append(MATTE)
                src, val = m["Kd"]
                if src == "checker":
                    if self.checker is not None:
                        raise NotImplementedError("two checkerboards")
                    self.checker_mat = i
                    self.checker = dict(val)
                    val = np.zeros(3)
                r1.append(val)
                r2.append(np.zeros(3))
                eta.append(1.0)
            elif m["kind"] == "glass":
                kinds.append(GLASS)
                r1.append(m["Kr"])
                r2.append(m["Kt"])
                eta.append(m["index"])
            else:
                kinds.append(MIRROR)
                r1.append(m["Kr"])
                r2.append(np.zeros(3))
                eta.append(1.0)
        self.m_kind = torch.as_tensor(kinds, device=device)
        self.m_r1, self.m_r2, self.m_eta = t(r1), t(r2), t(eta)
        self.kinds = set(kinds)
        if self.checker is not None:
            c = self.checker
            self.tex1 = params.get("tex1", t(c["tex1"]))
            self.tex2 = params.get("tex2", t(c["tex2"]))
        self.lights = []
        for li in sc.lights:
            d = dict(kind=li["kind"], L=t(li["L"]))
            if li["kind"] == "distant":
                d.update(dir=t(li["dir"]), origin=t(li["origin"]))
                if "distant_L" in params:
                    d["L"] = params["distant_L"]
            elif li["kind"] == "area":
                q = li["quadric"]
                d.update(q=q, area=li["area"], o2w=self.g.q_o2w[q],
                         r=float(sc.quadrics[q]["radius"]),
                         h=float(sc.quadrics[q]["height"]))
                d["n"] = normalize(torch.stack([
                    self.g.q_w2o[q][2, 0], self.g.q_w2o[q][2, 1],
                    self.g.q_w2o[q][2, 2]]))
            self.lights.append(d)
        self.has_area = any(li["kind"] == "area" for li in self.lights)
        self.infinite = [li for li in self.lights if li["kind"] == "infinite"]

    # ---- materials -------------------------------------------------------
    def _kd(self, mat, dg):
        kd = self.m_r1[mat]
        if self.checker is None:
            return kd
        c = self.checker
        zero = torch.zeros_like(dg["u"])
        s = c["su"] * dg["u"] + c["du"]
        tt = c["sv"] * dg["v"] + c["dv"]
        ds = torch.maximum(torch.abs(c["su"] * dg.get("dudx", zero)),
                           torch.abs(c["su"] * dg.get("dudy", zero)))
        dt = torch.maximum(torch.abs(c["sv"] * dg.get("dvdx", zero)),
                           torch.abs(c["sv"] * dg.get("dvdy", zero)))
        s0, s1, t0, t1 = s - ds, s + ds, tt - dt, tt + dt
        point = ((torch.floor(s).to(torch.int32) +
                  torch.floor(tt).to(torch.int32)) % 2) == 0

        def bump(x):
            h = torch.floor(x / 2)
            return h + 2.0 * torch.clamp(x / 2 - h - 0.5, min=0.0)
        si = (bump(s1) - bump(s0)) / (2.0 * torch.clamp(ds, min=1e-12))
        ti = (bump(t1) - bump(t0)) / (2.0 * torch.clamp(dt, min=1e-12))
        area = si + ti - 2.0 * si * ti
        area = torch.where((ds > 1.0) | (dt > 1.0), torch.full_like(area, 0.5),
                           area)
        inside = (torch.floor(s0) == torch.floor(s1)) & \
            (torch.floor(t0) == torch.floor(t1))
        frac = torch.where(inside, torch.where(point, torch.zeros_like(area),
                                               torch.ones_like(area)),
                           area)[:, None]
        val = (1.0 - frac) * self.tex1 + frac * self.tex2
        return torch.where((mat == self.checker_mat)[:, None], val, kd)

    def bsdf(self, dg):
        """Frame and lobes at the hit points dg."""
        n = dg["nn"]
        s = normalize(dg["dpdu"])
        s = normalize(s - dot(s, n)[:, None] * n)
        mat = dg["material"]
        kind = self.m_kind[mat]
        r1 = self.m_r1[mat]
        if MATTE in self.kinds:
            r1 = torch.where((kind == MATTE)[:, None], self._kd(mat, dg), r1)
        return dict(n=n, s=s, t=cross(n, s), ng=dg["nn"], kind=kind, r1=r1,
                    r2=self.m_r2[mat], eta=self.m_eta[mat])

    @staticmethod
    def _local(b, v):
        return torch.stack([dot(v, b["s"]), dot(v, b["t"]), dot(v, b["n"])],
                           -1)

    @staticmethod
    def _world(b, v):
        return v[:, 0:1] * b["s"] + v[:, 1:2] * b["t"] + v[:, 2:3] * b["n"]

    def f(self, b, wo, wi):
        """The non-specular lobes' f (the matte lobe on the reflecting
        side of the geometric normal)."""
        refl = dot(wi, b["ng"]) * dot(wo, b["ng"]) > 0
        ok = (b["kind"] == MATTE) & refl
        return torch.where(ok[:, None], b["r1"] * INV_PI,
                           torch.zeros_like(b["r1"]))

    def pdf(self, b, wo, wi):
        """The non-specular lobes' pdf."""
        lo, li = self._local(b, wo), self._local(b, wi)
        same = lo[:, 2] * li[:, 2] > 0
        ok = (b["kind"] == MATTE) & same
        return torch.where(ok, torch.abs(li[:, 2]) * INV_PI,
                           torch.zeros_like(li[:, 2]))

    def sample_f(self, b, wo_w, u1, u2, u3, lobes):
        """BSDF::Sample_f over `lobes`: "all", "diffuse" (all but the
        specular) or "specular". Returns (wi, f, pdf, specular, valid)."""
        wo = self._local(b, wo_w)
        kind = b["kind"]
        dx, dy = concentric(u1, u2)
        z = torch.sqrt(torch.clamp(1.0 - dx * dx - dy * dy, min=1e-12))
        z = torch.where(wo[:, 2] < 0, -z, z)
        wi_d = torch.stack([dx, dy, z], -1)
        wi_r = torch.stack([-wo[:, 0], -wo[:, 1], wo[:, 2]], -1)
        eta = b["eta"]
        enter = wo[:, 2] > 0
        one = torch.ones_like(eta)
        ei, et = torch.where(enter, one, eta), torch.where(enter, eta, one)
        er = ei / torch.clamp(et, min=1e-7)
        sint2 = er * er * torch.clamp(1.0 - wo[:, 2] ** 2, min=0.0)
        tir = sint2 >= 1.0
        cost = torch.sqrt(torch.clamp(1.0 - sint2, min=1e-12))
        wi_t = torch.stack([-er * wo[:, 0], -er * wo[:, 1],
                            torch.where(enter, -cost, cost)], -1)
        matte, glass, mirror = kind == MATTE, kind == GLASS, kind == MIRROR
        use_d = lobes in ("all", "diffuse")
        use_s = lobes in ("all", "specular")
        trans = glass & (u3 * 2.0 >= 1.0)
        wi = torch.where(trans[:, None], wi_t, wi_r)
        wi = torch.where(matte[:, None], wi_d, wi)
        aci = torch.clamp(torch.abs(wi[:, 2]), min=1e-7)
        F = fresnel_dielectric(wo[:, 2], one, eta)
        f_r = torch.where(glass, F, one)[:, None] * b["r1"] / aci[:, None]
        f_t = ((et * et) / torch.clamp(ei * ei, min=1e-12) * (1.0 - F) /
               aci)[:, None] * b["r2"]
        f_s = torch.where(trans[:, None], f_t, f_r)
        wi_w = self._world(b, wi)
        f = torch.where(matte[:, None], self.f(b, wo_w, wi_w), f_s)
        zero = torch.zeros_like(aci)
        pdf_d = torch.abs(wi[:, 2]) * INV_PI
        pdf_s = torch.where(glass, torch.where(trans & tir, zero, 0.5 * one),
                            one)
        pdf = torch.where(matte, pdf_d if use_d else zero,
                          pdf_s if use_s else zero)
        valid = pdf > 0
        return (wi_w, torch.where(valid[:, None], f, torch.zeros_like(f)),
                pdf, ~matte, valid)

    # ---- lights ----------------------------------------------------------
    def sample_light(self, i, p, n, u1, u2, u3):
        """(Li, wi, pdf, delta, vis_maxt) of light i toward p."""
        li = self.lights[i]
        N = p.shape[0]
        if li["kind"] == "distant":
            wi = li["dir"].expand(N, 3)
            dist = torch.sqrt(torch.clamp(dot(li["origin"] - p,
                                              li["origin"] - p), min=1e-12))
            return (li["L"].expand(N, 3), wi, torch.ones_like(u1), True,
                    dist * (1.0 - 1e-3))
        if li["kind"] == "infinite":
            x, y = concentric(u1, u2)
            z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=1e-12))
            z = torch.where(u3 < 0.5, -z, z)
            nf = normalize(n)
            v1, v2 = frame_of(nf)
            wi = x[:, None] * v1 + y[:, None] * v2 + z[:, None] * nf
            return (li["L"].expand(N, 3), wi, torch.abs(z) * INV_2PI, False,
                    torch.full_like(u1, BIG))
        # Disk of radius r at height h: r by a lerp in r^2, phi by u2.
        rr = torch.sqrt(u1 * li["r"] ** 2)
        phi = u2 * (2.0 * math.pi)
        po = torch.stack([rr * torch.cos(phi), rr * torch.sin(phi),
                          torch.full_like(rr, li["h"])], -1)
        m = li["o2w"]
        ps = torch.stack([m[j, 0] * po[:, 0] + m[j, 1] * po[:, 1] +
                          m[j, 2] * po[:, 2] + m[j, 3] for j in range(3)], -1)
        to = ps - p
        d2 = torch.clamp(dot(to, to), min=1e-12)
        wi = to * torch.rsqrt(d2)[:, None]
        ns = li["n"].expand(N, 3)
        pdf = d2 / torch.clamp(torch.abs(dot(ns, wi)) * li["area"], min=1e-12)
        emits = dot(ns, -wi) > 0
        Li = torch.where(emits[:, None], li["L"].expand(N, 3),
                         torch.zeros_like(p))
        return Li, wi, pdf, False, torch.sqrt(d2) * (1.0 - 1e-3)

    def _occluded(self, p, wi, ok, maxt):
        t, _ = self.g.nearest(p, wi, torch.where(ok, RAY_EPS, 1.0).to(self.dt),
                              torch.where(ok, maxt, -1.0).to(self.dt))
        return t < BIG

    def estimate_direct(self, i, p, n, wo, b, ls1, ls2, ls3, bs1, bs2, bcs,
                        active):
        li = self.lights[i]
        Li, wi, lpdf, delta, vmax = self.sample_light(i, p, n, ls1, ls2, ls3)
        f = self.f(b, wo, wi)
        need = active & (lpdf > 0) & ~torch.all(Li == 0, -1) & \
            ~torch.all(f == 0, -1)
        self.rays["any"] = self.rays["any"] + need.sum()
        with torch.no_grad():
            occ = self._occluded(p, wi, need, vmax)
        w = torch.ones_like(lpdf) if delta else \
            power(lpdf, self.pdf(b, wo, wi))
        c = f * Li * (torch.abs(dot(wi, n)) * w /
                      torch.clamp(lpdf, min=1e-20))[:, None]
        Ld = torch.where((need & ~occ)[:, None], c, torch.zeros_like(c))
        if delta:
            return Ld
        wi2, f2, bpdf, _, valid = self.sample_f(b, wo, bs1, bs2, bcs,
                                                "diffuse")
        go = active & valid & ~torch.all(f2 == 0, -1)
        kind = "any" if li["kind"] == "infinite" else "nearest"
        self.rays[kind] = self.rays[kind] + go.sum()
        with torch.no_grad():
            t2, prim2 = self.g.nearest(
                p, wi2, torch.where(go, RAY_EPS, 1.0).to(self.dt),
                torch.where(go, BIG, -1.0).to(self.dt))
        hit2 = prim2 >= 0
        if li["kind"] == "infinite":
            Li2 = torch.where((~hit2)[:, None], li["L"].expand_as(p),
                              torch.zeros_like(p))
            lpdf2 = torch.abs(dot(n, wi2)) * INV_2PI
        else:
            dg2 = self.g.hit(prim2, p, wi2, t2)
            on = hit2 & (dg2["light"] == i) & (dot(dg2["nn"], -wi2) > 0)
            Li2 = torch.where(on[:, None], li["L"].expand_as(p),
                              torch.zeros_like(p))
            hp = torch.where(on[:, None], dg2["p"], p + wi2)
            lpdf2 = torch.where(on, dot(hp - p, hp - p) / torch.clamp(
                torch.abs(dot(dg2["nn"], wi2)) * li["area"], min=1e-12),
                torch.zeros_like(bpdf))
        ok2 = go & (lpdf2 > 0) & ~torch.all(Li2 == 0, -1)
        c2 = f2 * Li2 * (torch.abs(dot(wi2, n)) * power(bpdf, lpdf2) /
                         torch.clamp(bpdf, min=1e-20))[:, None]
        return Ld + torch.where(ok2[:, None], c2, torch.zeros_like(c2))

    # ---- differentials ---------------------------------------------------
    @staticmethod
    def _differentials(dg, rx, ry):
        n, p = dg["nn"], dg["p"]
        dplane = -dot(n, p)

        def aux(o, d):
            den = dot(n, d)
            ok = torch.abs(den) > 1e-12
            tx = -(dot(n, o) + dplane) / torch.where(ok, den,
                                                     torch.ones_like(den))
            return o + tx[:, None] * d, ok
        px, okx = aux(*rx)
        py, oky = aux(*ry)
        live = okx & oky
        dpdx = torch.where(live[:, None], px - p, torch.zeros_like(p))
        dpdy = torch.where(live[:, None], py - p, torch.zeros_like(p))
        dom = torch.argmax(torch.abs(n), -1)
        a0 = torch.where(dom == 0, 1, 0)[:, None]
        a1 = torch.where(dom == 2, 1, 2)[:, None]

        def comp(v, a):
            return torch.gather(v, -1, a)[:, 0]
        m00, m01 = comp(dg["dpdu"], a0), comp(dg["dpdv"], a0)
        m10, m11 = comp(dg["dpdu"], a1), comp(dg["dpdv"], a1)
        det = m00 * m11 - m01 * m10
        ok = torch.abs(det) >= 1e-5
        inv = 1.0 / torch.where(ok, det, torch.ones_like(det))

        def solve(v, fb):
            b0, b1 = comp(v, a0), comp(v, a1)
            return (torch.where(ok, (m11 * b0 - m01 * b1) * inv,
                                torch.full_like(b0, fb[0])),
                    torch.where(ok, (m00 * b1 - m10 * b0) * inv,
                                torch.full_like(b0, fb[1])))
        dudx, dvdx = solve(dpdx, (1.0, 0.0))
        dudy, dvdy = solve(dpdy, (0.0, 1.0))
        z = torch.zeros_like(dudx)
        return dict(dg, dudx=torch.where(live, dudx, z),
                    dvdx=torch.where(live, dvdx, z),
                    dudy=torch.where(live, dudy, z),
                    dvdy=torch.where(live, dvdy, z))

    # ---- integrators -----------------------------------------------------
    def radiance(self, px, py, s_idx, seed, differentials=True):
        """(L [N,3], alpha [N], image_x, image_y) of camera samples."""
        ix, iy = S.camera_sample(px, py, s_idx, seed)
        o, d, mint, maxt = self.g.camera_rays(ix, iy)
        diff = None
        if differentials:
            diff = (self.g.camera_rays(ix + 1.0, iy)[:2],
                    self.g.camera_rays(ix, iy + 1.0)[:2])
        L, alpha = self._trace(o, d, mint, maxt, diff, px, py, s_idx, seed)
        return L, alpha, ix, iy

    def _trace(self, o, d, mint, maxt, diff, px, py, s_idx, seed):
        path = self.sc.integrator == "path"
        ph = S.hash32(px, py, seed, SALT[self.sc.integrator])
        N = o.shape[0]
        L = torch.zeros((N, 3), dtype=self.dt, device=self.dev)
        tp = torch.ones_like(L)
        alpha = torch.zeros(N, dtype=self.dt, device=self.dev)
        alive = torch.ones(N, dtype=torch.bool, device=self.dev)
        spec = torch.zeros_like(alive)
        depth = 0
        while bool(alive.any()):
            self.rays["nearest"] = self.rays["nearest"] + alive.sum()
            with torch.no_grad():
                t, prim = self.g.nearest(o, d, mint, maxt)
            hit = prim >= 0
            first = depth == 0
            take = alive & ~hit & ((first | spec) if path else True)
            for li in self.infinite:
                L = L + torch.where(take[:, None], tp * li["L"],
                                    torch.zeros_like(L))
                if first:
                    alpha = torch.where(take & torch.any(li["L"] > 0),
                                        torch.ones_like(alpha), alpha)
            alive = alive & hit
            if first:
                alpha = torch.where(hit, torch.ones_like(alpha), alpha)
            dg = self.g.hit(prim, o, d, t)
            if first and diff is not None:
                dg = self._differentials(dg, *diff)
            wo = -d
            if self.has_area:
                emit = alive & ((first | spec) if path else True)
                lid = torch.clamp(dg["light"], min=0)
                Le = torch.stack([li["L"] if li["kind"] == "area" else
                                  torch.zeros_like(li["L"])
                                  for li in self.lights])[lid]
                ok = emit & (dg["light"] >= 0) & (dot(dg["nn"], wo) > 0)
                L = L + torch.where(ok[:, None], tp * Le, torch.zeros_like(L))
            b = self.bsdf(dg)
            p, n = dg["p"], b["n"]
            u3 = S.uniform(ph, s_idx, depth, 16)

            def s1(purpose):
                return S.sample1(px, py, s_idx, depth, purpose,
                                 seed).to(self.dt)

            def s2(purpose):
                a, c = S.sample2(px, py, s_idx, depth, purpose, seed)
                return a.to(self.dt), c.to(self.dt)
            u3 = u3.to(self.dt)
            nl = len(self.lights)
            if path and nl:
                pick = torch.clamp((s1(10) * nl).to(torch.int64), max=nl - 1)
                args = (*s2(11), u3, *s2(12), s1(13))
                Ld = torch.zeros_like(L)
                for i in range(nl):
                    Ld = Ld + torch.where(
                        (pick == i)[:, None], float(nl) * self.estimate_direct(
                            i, p, n, wo, b, *args, alive & (pick == i)),
                        torch.zeros_like(L))
            else:
                Ld = torch.zeros_like(L)
                for i in range(nl):
                    Ld = Ld + self.estimate_direct(
                        i, p, n, wo, b, *s2(100 + 4 * i), u3,
                        *s2(101 + 4 * i), s1(102 + 4 * i), alive)
            L = L + torch.where(alive[:, None], tp * Ld, torch.zeros_like(L))
            if path:
                c1, c2 = s2(20)
                wi, f, pdf, sp, valid = self.sample_f(b, wo, c1, c2, s1(21),
                                                      "all")
            else:
                c = [S.uniform(ph, s_idx, depth, 0x5A, k).to(self.dt)
                     for k in (1, 2, 3)]
                wi, f, pdf, sp, valid = self.sample_f(b, wo, *c, "specular")
            cont = alive & valid & ~torch.all(f == 0, -1) & \
                (depth < self.sc.max_depth)
            scale = f * (torch.abs(dot(wi, n)) /
                         torch.clamp(pdf, min=1e-20))[:, None]
            tp = torch.where(cont[:, None], tp * scale, tp)
            spec = torch.where(cont, sp, spec)
            alive = cont
            if path and depth >= RR_START:
                alive = alive & (S.uniform(ph, s_idx, depth, 30) < 0.5)
                tp = torch.where(alive[:, None], tp / 0.5, tp)
            o, d = p, wi
            mint = torch.full_like(mint, RAY_EPS)
            maxt = torch.full_like(maxt, BIG)
            depth += 1
        bad = torch.any(~torch.isfinite(L) | (L < 0), -1)
        return torch.where(bad[:, None], torch.zeros_like(L), L), alpha

    # ---- film ------------------------------------------------------------
    def frame(self, seed, window=None, chunk=1 << 18):
        """The film, (rgb f32[H,W,3], alpha f32[H,W]): the samples of every
        pixel, or of the pixels x0 <= x < x1, y0 <= y < y1 of `window`,
        splatted to floor(image_x), floor(image_y). `rays` counts this
        frame's rays afterwards."""
        self.rays = {"nearest": 0, "any": 0}
        W, H, spp = self.sc.xres, self.sc.yres, self.sc.spp
        x0, x1, y0, y1 = window or (0, W, 0, H)
        acc = torch.zeros((H * W, 5), dtype=torch.float32, device=self.dev)
        total = (x1 - x0) * (y1 - y0) * spp
        with torch.no_grad():
            for a in range(0, total, chunk):
                lin = torch.arange(a, min(a + chunk, total), device=self.dev)
                pix = lin // spp
                px = (x0 + pix % (x1 - x0)).to(torch.int32)
                py = (y0 + pix // (x1 - x0)).to(torch.int32)
                L, alpha, ix, iy = self.radiance(
                    px, py, (lin % spp).to(torch.int32), seed,
                    self.checker is not None)
                fx, fy = torch.floor(ix).long(), torch.floor(iy).long()
                inside = (fx >= 0) & (fx < W) & (fy >= 0) & (fy < H)
                w = inside.to(torch.float32)
                idx = torch.clamp(fy, 0, H - 1) * W + torch.clamp(fx, 0, W - 1)
                acc.index_add_(0, idx, torch.cat(
                    [w[:, None] * L.float(), (w * alpha.float())[:, None],
                     w[:, None]], -1))
        wsum = torch.clamp(acc[:, 4:5], min=1e-10)
        rgb = (acc[:, :3] / wsum).reshape(H, W, 3)
        alpha = torch.clamp(acc[:, 3:4] / wsum, 0.0, 1.0).reshape(H, W)
        self.rays = {k: int(v) for k, v in self.rays.items()}
        return rgb, alpha

    def loss(self, seed, target, window=None):
        """The mean over every pixel's sample 0 (or the pixels of
        `window`), without differentials, of the squared distance between
        its radiance and its pixel of `target` [H,W,3] (autograd through
        the params)."""
        x0, x1, y0, y1 = window or (0, self.sc.xres, 0, self.sc.yres)
        lin = torch.arange((x1 - x0) * (y1 - y0), device=self.dev)
        px = (x0 + lin % (x1 - x0)).to(torch.int32)
        py = (y0 + lin // (x1 - x0)).to(torch.int32)
        s = torch.zeros_like(px)
        L = self.radiance(px, py, s, seed, differentials=False)[0]
        e = L - target.to(self.dt)[py.long(), px.long()]
        return torch.mean(torch.sum(e * e, -1))
