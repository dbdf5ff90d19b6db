"""Camera rays, ray intersection and hit geometry, plain torch.

Intersection is exhaustive over the scene's triangles and quadrics, with
one culling step of its own: the triangles are sorted along a Morton curve
of their centroids and grouped into clusters of 64, and a ray tests only
the triangles of the clusters whose (slightly widened) box it crosses.
The culling changes no answer: every triangle a ray can hit lies in a box
it crosses. Every float runs in the `Geometry`'s dtype.
"""
from __future__ import annotations

import math

import numpy as np
import torch

BIG = 1e30
RAY_EPS = 1e-3
CLUSTER = 64


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def normalize(v):
    return v * torch.rsqrt(torch.clamp(dot(v, v), min=1e-20))[..., None]


def xform_point(m, p):
    """m [4,4] (or [...,4,4]) applied to points p [...,3], divided by w."""
    r = [m[..., i, 0] * p[..., 0] + m[..., i, 1] * p[..., 1] +
         m[..., i, 2] * p[..., 2] + m[..., i, 3] for i in range(4)]
    w = r[3]
    w = torch.where(torch.abs(w) < 1e-30, torch.ones_like(w), w)
    return torch.stack(r[:3], -1) / w[..., None]


def xform_vector(m, v):
    return torch.stack([m[..., i, 0] * v[..., 0] + m[..., i, 1] * v[..., 1] +
                        m[..., i, 2] * v[..., 2] for i in range(3)], -1)


def frame_of(v):
    """Two unit vectors orthogonal to unit v, pbrt-v1's CoordinateSystem
    (core/geometry.h) without branches."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    use_xz = (torch.abs(x) > torch.abs(y))[..., None]
    ia = torch.rsqrt(torch.clamp(x * x + z * z, min=1e-20))
    ib = torch.rsqrt(torch.clamp(y * y + z * z, min=1e-20))
    zero = torch.zeros_like(x)
    v2 = torch.where(use_xz, torch.stack([-z * ia, zero, x * ia], -1),
                     torch.stack([zero, z * ib, -y * ib], -1))
    return v2, cross(v, v2)


def _morton(c):
    """30-bit Morton codes of points in [0, 1)^3 (numpy)."""
    q = np.clip((c * 1024).astype(np.int64), 0, 1023)
    code = np.zeros(len(c), np.int64)
    for b in range(10):
        for a in range(3):
            code |= ((q[:, a] >> b) & 1) << (3 * b + a)
    return code


class Geometry:
    """The scene's camera and shapes on `device` in `dtype`."""

    def __init__(self, sc, device, dtype=torch.float32):
        self.dt, self.dev = dtype, device
        self.xres, self.yres = sc.xres, sc.yres

        def t(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

        # Camera: raster -> screen -> camera (core/camera.cpp:60-78).
        aspect = sc.xres / sc.yres
        s0, s1, s2, s3 = ([-aspect, aspect, -1.0, 1.0] if aspect > 1.0 else
                          [-1.0, 1.0, -1.0 / aspect, 1.0 / aspect])
        inv_tan = 1.0 / math.tan(math.radians(sc.fov) / 2.0)
        n, fa = sc.hither, sc.yon
        persp = np.array([[inv_tan, 0, 0, 0], [0, inv_tan, 0, 0],
                          [0, 0, fa / (fa - n), -fa * n / (fa - n)],
                          [0, 0, 1, 0]])
        screen2raster = (np.diag([sc.xres, sc.yres, 1.0, 1.0]) @
                         np.diag([1 / (s1 - s0), 1 / (s2 - s3), 1, 1]) @
                         np.array([[1, 0, 0, -s0], [0, 1, 0, -s3],
                                   [0, 0, 1, 0], [0, 0, 0, 1.0]]))
        self.raster2cam = t(np.linalg.inv(persp) @
                            np.linalg.inv(screen2raster))
        self.cam2world = t(sc.cam2world)
        self.hither, self.yon = sc.hither, sc.yon

        # Triangles, clustered.
        nt = len(sc.idx)
        self.n_tris = nt
        V = sc.verts[sc.idx]                         # [T,3,3] float64
        self.tri_v = t(V)                            # by original id
        self.tri_uv = t(sc.uv[sc.idx])               # [T,3,2]
        self.tri_mat = t(sc.tri_material, torch.int64)
        if nt:
            cen = V.mean(1)
            lo, hi = cen.min(0), cen.max(0)
            order = np.argsort(_morton((cen - lo) / np.maximum(hi - lo,
                                                               1e-30)),
                               kind="stable")
            nc = -(-nt // CLUSTER)
            ids = np.full(nc * CLUSTER, -1, np.int64)
            ids[:nt] = order
            ids = ids.reshape(nc, CLUSTER)
            Vp = np.where((ids >= 0)[..., None, None], V[np.maximum(ids, 0)],
                          0.0)                       # pads: zero area
            blo = np.where((ids >= 0)[..., None], Vp.min(2), np.inf).min(1)
            bhi = np.where((ids >= 0)[..., None], Vp.max(2), -np.inf).max(1)
            pad = 1e-4 * np.maximum(bhi - blo, 1e-3).max(1, keepdims=True) \
                + 1e-6
            self.c_lo, self.c_hi = t(blo - pad), t(bhi + pad)
            self.c_ids = t(ids, torch.int64)
            self.c_p0 = t(Vp[:, :, 0])
            self.c_e1 = t(Vp[:, :, 1] - Vp[:, :, 0])
            self.c_e2 = t(Vp[:, :, 2] - Vp[:, :, 0])

        # Quadrics: object transforms and their inverses.
        q = sc.quadrics
        self.n_quad = len(q)
        if q:
            o2w = np.stack([x["o2w"] for x in q])
            self.q_o2w = t(o2w)
            self.q_w2o = t(np.linalg.inv(o2w))
            self.q_disk = t([x["kind"] == "disk" for x in q], torch.bool)
            self.q_radius = t([x["radius"] for x in q])
            self.q_height = t([x["height"] for x in q])
            self.q_mat = t([x["material"] for x in q], torch.int64)
            self.q_light = t([x["light"] for x in q], torch.int64)

    # ---- camera ----------------------------------------------------------
    def camera_rays(self, image_x, image_y):
        """World-space (o, d, mint, maxt) through raster points."""
        zero = torch.zeros_like(image_x)
        pc = xform_point(self.raster2cam, torch.stack(
            [image_x, image_y, zero], -1).to(self.dt))
        d = normalize(pc)
        dz = torch.where(torch.abs(d[..., 2]) < 1e-12,
                         torch.full_like(d[..., 2], 1e-12), d[..., 2])
        maxt = (min(self.yon, BIG) - self.hither) / dz
        o = xform_point(self.cam2world, torch.zeros_like(d))
        return o, xform_vector(self.cam2world, d), zero.to(self.dt), maxt

    # ---- intersection ----------------------------------------------------
    def _tri_test(self, p0, e1, e2, o, d, mint, maxt):
        """Moller-Trumbore: (t, b1, b2, valid), broadcast."""
        s1 = cross(d, e2)
        div = dot(s1, e1)
        ok = torch.abs(div) > 1e-12
        inv = 1.0 / torch.where(ok, div, torch.ones_like(div))
        s = o - p0
        b1 = dot(s, s1) * inv
        s2 = cross(s, e1)
        b2 = dot(d, s2) * inv
        t = dot(e2, s2) * inv
        valid = ok & (b1 >= 0) & (b2 >= 0) & (b1 + b2 <= 1) & (t > mint) & \
            (t < maxt)
        return t, b1, b2, valid

    def _tris_nearest(self, o, d, mint, maxt, pair_block=1 << 17):
        n = o.shape[0]
        best_t = torch.full((n,), BIG, dtype=self.dt, device=self.dev)
        best_id = torch.full((n,), -1, dtype=torch.int64, device=self.dev)
        if not self.n_tris:
            return best_t, best_id
        dd = torch.where(torch.abs(d) < 1e-30,
                         torch.where(d < 0, -1e-30, 1e-30).to(self.dt), d)
        inv = 1.0 / dd
        ta = (self.c_lo[None] - o[:, None]) * inv[:, None]
        tb = (self.c_hi[None] - o[:, None]) * inv[:, None]
        t0 = torch.maximum(torch.minimum(ta, tb).amax(-1), mint[:, None])
        t1 = torch.minimum(torch.maximum(ta, tb).amin(-1), maxt[:, None])
        rays, clus = torch.nonzero(t0 <= t1, as_tuple=True)
        del ta, tb, t0, t1
        pair_t, pair_id = [], []
        for a in range(0, rays.numel(), pair_block):
            r, c = rays[a:a + pair_block], clus[a:a + pair_block]
            t, _, _, ok = self._tri_test(
                self.c_p0[c], self.c_e1[c], self.c_e2[c], o[r][:, None],
                d[r][:, None], mint[r][:, None], maxt[r][:, None])
            t = torch.where(ok, t, torch.full_like(t, BIG))
            tmin, k = t.min(1)
            best_t.scatter_reduce_(0, r, tmin, "amin")
            pair_t.append(tmin)
            pair_id.append(self.c_ids[c, k])
        if pair_t:
            tmin, tid = torch.cat(pair_t), torch.cat(pair_id)
            # The lowest triangle id among those at the nearest t.
            win = (tmin == best_t[rays]) & (tmin < BIG)
            best_id.fill_(1 << 62)
            best_id.scatter_reduce_(0, rays[win], tid[win], "amin")
        best_id = torch.where(best_t < BIG, best_id, -1)
        return best_t, best_id

    def _quadric_t(self, o, d, mint, maxt):
        """[N,Q] nearest valid root of each quadric (BIG where none)."""
        oo = xform_point(self.q_w2o[None], o[:, None])
        od = xform_vector(self.q_w2o[None], d[:, None])
        r = self.q_radius[None]
        a = dot(od, od)
        b = 2.0 * dot(od, oo)
        c = dot(oo, oo) - r * r
        disc = b * b - 4.0 * a * c
        okq = disc > 0
        root = torch.sqrt(torch.where(okq, disc, torch.ones_like(disc)))
        qq = torch.where(b < 0, -0.5 * (b - root), -0.5 * (b + root))

        def safe(x):
            return torch.where(torch.abs(x) < 1e-30, torch.full_like(x, 1e-30),
                               x)
        ra, rb = qq / safe(a), c / safe(qq)
        t0, t1 = torch.minimum(ra, rb), torch.maximum(ra, rb)
        # Disk: the plane z = height.
        dz = od[..., 2]
        t_lin = (self.q_height[None] - oo[..., 2]) / torch.where(
            torch.abs(dz) < 1e-12, torch.full_like(dz, 1e-12), dz)
        disk = self.q_disk[None]
        t0 = torch.where(disk, t_lin, t0)
        t1 = torch.where(disk, torch.full_like(t1, BIG), t1)
        okq = torch.where(disk, torch.abs(dz) >= 1e-7, okq)

        def inside(t):
            h = oo + t[..., None] * od
            d2 = h[..., 0] * h[..., 0] + h[..., 1] * h[..., 1]
            return torch.where(disk, d2 <= r * r, torch.ones_like(disk))
        mi, ma = mint[:, None], maxt[:, None]
        in0 = okq & (t0 > mi) & (t0 < ma) & inside(t0)
        in1 = okq & (t1 > mi) & (t1 < ma) & inside(t1)
        return torch.where(in0, t0, torch.where(in1, t1,
                                                torch.full_like(t0, BIG)))

    def nearest(self, o, d, mint, maxt, chunk=1 << 14):
        """Nearest hit of each ray: (t, prim); prim -1 on a miss, quadrics
        0..Q-1 then triangles Q.. (by their file order)."""
        ts, ps = [], []
        if self.n_tris:       # about 2^26 (ray, cluster) box tests a chunk
            chunk = max(chunk, (1 << 26) // self.c_ids.shape[0])
        for a in range(0, o.shape[0], chunk):
            sl = slice(a, a + chunk)
            t, p = self._tris_nearest(o[sl], d[sl], mint[sl], maxt[sl])
            p = torch.where(p >= 0, p + self.n_quad, p)
            if self.n_quad:
                tq = self._quadric_t(o[sl], d[sl], mint[sl], maxt[sl])
                tqm, qi = tq.min(1)
                use = tqm < t
                t = torch.where(use, tqm, t)
                p = torch.where(use, qi, p)
            ts.append(t)
            ps.append(p)
        if not ts:
            return (torch.zeros(0, dtype=self.dt, device=self.dev),
                    torch.zeros(0, dtype=torch.int64, device=self.dev))
        return torch.cat(ts), torch.cat(ps)

    # ---- hit geometry ----------------------------------------------------
    def hit(self, prim, o, d, t):
        """Hit record of rays that hit prim (>= 0): p, nn (geometric, the
        orientation of cross(dpdu, dpdv)), u, v, dpdu, dpdv, material,
        light (-1 none)."""
        pid = torch.clamp(prim, min=0)
        p = o + t[..., None] * d
        out = {}
        if self.n_tris:
            tid = torch.clamp(pid - self.n_quad, 0, self.n_tris - 1)
            V = self.tri_v[tid]
            p0, p1, p2 = V[:, 0], V[:, 1], V[:, 2]
            big = torch.full_like(t, BIG)
            _, b1, b2, _ = self._tri_test(p0, p1 - p0, p2 - p0, o, d, -big,
                                          big)
            b0 = 1.0 - b1 - b2
            uv = self.tri_uv[tid]
            u = b0 * uv[:, 0, 0] + b1 * uv[:, 1, 0] + b2 * uv[:, 2, 0]
            v = b0 * uv[:, 0, 1] + b1 * uv[:, 1, 1] + b2 * uv[:, 2, 1]
            du1, du2 = uv[:, 0, 0] - uv[:, 2, 0], uv[:, 1, 0] - uv[:, 2, 0]
            dv1, dv2 = uv[:, 0, 1] - uv[:, 2, 1], uv[:, 1, 1] - uv[:, 2, 1]
            dp1, dp2 = p0 - p2, p1 - p2
            det = du1 * dv2 - dv1 * du2
            degen = torch.abs(det) < 1e-12
            inv = 1.0 / torch.where(degen, torch.ones_like(det), det)
            dpdu = (dv2[:, None] * dp1 - dv1[:, None] * dp2) * inv[:, None]
            dpdv = (du1[:, None] * dp2 - du2[:, None] * dp1) * inv[:, None]
            fu, fv = frame_of(normalize(cross(p1 - p0, p2 - p0)))
            dpdu = torch.where(degen[:, None], fu, dpdu)
            dpdv = torch.where(degen[:, None], fv, dpdv)
            out = dict(u=u, v=v, dpdu=dpdu, dpdv=dpdv,
                       material=self.tri_mat[tid],
                       light=torch.full_like(tid, -1))
        if self.n_quad:
            qid = torch.clamp(pid, max=self.n_quad - 1)
            w2o, o2w = self.q_w2o[qid], self.q_o2w[qid]
            h = xform_point(w2o, o) + t[..., None] * xform_vector(w2o, d)
            x, y, z = h[:, 0], h[:, 1], h[:, 2]
            phimax = 2.0 * math.pi
            phi = torch.atan2(y, x)
            phi = torch.where(phi < 0, phi + 2.0 * math.pi, phi)
            zero = torch.zeros_like(x)
            dpdu = torch.stack([-phimax * y, phimax * x, zero], -1)
            r = self.q_radius[qid]
            # Sphere: theta from z over [thetamin, thetamax] = [pi, 0].
            theta = torch.arccos(torch.clamp(z / r, -1 + 1e-7, 1 - 1e-7))
            zr = torch.sqrt(torch.clamp(x * x + y * y, min=1e-12))
            dth = -math.pi
            dpdv_s = dth * torch.stack([z * x / zr, z * y / zr,
                                        -r * torch.sin(theta)], -1)
            # Disk (inner radius 0).
            dist = torch.sqrt(torch.clamp(x * x + y * y, min=1e-12))
            v_d = 1.0 - dist / r
            omv = torch.where(v_d >= 1.0, torch.ones_like(v_d), 1.0 - v_d)
            dpdv_d = torch.stack([-x / omv, -y / omv, zero], -1)
            disk = self.q_disk[qid][:, None]
            qd = dict(u=phi / phimax,
                      v=torch.where(disk[:, 0], v_d, (theta - math.pi) / dth),
                      dpdu=xform_vector(o2w, dpdu),
                      dpdv=xform_vector(o2w, torch.where(disk, dpdv_d,
                                                         dpdv_s)),
                      material=self.q_mat[qid], light=self.q_light[qid])
            if out:
                is_q = prim < self.n_quad
                out = {k: torch.where(is_q if out[k].dim() == 1 else
                                      is_q[:, None], qd[k], out[k])
                       for k in out}
            else:
                out = qd
        out["p"] = p
        out["nn"] = normalize(cross(out["dpdu"], out["dpdv"]))
        return out
