"""Texture graphs (port of tpuprt/textures/graph.py): a pbrt texture DAG
flattened at scene build into a topologically ordered node list, evaluated
node by node over a shading wavefront. Node structure (kind, children,
mapping, image id) is static metadata; node parameters (colors, mapping
scales, world-to-texture matrices) are tensors.

Kinds: constant, scale, mix, bilerp, uv, checkerboard2d (aamode none,
closedform, supersample), checkerboard3d, dots, fbm, wrinkled, windy,
marble and imagemap. 2D mappings uv, spherical, cylindrical and planar
with screen-space derivatives (core/texture.cpp:63-155); the 3D mapping by
the node's world-to-texture matrix. The MIPMap lookups read the scene's
packed ImageTable: the trilinear lookup (core/mipmap.h:203-221) gathers
only levels l0 and l0 + 1, the two tpuprt weights nonzero, in tpuprt's
order, so its sum is tpuprt's; the anisotropic lookup is tpuprt's
approximation of EWA (four trilinear taps along the major axis, the minor
axis clamped by the anisotropy 8), not pbrt-v1's Gaussian ellipse.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core import spectrum, transform as tf, vecmath as vm

KINDS = ("constant", "scale", "mix", "uv", "bilerp", "checkerboard2d",
         "checkerboard3d", "dots", "fbm", "wrinkled", "windy", "marble",
         "imagemap")
MAPPINGS = ("uv", "spherical", "cylindrical", "planar")
AAMODES = ("closedform", "supersample", "none")


class TexNodeMeta(NamedTuple):
    kind: str                     # node type
    children: Tuple[int, ...] = ()
    image: int = -1               # ImageTable index of an imagemap
    mapping: str = "uv"           # uv|spherical|cylindrical|planar|3d
    float_from_y: bool = False    # a float imagemap reads the luminance
    aamode: str = "closedform"    # checkerboard antialiasing
    trilinear: bool = False       # imagemap filtering (False: EWA)


@dataclass
class TexGraph:
    fparams: torch.Tensor         # f32[N,16]
    w2t: torch.Tensor             # f32[N,4,4]
    nodes: Tuple[TexNodeMeta, ...] = ()


def check_node(meta: TexNodeMeta):
    """Raise for a node kind or mapping tpuprt does not have either."""
    if meta.kind not in KINDS:
        raise ValueError(f"unknown texture kind {meta.kind}")
    if meta.kind in ("uv", "checkerboard2d", "dots", "imagemap") and \
            meta.mapping not in MAPPINGS:
        raise ValueError(f"unknown 2d mapping {meta.mapping}")


# ---------------------------------------------------------------------------
# Perlin noise (core/texture.cpp:156-239): Ken Perlin's reference
# permutation table, twice over.
# ---------------------------------------------------------------------------

_PERM = np.array([
    151, 160, 137, 91, 90, 15, 131, 13, 201, 95, 96, 53, 194, 233, 7, 225,
    140, 36, 103, 30, 69, 142, 8, 99, 37, 240, 21, 10, 23, 190, 6, 148,
    247, 120, 234, 75, 0, 26, 197, 62, 94, 252, 219, 203, 117, 35, 11, 32,
    57, 177, 33, 88, 237, 149, 56, 87, 174, 20, 125, 136, 171, 168, 68, 175,
    74, 165, 71, 134, 139, 48, 27, 166, 77, 146, 158, 231, 83, 111, 229, 122,
    60, 211, 133, 230, 220, 105, 92, 41, 55, 46, 245, 40, 244, 102, 143, 54,
    65, 25, 63, 161, 1, 216, 80, 73, 209, 76, 132, 187, 208, 89, 18, 169,
    200, 196, 135, 130, 116, 188, 159, 86, 164, 100, 109, 198, 173, 186, 3, 64,
    52, 217, 226, 250, 124, 123, 5, 202, 38, 147, 118, 126, 255, 82, 85, 212,
    207, 206, 59, 227, 47, 16, 58, 17, 182, 189, 28, 42, 223, 183, 170, 213,
    119, 248, 152, 2, 44, 154, 163, 70, 221, 153, 101, 155, 167, 43, 172, 9,
    129, 22, 39, 253, 19, 98, 108, 110, 79, 113, 224, 232, 178, 185, 112, 104,
    218, 246, 97, 228, 251, 34, 242, 193, 238, 210, 144, 12, 191, 179, 162, 241,
    81, 51, 145, 235, 249, 14, 239, 107, 49, 192, 214, 31, 181, 199, 106, 157,
    184, 84, 204, 176, 115, 121, 50, 45, 127, 4, 150, 254, 138, 236, 205, 93,
    222, 114, 67, 29, 24, 72, 243, 141, 128, 195, 78, 66, 215, 61, 156, 180,
], np.int64)
_NOISE_PERM = np.concatenate([_PERM, _PERM])
_perm_cache = {}


def _perm(device):
    t = _perm_cache.get(device)
    if t is None:
        t = _perm_cache[device] = torch.from_numpy(_NOISE_PERM).to(device)
    return t


_const_cache = {}


def _const(name, values, device):
    """The constants `values` as f32 on `device`, copied there once under
    `name`: a copy from the host waits for the device."""
    key = (name, str(device))
    t = _const_cache.get(key)
    if t is None:
        t = _const_cache[key] = torch.as_tensor(
            np.asarray(values, np.float32)).to(device)
    return t


def _lerp(t, a, b):
    return (1.0 - t) * a + t * b


def _grad(h, dx, dy, dz):
    h = h & 15
    u = torch.where(h < 8, dx, dy)
    v = torch.where(h < 4, dy, torch.where((h == 12) | (h == 14), dx, dz))
    u = torch.where((h & 1) > 0, -u, u)
    v = torch.where((h & 2) > 0, -v, v)
    return u + v


def _noise_weight(t):
    t3 = t * t * t
    t4 = t3 * t
    return 6.0 * t4 * t - 15.0 * t4 + 10.0 * t3


def noise(p):
    """Perlin gradient noise at p f32[...,3] (core/texture.cpp:156-201)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    fx, fy, fz = torch.floor(x), torch.floor(y), torch.floor(z)
    ix, iy, iz = (f.to(torch.int32) for f in (fx, fy, fz))
    # x - ix with the int converted back, as tpuprt's int32 - f32 does.
    dx = x - ix.to(torch.float32)
    dy = y - iy.to(torch.float32)
    dz = z - iz.to(torch.float32)
    ix, iy, iz = ((i & 255).long() for i in (ix, iy, iz))
    P = _perm(p.device)

    def g(ox, oy, oz):
        h = P[P[P[ix + ox] + iy + oy] + iz + oz]
        return _grad(h, dx - ox, dy - oy, dz - oz)

    wx, wy, wz = _noise_weight(dx), _noise_weight(dy), _noise_weight(dz)
    x00 = _lerp(wx, g(0, 0, 0), g(1, 0, 0))
    x10 = _lerp(wx, g(0, 1, 0), g(1, 1, 0))
    x01 = _lerp(wx, g(0, 0, 1), g(1, 0, 1))
    x11 = _lerp(wx, g(0, 1, 1), g(1, 1, 1))
    y0 = _lerp(wy, x00, x10)
    y1 = _lerp(wy, x01, x11)
    return _lerp(wz, y0, y1)


_FBM_OCTAVES = 8  # tpuprt's unroll bound; octave weights masked by footprint


def _octave_sum(p, dpdx, dpdy, omega, max_octaves, turbulent):
    """FBm (core/texture.cpp:202-224) or Turbulence (:225-239): up to 8
    octaves, the footprint's octave count with a smoothstep-weighted
    partial last octave, as tpuprt unrolls them."""
    s2 = torch.maximum(vm.length_sq(dpdx), vm.length_sq(dpdy))
    # windy and marble pass a number: filled on the device, as a copy from
    # the host would wait for it.
    mo = max_octaves.to(torch.float32) if torch.is_tensor(max_octaves) else \
        torch.full((), float(max_octaves), device=p.device)
    foctaves = torch.minimum(mo, 1.0 - 0.5 * torch.log2(
        torch.clamp(s2, min=1e-30)))
    foctaves = torch.clamp(foctaves, min=0.0)
    octaves = torch.floor(foctaves).to(torch.int32)
    partial = foctaves - octaves.to(torch.float32)
    w_part = vm.smoothstep(0.3, 0.7, partial)
    total = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    lam, o = 1.0, 1.0
    for i in range(_FBM_OCTAVES):
        w = (i < octaves).to(torch.float32) + torch.where(
            octaves == i, w_part, 0.0)
        n = noise(lam * p)
        total = total + w * o * (torch.abs(n) if turbulent else n)
        lam *= 1.99
        o = o * omega
    return total


def fbm(p, dpdx, dpdy, omega, max_octaves):
    return _octave_sum(p, dpdx, dpdy, omega, max_octaves, False)


def turbulence(p, dpdx, dpdy, omega, max_octaves):
    return _octave_sum(p, dpdx, dpdy, omega, max_octaves, True)


# ---------------------------------------------------------------------------
# Mappings (core/texture.cpp:63-155)
# ---------------------------------------------------------------------------

def spherical_theta(v):
    """SphericalTheta (core/geometry.h:381-390), z clamped as tpuprt's."""
    return torch.acos(torch.clamp(v[..., 2], -1.0 + 1e-7, 1.0 - 1e-7))


def spherical_phi(v):
    """SphericalPhi: atan2 remapped to [0, 2 pi)."""
    p = torch.atan2(v[..., 1], v[..., 0])
    return torch.where(p < 0.0, p + 2.0 * math.pi, p)


def _zeros3(dg, key):
    return dg[key] if key in dg else torch.zeros_like(dg["p"])


def _map2d(meta: TexNodeMeta, fp, w2t, dg):
    """Returns (s, t, dsdx, dtdx, dsdy, dtdy)."""
    zeros = torch.zeros_like(dg["u"])
    if meta.mapping == "uv":
        su, sv, du, dv = fp[8], fp[9], fp[10], fp[11]
        return (su * dg["u"] + du, sv * dg["v"] + dv,
                su * dg.get("dudx", zeros), sv * dg.get("dvdx", zeros),
                su * dg.get("dudy", zeros), sv * dg.get("dvdy", zeros))
    if meta.mapping in ("spherical", "cylindrical"):
        flat = _const("flat", (1.0, 1.0, 0.0), fp.device)

        def st(pp):
            pt = tf.apply_point(w2t, pp)
            pv = vm.normalize(pt)
            if meta.mapping == "spherical":
                return (spherical_theta(pv) * (1.0 / math.pi),
                        spherical_phi(pv) * (0.5 / math.pi))
            return (spherical_phi(vm.normalize(pv * flat)) * (0.5 / math.pi),
                    pt[..., 2])
        if meta.mapping == "spherical":
            s, t = st(dg["p"])
        else:
            p_t = tf.apply_point(w2t, dg["p"])
            s = spherical_phi(vm.normalize(p_t * flat)) * (0.5 / math.pi)
            t = p_t[..., 2]
        # Forward differences (core/texture.cpp:84-104).
        delta = 0.1
        sx, tx = st(dg["p"] + delta * _zeros3(dg, "dpdx"))
        sy, ty = st(dg["p"] + delta * _zeros3(dg, "dpdy"))
        dsdx, dtdx = (sx - s) / delta, (tx - t) / delta
        dsdy, dtdy = (sy - s) / delta, (ty - t) / delta
        # The phi seam.
        dtdx = torch.where(dtdx > 0.5, 1.0 - dtdx,
                           torch.where(dtdx < -0.5, -(dtdx + 1.0), dtdx))
        dtdy = torch.where(dtdy > 0.5, 1.0 - dtdy,
                           torch.where(dtdy < -0.5, -(dtdy + 1.0), dtdy))
        return s, t, dsdx, dtdx, dsdy, dtdy
    vs, vt = fp[0:3], fp[3:6]                      # planar
    dpdx, dpdy = _zeros3(dg, "dpdx"), _zeros3(dg, "dpdy")
    return (fp[6] + vm.dot(dg["p"], vs), fp[7] + vm.dot(dg["p"], vt),
            vm.dot(dpdx, vs), vm.dot(dpdx, vt),
            vm.dot(dpdy, vs), vm.dot(dpdy, vt))


def _map3d(w2t, dg):
    return (tf.apply_point(w2t, dg["p"]),
            tf.apply_vector(w2t, _zeros3(dg, "dpdx")),
            tf.apply_vector(w2t, _zeros3(dg, "dpdy")))


# ---------------------------------------------------------------------------
# MIPMap lookups (core/mipmap.h) on the packed ImageTable
# ---------------------------------------------------------------------------

def _wrap_coords(i, n, wrap):
    if wrap == 0:      # repeat
        return torch.remainder(i, n)
    # clamp; black is masked by the caller
    return torch.minimum(torch.clamp(i, min=0), n - 1)


def _bilinear(images, off, h, w, s, t, wrap):
    """One bilinear tap per lane of the level at texel offset `off` (h x w,
    per lane)."""
    x = s * w.to(torch.float32) - 0.5
    y = t * h.to(torch.float32) - 0.5
    fx0, fy0 = torch.floor(x), torch.floor(y)
    x0, y0 = fx0.to(torch.int32), fy0.to(torch.int32)
    fx = (x - x0.to(torch.float32))[..., None]
    fy = (y - y0.to(torch.float32))[..., None]
    xs0, xs1 = _wrap_coords(x0, w, wrap), _wrap_coords(x0 + 1, w, wrap)
    ys0, ys1 = _wrap_coords(y0, h, wrap), _wrap_coords(y0 + 1, h, wrap)
    tex = images.texels
    row0, row1 = off + ys0.long() * w, off + ys1.long() * w
    v00, v01 = tex[row0 + xs0], tex[row0 + xs1]
    v10, v11 = tex[row1 + xs0], tex[row1 + xs1]
    out = ((1 - fx) * (1 - fy) * v00 + fx * (1 - fy) * v01 +
           (1 - fx) * fy * v10 + fx * fy * v11)
    if wrap == 1:      # black outside [0, 1]
        inside = ((s >= 0) & (s <= 1) & (t >= 0) & (t <= 1))[..., None]
        out = torch.where(inside, out, 0.0)
    return out


def mipmap_lookup_tri(images, img: int, s, t, width):
    """Isotropic trilinear MIPMap::Lookup (core/mipmap.h:203-221) of image
    `img`: levels l0 and l0 + 1 by the footprint `width`."""
    nlev = images.nlevels[img]
    wrap = images.wrap[img]
    level_f = (nlev - 1) + torch.log2(torch.clamp(width, min=1e-8))
    level_f = torch.clamp(level_f, 0.0, float(nlev - 1))
    # The clamp keeps a NaN footprint's gather in bounds (its result stays
    # NaN through dl, as tpuprt's).
    l0 = torch.clamp(torch.floor(level_f).long(), 0, nlev - 1)
    dl = (level_f - l0.to(torch.float32))[..., None]
    l1 = torch.clamp(l0 + 1, max=nlev - 1)
    tap = []
    for lv in (l0, l1):
        tap.append(_bilinear(images, images.level_off[img][lv],
                             images.level_h[img][lv].long(),
                             images.level_w[img][lv].long(), s, t, wrap))
    # tpuprt's sum over all levels: 0 + (1 - dl) tap(l0) + dl tap(l0 + 1),
    # the zero-weighted levels adding nothing.
    return (1.0 - dl) * tap[0] + dl * tap[1]


def _length2(a, b):
    """sqrt(a^2 + b^2), with a zero (not NaN) gradient where both are 0
    (no ray differentials): the sqrt's input is kept off 0 in the branch
    that where() discards."""
    sq = a * a + b * b
    return torch.where(sq > 0.0, torch.sqrt(torch.where(sq > 0.0, sq, 1.0)),
                       0.0)


def mipmap_lookup_ewa(images, img: int, s, t, ds0, dt0, ds1, dt1,
                      max_anisotropy=8.0):
    """tpuprt's anisotropic lookup: the minor axis (clamped to major /
    max_anisotropy) picks the level, four trilinear taps spread along the
    major axis are averaged."""
    d0 = _length2(ds0, dt0)
    d1 = _length2(ds1, dt1)
    major = torch.maximum(d0, d1)
    minor = torch.maximum(torch.minimum(d0, d1), major / max_anisotropy)
    maj_s = torch.where(d0 >= d1, ds0, ds1)
    maj_t = torch.where(d0 >= d1, dt0, dt1)
    ntaps = 4
    out = None
    for k in range(ntaps):
        a = (k + 0.5) / ntaps - 0.5
        tap = mipmap_lookup_tri(images, img, s + a * maj_s, t + a * maj_t,
                                minor)
        out = tap if out is None else out + tap
    return out / ntaps


# ---------------------------------------------------------------------------
# Graph evaluation
# ---------------------------------------------------------------------------

# The supersampled checkerboard's fixed jitter (tpuprt: a fixed table in
# place of the reference's random stratified jitter).
_JIT_TAB = np.random.default_rng(0x5A).uniform(size=(4, 4, 2)).astype(
    np.float32)


def _checker_parity(s, t):
    return ((torch.floor(s).to(torch.int32) +
             torch.floor(t).to(torch.int32)) % 2) == 0


def _checker2d(meta, s, t, dsdx, dtdx, dsdy, dtdy, tex1, tex2):
    if meta.aamode == "closedform":
        # Box-filter closed form (textures/checkerboard.cpp:69-107).
        ds = torch.maximum(torch.abs(dsdx), torch.abs(dsdy))
        dt = torch.maximum(torch.abs(dtdx), torch.abs(dtdy))
        s0, s1 = s - ds, s + ds
        t0, t1 = t - dt, t + dt
        same_s = torch.floor(s0) == torch.floor(s1)
        same_t = torch.floor(t0) == torch.floor(t1)
        point = _checker_parity(s, t)

        def bump(x):
            return torch.floor(x / 2) + 2.0 * torch.clamp(
                x / 2 - torch.floor(x / 2) - 0.5, min=0.0)

        sint = (bump(s1) - bump(s0)) / (2.0 * torch.clamp(ds, min=1e-12))
        tint = (bump(t1) - bump(t0)) / (2.0 * torch.clamp(dt, min=1e-12))
        area = sint + tint - 2.0 * sint * tint
        half = torch.full_like(area, 0.5)
        area = torch.where(ds > 1.0, half, area)
        area = torch.where(dt > 1.0, half, area)
        frac2 = torch.where(same_s & same_t,
                            torch.where(point, 0.0, 1.0), area)[..., None]
        return (1.0 - frac2) * tex1 + frac2 * tex2
    if meta.aamode == "supersample":
        # 4x4 stratified samples with Gaussian weights (textures/
        # checkerboard.cpp:86-141), tpuprt's fixed jitter, the children
        # read once at the lane.
        num = torch.zeros_like(tex1)
        wsum = 0.0
        for i in range(4):
            for j in range(4):
                # f32 offsets and weight, as tpuprt computes them.
                dx = (i + _JIT_TAB[i, j, 0]) / 4.0 - 0.5
                dy = (j + _JIT_TAB[i, j, 1]) / 4.0 - 0.5
                wt = float(np.exp(-2.0 * (dx * dx + dy * dy)))
                dx, dy = float(dx), float(dy)
                pt = _checker_parity(s + dx * dsdx + dy * dsdy,
                                     t + dx * dtdx + dy * dtdy)
                num = num + wt * torch.where(pt[..., None], tex1, tex2)
                wsum += wt
        return num / wsum
    return torch.where(_checker_parity(s, t)[..., None], tex1, tex2)


def eval_graph(graph: TexGraph, images, dg):
    """Evaluate every node for a shading wavefront.

    images: the scene's ImageTable (None without an imagemap). dg: dict
    with p f32[B,3], u, v f32[B] and optionally the derivatives dudx ..
    dvdy, dpdx, dpdy (absent ones are 0). Returns f32[N_nodes, B, 3]
    (float textures replicate into rgb).
    """
    vals = []
    B = dg["u"].shape[0]
    for ni, meta in enumerate(graph.nodes):
        fp = graph.fparams[ni]
        w2t = graph.w2t[ni]
        k = meta.kind
        ch = [vals[c] for c in meta.children]
        if k == "constant":
            v = fp[0:3].expand(B, 3)
        elif k == "scale":
            v = ch[0] * ch[1]
        elif k == "mix":
            amt = ch[2][..., 0:1]
            v = (1.0 - amt) * ch[0] + amt * ch[1]
        elif k == "uv":
            s, t, *_ = _map2d(meta, fp, w2t, dg)
            v = torch.stack([s - torch.floor(s), t - torch.floor(t),
                             torch.zeros_like(s)], -1)
        elif k == "bilerp":
            # Corners in fp[0:12]; always (u, v), unscaled.
            sf = (dg["u"] - torch.floor(dg["u"]))[..., None]
            tf_ = (dg["v"] - torch.floor(dg["v"]))[..., None]
            v = ((1 - sf) * (1 - tf_) * fp[0:3] + (1 - sf) * tf_ * fp[3:6] +
                 sf * (1 - tf_) * fp[6:9] + sf * tf_ * fp[9:12])
        elif k == "checkerboard2d":
            v = _checker2d(meta, *_map2d(meta, fp, w2t, dg), ch[0], ch[1])
        elif k == "checkerboard3d":
            p, _, _ = _map3d(w2t, dg)
            point = ((torch.floor(p[..., 0]).to(torch.int32) +
                      torch.floor(p[..., 1]).to(torch.int32) +
                      torch.floor(p[..., 2]).to(torch.int32)) % 2) == 0
            v = torch.where(point[..., None], ch[0], ch[1])
        elif k == "dots":
            # textures/dots.cpp: polka dots jittered per cell by noise.
            s, t, *_ = _map2d(meta, fp, w2t, dg)
            scell, tcell = torch.floor(s + 0.5), torch.floor(t + 0.5)
            cellp = torch.stack([scell + 0.5, tcell + 0.5,
                                 torch.zeros_like(s)], -1)
            has_dot = noise(cellp) > 0.0
            radius = 0.35
            maxshift = 0.5 - radius
            off1 = _const("dots_off1", (1.5, 2.8, 0.0), s.device)
            off2 = _const("dots_off2", (4.5, 9.8, 0.0), s.device)
            ds_ = s - (scell + maxshift * noise(cellp + off1))
            dt_ = t - (tcell + maxshift * noise(cellp + off2))
            inside = has_dot & (ds_ * ds_ + dt_ * dt_ < radius * radius)
            v = torch.where(inside[..., None], ch[0], ch[1])
        elif k in ("fbm", "wrinkled"):
            p, dpdx, dpdy = _map3d(w2t, dg)
            val = _octave_sum(p, dpdx, dpdy, fp[1], fp[0], k == "wrinkled")
            v = val[..., None].expand(B, 3)
        elif k == "windy":
            # textures/windy.cpp: a two-scale FBm product.
            p, dpdx, dpdy = _map3d(w2t, dg)
            wind = fbm(0.1 * p, 0.1 * dpdx, 0.1 * dpdy, 0.5, 3)
            wave = fbm(p, dpdx, dpdy, 0.5, 6)
            v = (torch.abs(wind) * wave)[..., None].expand(B, 3)
        elif k == "marble":
            p, dpdx, dpdy = _map3d(w2t, dg)
            scale_, variation = fp[2], fp[3]
            marb = scale_ * fbm(scale_ * p, scale_ * dpdx, scale_ * dpdy,
                                fp[1], _FBM_OCTAVES)
            v = _marble_spline(0.5 + 0.5 * torch.sin(
                marb * variation + p[..., 1] * scale_))
        else:                                               # imagemap
            s, t, dsdx, dtdx, dsdy, dtdy = _map2d(meta, fp, w2t, dg)
            if meta.trilinear:
                width = 2.0 * torch.maximum(
                    torch.maximum(torch.abs(dsdx), torch.abs(dtdx)),
                    torch.maximum(torch.abs(dsdy), torch.abs(dtdy)))
                v = mipmap_lookup_tri(images, meta.image, s, t, width)
            else:
                v = mipmap_lookup_ewa(images, meta.image, s, t, dsdx, dtdx,
                                      dsdy, dtdy)
            if meta.float_from_y:
                v = spectrum.luminance(v)[..., None].expand(B, 3)
        vals.append(v)
    if not vals:
        return torch.zeros((0, B, 3), dtype=torch.float32,
                           device=dg["u"].device)
    return torch.stack(vals, 0)


# Marble's colour spline (textures/marble.cpp's 9 control points).
_MARBLE_C = np.array([
    [0.58, 0.58, 0.6], [0.58, 0.58, 0.6], [0.58, 0.58, 0.6],
    [0.5, 0.5, 0.5], [0.6, 0.59, 0.58], [0.58, 0.58, 0.6],
    [0.58, 0.58, 0.6], [0.2, 0.2, 0.33], [0.58, 0.58, 0.6],
], np.float32)


def _marble_spline(t):
    """pbrt's cubic spline through _MARBLE_C: 6 windows of 4 points."""
    c = _const("marble", _MARBLE_C, t.device)
    nseg = c.shape[0] - 3
    t = torch.clamp(t, 0.0, 0.9999)
    seg = torch.floor(t * nseg).to(torch.int32)
    tt = (t * nseg - seg.to(torch.float32))[..., None]
    seg = torch.clamp(seg.long(), 0, nseg - 1)     # in bounds for a NaN t
    c0, c1, c2, c3 = c[seg], c[seg + 1], c[seg + 2], c[seg + 3]
    s0, s1, s2 = _lerp(tt, c0, c1), _lerp(tt, c1, c2), _lerp(tt, c2, c3)
    s0, s1 = _lerp(tt, s0, s1), _lerp(tt, s1, s2)
    return 1.5 * _lerp(tt, s0, s1)
