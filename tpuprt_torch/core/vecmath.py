"""Vector math over stacked ``f32[..., 3]`` tensors (port of
tpuprt/core/vecmath.py, the parts the port uses).

Dot products are written out component by component, in the reference's
left-to-right order, so a sum rounds the same way on every backend.
"""
from __future__ import annotations

import torch

# Matches RAY_EPSILON (reference core/pbrt.h:204-212).
RAY_EPSILON = 1e-3


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def absdot(a, b):
    return torch.abs(dot(a, b))


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def length_sq(v):
    return dot(v, v)


def length(v):
    return torch.sqrt(length_sq(v))


def normalize(v, eps=1e-20):
    """Safe normalize: zero vectors stay zero instead of producing NaN."""
    n2 = length_sq(v)[..., None]
    return v * torch.rsqrt(torch.clamp(n2, min=eps))


def quadratic(a, b, c):
    """Solve a t^2 + b t + c = 0 branchlessly: (has_solution, t0 <= t1),
    the numerically stable form of Quadratic (core/pbrt.h:622-644)."""
    disc = b * b - 4.0 * a * c
    ok = disc > 0.0
    root = torch.sqrt(torch.where(ok, disc, 1.0))
    q = torch.where(b < 0.0, -0.5 * (b - root), -0.5 * (b + root))

    def safe(n, d):
        return n / torch.where(torch.abs(d) < 1e-30, 1e-30, d)

    t0 = safe(q, a)
    t1 = safe(c, q)
    return ok, torch.minimum(t0, t1), torch.maximum(t0, t1)


def coordinate_system(v1):
    """Orthonormal frame (v1, v2, v3) from a unit vector, branchless
    (reference core/geometry.h:32-49)."""
    x, y, z = v1[..., 0], v1[..., 1], v1[..., 2]
    cond = (torch.abs(x) > torch.abs(y))[..., None]
    inv_a = torch.rsqrt(torch.clamp(x * x + z * z, min=1e-20))
    inv_b = torch.rsqrt(torch.clamp(y * y + z * z, min=1e-20))
    zero = torch.zeros_like(x)
    v2a = torch.stack([-z * inv_a, zero, x * inv_a], dim=-1)
    v2b = torch.stack([zero, z * inv_b, -y * inv_b], dim=-1)
    v2 = torch.where(cond, v2a, v2b)
    return v1, v2, cross(v1, v2)


def bbox_intersect_p(lo, hi, o, d, mint, maxt):
    """Slab test of rays against one box (BBox::IntersectP,
    core/geometry.cpp), branchless: (hit, t0, t1)."""
    inv = 1.0 / torch.where(torch.abs(d) < 1e-30,
                            torch.where(d < 0, -1e-30, 1e-30), d)
    tnear = (lo - o) * inv
    tfar = (hi - o) * inv
    t0 = torch.maximum(torch.minimum(tnear, tfar).amax(-1), mint)
    t1 = torch.minimum(torch.maximum(tnear, tfar).amin(-1), maxt)
    return t0 <= t1, t0, t1


def smoothstep(lo: float, hi: float, x):
    """SmoothStep (reference core/pbrt.h:660-667) for scalar edges: 0 below
    lo, 1 above hi, a cubic between. The denominator is a tensor on x's
    device, so the card divides as the CPU does; it is filled there, as a
    tensor copied from the host would wait for the device."""
    den = torch.full((), hi - lo if hi != lo else 1.0, dtype=torch.float32,
                     device=x.device)
    t = torch.clamp((x - lo) / den, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)
