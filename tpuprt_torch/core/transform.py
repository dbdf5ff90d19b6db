"""4x4 transforms (port of tpuprt/core/transform.py, the parts the port uses).

The factory functions run on the host during scene construction and return
numpy arrays, exactly as the reference's do; the apply functions are tensor
math written out per component (no matmul), in the reference's order.
"""
from __future__ import annotations

import numpy as np
import torch


def translate(delta):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = np.asarray(delta, np.float32)
    return m


def scale(sx, sy, sz):
    return np.diag(np.array([sx, sy, sz, 1.0], np.float32))


def rotate(deg, axis):
    """Rodrigues rotation about an arbitrary axis (core/transform.cpp:80-112)."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    s, c = np.sin(np.radians(deg)), np.cos(np.radians(deg))
    m = np.eye(4)
    m[0, 0] = a[0] * a[0] + (1.0 - a[0] * a[0]) * c
    m[0, 1] = a[0] * a[1] * (1.0 - c) - a[2] * s
    m[0, 2] = a[0] * a[2] * (1.0 - c) + a[1] * s
    m[1, 0] = a[0] * a[1] * (1.0 - c) + a[2] * s
    m[1, 1] = a[1] * a[1] + (1.0 - a[1] * a[1]) * c
    m[1, 2] = a[1] * a[2] * (1.0 - c) - a[0] * s
    m[2, 0] = a[0] * a[2] * (1.0 - c) - a[1] * s
    m[2, 1] = a[1] * a[2] * (1.0 - c) + a[0] * s
    m[2, 2] = a[2] * a[2] + (1.0 - a[2] * a[2]) * c
    return m.astype(np.float32)


def look_at(pos, look, up):
    """World-from-camera matrix with pbrt-v1's right = Cross(dir, up)
    convention (core/transform.cpp:113-140)."""
    pos = np.asarray(pos, np.float64)
    look = np.asarray(look, np.float64)
    up = np.asarray(up, np.float64)
    d = look - pos
    d = d / np.linalg.norm(d)
    right = np.cross(d, up)
    nr = np.linalg.norm(right)
    if nr < 1e-10:
        right = np.cross(d, np.array([0.0, 1.0, 0.0001]))
        nr = np.linalg.norm(right)
    right = right / nr
    new_up = np.cross(right, d)
    m = np.eye(4)
    m[:3, 0] = right
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = pos
    return m.astype(np.float32)


def orthographic(znear, zfar):
    """Camera-to-screen orthographic projection (core/transform.cpp:177-181)."""
    m = np.eye(4, dtype=np.float32)
    m[2, 2] = 1.0 / (zfar - znear)
    m[2, 3] = -znear / (zfar - znear)
    return m


def perspective(fov_deg, n, f):
    """Camera-to-screen perspective projection (core/transform.cpp:182-193)."""
    inv_tan = 1.0 / np.tan(np.radians(fov_deg) / 2.0)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = inv_tan
    m[1, 1] = inv_tan
    m[2, 2] = f / (f - n)
    m[2, 3] = -f * n / (f - n)
    m[3, 2] = 1.0
    return m


def swaps_handedness(m) -> bool:
    """det of upper-left 3x3 < 0 (core/transform.cpp SwapsHandedness)."""
    return bool(np.linalg.det(np.asarray(m)[:3, :3]) < 0.0)


def apply_point(m, p):
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    rx = m[..., 0, 0] * x + m[..., 0, 1] * y + m[..., 0, 2] * z + m[..., 0, 3]
    ry = m[..., 1, 0] * x + m[..., 1, 1] * y + m[..., 1, 2] * z + m[..., 1, 3]
    rz = m[..., 2, 0] * x + m[..., 2, 1] * y + m[..., 2, 2] * z + m[..., 2, 3]
    w = m[..., 3, 0] * x + m[..., 3, 1] * y + m[..., 3, 2] * z + m[..., 3, 3]
    r = torch.stack([rx, ry, rz], dim=-1)
    w = w[..., None]
    return r / torch.where(torch.abs(w) < 1e-30, torch.ones_like(w), w)


def apply_vector(m, v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([
        m[..., 0, 0] * x + m[..., 0, 1] * y + m[..., 0, 2] * z,
        m[..., 1, 0] * x + m[..., 1, 1] * y + m[..., 1, 2] * z,
        m[..., 2, 0] * x + m[..., 2, 1] * y + m[..., 2, 2] * z,
    ], dim=-1)


def row_components(table, idx):
    """table f32[Q,4,4], idx i[N] -> nested list c[i][j] of f32[N]: each
    lane's matrix as 16 component arrays, by one gather of its flat row."""
    flat = table.reshape(table.shape[0], 16)[idx.long()]
    return [[flat[:, 4 * i + j] for j in range(4)] for i in range(4)]


def rows_apply_point(c, p):
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    rx = c[0][0] * x + c[0][1] * y + c[0][2] * z + c[0][3]
    ry = c[1][0] * x + c[1][1] * y + c[1][2] * z + c[1][3]
    rz = c[2][0] * x + c[2][1] * y + c[2][2] * z + c[2][3]
    w = c[3][0] * x + c[3][1] * y + c[3][2] * z + c[3][3]
    r = torch.stack([rx, ry, rz], dim=-1)
    w = w[..., None]
    return r / torch.where(torch.abs(w) < 1e-30, torch.ones_like(w), w)


def rows_apply_vector(c, v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([
        c[0][0] * x + c[0][1] * y + c[0][2] * z,
        c[1][0] * x + c[1][1] * y + c[1][2] * z,
        c[2][0] * x + c[2][1] * y + c[2][2] * z,
    ], dim=-1)


def rows_apply_normal(c_inv, n):
    """Normals use the inverse transpose: pass the INVERSE's components."""
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    return torch.stack([
        c_inv[0][0] * x + c_inv[1][0] * y + c_inv[2][0] * z,
        c_inv[0][1] * x + c_inv[1][1] * y + c_inv[2][1] * z,
        c_inv[0][2] * x + c_inv[1][2] * y + c_inv[2][2] * z,
    ], dim=-1)
