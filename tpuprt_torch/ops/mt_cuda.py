"""Dense ray-triangle intersection: the hand-written CUDA kernel, its plain
torch version and the front end (port of tpuprt/ops/mt_pallas.py mt_best
and intersect_tris).

``csrc/mt_best.cu`` tests every ray against every triangle and keeps the
nearest hit, the lowest triangle index winning among equal t. `mt_best`
launches it for CUDA tensors and runs `mt_best_ref` only for CPU tensors:
there is no fallback from one to the other. The kernel is compiled with
nvcc at first use into ``tpuprt_torch/_build/`` and bound through ctypes,
as the traversal kernels are (ops/bvh_cuda.py).
"""
from __future__ import annotations

import ctypes
import os

import torch

from ..shapes import triangle
from . import bvh_cuda

_BIG = 1e30
# The plain version's [rays, triangles] chunk: at most this many pairs, so
# its temporaries stay within a few GB at any scene size.
REF_CHUNK_PAIRS = 1 << 27

MT_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "mt_best.cu")

# Kernel launches, counted by the wrapper where it launches (a plain
# integer; callers may reset it).
launches = {"mt_best": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _entry():
    fn = bvh_cuda.build(MT_SRC).mt_best_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [_P, _I, _P, _I, _P, _P, _P]
    return fn


def pack_tris(p0, p1, p2):
    """f32[9, T]: v0, e1 = p1 - p0, e2 = p2 - p0 rows (pack_tris of
    mt_pallas.py without its padding rows)."""
    return torch.cat([p0.T, (p1 - p0).T, (p2 - p0).T], dim=0).contiguous()


def pack_table(tri):
    """pack_tris of every triangle of a TriangleTable, on its device."""
    return pack_tris(*triangle.gather_verts(
        tri, torch.arange(tri.count, device=tri.verts.device)))


def _check(rays, tris):
    bvh_cuda._check_tensors(rays.device, ("rays", rays, torch.float32),
                            ("tris", tris, torch.float32))
    bvh_cuda._check_rays(rays)
    if tris.dim() != 2 or tris.shape[0] != 9:
        raise ValueError(f"tris must be f32[9,T], got {tuple(tris.shape)}")
    if tris.numel() >= 2 ** 31:
        raise ValueError("the kernel indexes triangles with 32-bit ints")


def mt_best(rays, tris):
    """Nearest hit of packed rays f32[8,N] over packed triangles f32[9,T]
    (pack_tris). Returns (t f32[N], 1e30 = miss; id i32[N], -1 = miss).
    CUDA tensors launch the kernel; CPU tensors run the plain version."""
    _check(rays, tris)
    if rays.device.type == "cpu":
        return mt_best_ref(rays, tris)
    if rays.device.type != "cuda":
        raise ValueError(f"no mt_best kernel for device {rays.device}")
    n = rays.shape[1]
    t = torch.empty(n, dtype=torch.float32, device=rays.device)
    ids = torch.empty(n, dtype=torch.int32, device=rays.device)
    err = _entry()(rays.data_ptr(), n, tris.data_ptr(), tris.shape[1],
                   t.data_ptr(), ids.data_ptr(),
                   torch.cuda.current_stream(rays.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mt_best kernel launch failed: CUDA error {err}")
    launches["mt_best"] += 1
    return t, ids


def mt_best_ref(rays, tris, with_counts: bool = False):
    """mt_best in plain torch ops: all pairs in chunks of rays, each chunk
    [chunk, T] under REF_CHUNK_PAIRS pairs; invalid pairs masked to 1e30
    and torch.min along the triangles, which returns the first index at a
    tie (the kernel's rule). with_counts also returns dict(tri=the pairs
    these rays need tested): every triangle for each ray with a non-empty
    window, none for the others (the kernel skips them)."""
    n = rays.shape[1]
    n_tris = tris.shape[1]
    t_out = torch.full((n,), _BIG, dtype=torch.float32, device=rays.device)
    id_out = torch.full((n,), -1, dtype=torch.int32, device=rays.device)
    v0, e1, e2 = tris[0:3].T, tris[3:6].T, tris[6:9].T
    step = max(1, REF_CHUNK_PAIRS // max(n_tris, 1))
    for r0 in range(0, n if n_tris else 0, step):
        r = rays[:, r0:r0 + step]
        t, _, _, valid = triangle.intersect_edges(
            v0[None], e1[None], e2[None], r[0:3].T[:, None],
            r[3:6].T[:, None], r[6][:, None], r[7][:, None])
        tmin, arg = torch.where(valid, t, _BIG).min(dim=1)
        hit = tmin < _BIG
        t_out[r0:r0 + step] = tmin
        id_out[r0:r0 + step] = torch.where(hit, arg.to(torch.int32), -1)
    if with_counts:
        live = int((rays[6] <= rays[7]).sum())
        return t_out, id_out, dict(tri=live * n_tris)
    return t_out, id_out


def intersect_packed(tris, o, d, mint, maxt):
    """Nearest hit over packed triangles f32[9,T]: (t f32[N], id i32[N],
    hit bool[N]). Runs mt_best, then recomputes the winner's t through
    triangle.intersect_edges (the steps of intersect_pairs, on the same
    edges) and drops a winner whose recompute is invalid. Runs under no
    autograd of its own: the winner's t is the differentiable recompute,
    the choice carries no gradient."""
    rays = torch.cat([o, d, mint[:, None], maxt[:, None]], dim=1).T \
        .contiguous()
    _, ids = mt_best(rays, tris)
    hit = ids >= 0
    if tris.shape[1] == 0:
        return torch.full_like(mint, _BIG), ids, hit
    w = tris[:, torch.clamp(ids, min=0).long()]
    t_exact, _, _, v_exact = triangle.intersect_edges(
        w[0:3].T, w[3:6].T, w[6:9].T, o, d, mint, maxt)
    hit = hit & v_exact
    return torch.where(hit, t_exact, _BIG), torch.where(hit, ids, -1), hit


def intersect_tris(p0, p1, p2, o, d, mint, maxt):
    """Nearest hit over T triangles given by their vertices f32[T,3]
    (intersect_tris of mt_pallas.py): pack_tris, then intersect_packed."""
    return intersect_packed(pack_tris(p0, p1, p2), o, d, mint, maxt)
