"""BVH traversal: the hand-written CUDA kernel, its plain torch version, and
the ray-sorting front end (port of tpuprt/ops/bvh_pallas.py traverse_tiles,
traverse_tiles_chunked and intersect).

`traverse_tiles` launches ``csrc/bvh_tiles.cu`` for CUDA tensors and runs
`traverse_tiles_ref` only for CPU tensors: there is no fallback from one to
the other. The kernel is compiled with nvcc at first use into
``tpuprt_torch/_build/`` and bound through ctypes.
"""
from __future__ import annotations

import ctypes
import os
import shutil

import torch

from ..native import build_shared

MAXD = 32          # per-depth mask slots (build_tiles rejects deeper trees)
_BIG = 1e30

KERNEL_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "csrc", "bvh_tiles.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC"]

# Kernel launches made by traverse_tiles (plain integer; callers may reset).
launches = 0


def _nvcc_cmd():
    """nvcc from PATH, else from the toolkit's default location."""
    return [shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"] + NVCC_FLAGS


def load_kernel():
    """Build (if needed) and bind the CUDA kernel's C entry point."""
    fn = build_shared(KERNEL_SRC, _nvcc_cmd()).bvh_tiles_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return fn


def _check(nodesT, nodeskip, nodemeta, rays, nn):
    dev = rays.device
    for name, x, dt in (("nodesT", nodesT, torch.float32),
                        ("nodeskip", nodeskip, torch.int32),
                        ("nodemeta", nodemeta, torch.int32),
                        ("rays", rays, torch.float32)):
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, rays on {dev}")
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if nodesT.dim() != 2 or nodesT.shape[1] != 128 or \
            nodesT.shape[0] < nn or nodeskip.shape != (nodesT.shape[0],) or \
            nodemeta.shape != (nodesT.shape[0],):
        raise ValueError("node tables must be f32[NN,128], i32[NN], i32[NN]")
    if rays.dim() != 2 or rays.shape[0] != 8:
        raise ValueError(f"rays must be f32[8,N], got {tuple(rays.shape)}")
    if rays.numel() >= 2 ** 31:
        raise ValueError("the kernel indexes rays with 32-bit ints")


def traverse_tiles(nodesT, nodeskip, nodemeta, rays, *, nn: int,
                   any_hit: bool = False):
    """Nearest (or any) hit of packed rays f32[8,N] against the tile-format
    BVH. Returns (t f32[N], id i32[N], -1 = miss). CUDA tensors launch the
    kernel; CPU tensors run the plain version."""
    global launches
    _check(nodesT, nodeskip, nodemeta, rays, nn)
    if rays.device.type == "cpu":
        return traverse_tiles_ref(nodesT, nodeskip, nodemeta, rays, nn=nn,
                                  any_hit=any_hit)
    if rays.device.type != "cuda":
        raise ValueError(f"no traversal kernel for device {rays.device}")
    if nodesT.data_ptr() % 16:
        raise ValueError("nodesT must be 16-byte aligned")
    n = rays.shape[1]
    t = torch.empty(n, dtype=torch.float32, device=rays.device)
    ids = torch.empty(n, dtype=torch.int32, device=rays.device)
    err = load_kernel()(
        nodesT.data_ptr(), nodeskip.data_ptr(), nodemeta.data_ptr(),
        rays.data_ptr(), n, nn, int(any_hit), t.data_ptr(), ids.data_ptr(),
        torch.cuda.current_stream(rays.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bvh_tiles kernel launch failed: CUDA error {err}")
    launches += 1
    return t, ids


def _safe_inv(v):
    tiny = torch.where(v < 0, -1e-12, 1e-12)
    return 1.0 / torch.where(torch.abs(v) < 1e-12, tiny, v)


def traverse_tiles_ref(nodesT, nodeskip, nodemeta, rays, *, nn: int,
                       any_hit: bool = False):
    """The kernel's walk in plain torch ops, vectorized over rays: a cursor
    per ray, one gather of its node row per step, until every cursor
    reaches NN. Rays whose walk ended drop out of the active set."""
    n = rays.shape[1]
    dev = rays.device
    o = rays[0:3].T
    d = rays[3:6].T
    mint_all, maxt_all = rays[6], rays[7]
    inv_all = _safe_inv(d)
    best_t = torch.full((n,), _BIG, dtype=torch.float32, device=dev)
    best_id = torch.full((n,), -1, dtype=torch.int32, device=dev)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    # Child masks per depth; slot MAXD + 1 takes the writes of rays that
    # tested no interior node this step.
    masks = torch.zeros((n, MAXD + 2), dtype=torch.int64, device=dev)
    bit = 1 << torch.arange(8, device=dev)
    act = torch.arange(n, device=dev)[node < nn]
    while act.numel():
        nd = node[act]
        mt = nodemeta[nd].long()
        depth = mt & 31
        rank = (mt >> 5) & 7
        leaf = (mt >> 8) > 0
        m = masks[act, depth]
        entered = (depth == 0) | (((m >> rank) & 1) > 0)
        row = nodesT[nd]
        ox, oy, oz = (o[act, k][:, None] for k in range(3))
        dx, dy, dz = (d[act, k][:, None] for k in range(3))
        mint = mint_all[act][:, None]
        maxt = maxt_all[act][:, None]
        bt = best_t[act]
        bi = best_id[act]

        # Leaf: 8 Moller-Trumbore tests (bvh_pallas.py:698-741).
        do_leaf = entered & leaf
        p0x, p0y, p0z = row[:, 0:8], row[:, 8:16], row[:, 16:24]
        e1x, e1y, e1z = row[:, 24:32], row[:, 32:40], row[:, 40:48]
        e2x, e2y, e2z = row[:, 48:56], row[:, 56:64], row[:, 64:72]
        pidf = row[:, 72:80]
        s1x = dy * e2z - dz * e2y
        s1y = dz * e2x - dx * e2z
        s1z = dx * e2y - dy * e2x
        div = s1x * e1x + s1y * e1y + s1z * e1z
        ok = torch.abs(div) > 1e-12
        inv = 1.0 / torch.where(ok, div, 1.0)
        sx, sy, sz = ox - p0x, oy - p0y, oz - p0z
        b1 = (sx * s1x + sy * s1y + sz * s1z) * inv
        s2x = sy * e1z - sz * e1y
        s2y = sz * e1x - sx * e1z
        s2z = sx * e1y - sy * e1x
        b2 = (dx * s2x + dy * s2y + dz * s2z) * inv
        t = (e2x * s2x + e2y * s2y + e2z * s2z) * inv
        valid = ok & (b1 >= 0.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0) & \
            (t > mint) & (t < torch.minimum(maxt, bt[:, None])) & \
            (pidf >= 0.0)
        if any_hit:
            valid = valid & (bi < 0)[:, None]
        tv = torch.where(valid, t, _BIG)
        tmin = tv.min(dim=1).values
        idv = torch.where(valid & (tv <= tmin[:, None]), pidf, _BIG)
        idmin = idv.min(dim=1).values
        upd = do_leaf & (tmin < bt)
        best_t[act] = torch.where(upd, tmin, bt)
        best_id[act] = torch.where(upd, idmin.to(torch.int32), bi)

        # Interior: slab tests of the 8 child boxes (bvh_pallas.py:743-775).
        tested = entered & ~leaf
        ix, iy, iz = (inv_all[act, k][:, None] for k in range(3))
        tx0, tx1 = (row[:, 0:8] - ox) * ix, (row[:, 24:32] - ox) * ix
        ty0, ty1 = (row[:, 8:16] - oy) * iy, (row[:, 32:40] - oy) * iy
        tz0, tz1 = (row[:, 16:24] - oz) * iz, (row[:, 40:48] - oz) * iz
        t0 = torch.maximum(
            torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1)),
            torch.maximum(torch.minimum(tz0, tz1), mint))
        t1 = torch.minimum(
            torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1)),
            torch.minimum(torch.maximum(tz0, tz1),
                          torch.minimum(maxt, bt[:, None]) * (1.0 + 1e-6)))
        packed = torch.where(t0 <= t1, bit, 0).sum(dim=1)
        slot = torch.where(tested, depth + 1, MAXD + 1)
        masks[act, slot] = packed
        nxt = torch.where(tested & (packed != 0), nd + 1,
                          nodeskip[nd].long())
        node[act] = nxt
        keep = nxt < nn
        if any_hit:
            keep = keep & (best_id[act] < 0)
        act = act[keep]
    return best_t, best_id


def sort_key(bvh, o, d):
    """Coherence sort key: direction octant (3 bits) then a 7-bit-per-axis
    Morton code of the origin in the scene box (bvh_pallas.py:1242-1264),
    in int64."""
    oct_ = ((d[:, 0] < 0).long() * 4 + (d[:, 1] < 0).long() * 2 +
            (d[:, 2] < 0).long())
    ext = torch.clamp(bvh.bounds_hi - bvh.bounds_lo, min=1e-6)
    q = torch.clamp((o - bvh.bounds_lo) / ext * 127.0, 0.0, 127.0).long()

    def spread(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    morton = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | \
        spread(q[:, 2])
    return (oct_ << 27) | (morton & ((1 << 27) - 1))


def intersect(bvh, o, d, mint, maxt, any_hit: bool = False,
              sort: bool = True):
    """Traversal front end: (t_raw, prim_id, hit). Rays go to the kernel in
    sort-key order through one row gather of the packed [N, 8] rays, and
    the results come back to ray order by one scatter."""
    rays8 = torch.cat([o, d, mint[:, None], maxt[:, None]], dim=1)
    order = None
    if sort:
        order = torch.argsort(sort_key(bvh, o, d), stable=True)
        rays8 = rays8[order]
    t, ids = traverse_tiles(bvh.nodesT, bvh.nodeskip, bvh.nodemeta,
                            rays8.T.contiguous(), nn=bvh.n_nodes,
                            any_hit=any_hit)
    if order is not None:
        t = torch.empty_like(t).index_copy_(0, order, t)
        ids = torch.empty_like(ids).index_copy_(0, order, ids)
    return t, ids, ids >= 0
