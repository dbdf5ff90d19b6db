"""BVH traversal: the hand-written CUDA kernels, their plain torch versions,
and the ray-sorting front end (port of tpuprt/ops/bvh_pallas.py
traverse_tiles, traverse_tiles_chunked, traverse, traverse_chunked,
traverse_instanced and intersect).

Two sources, three kernels: ``csrc/bvh_tiles.cu`` walks the tile-format
BVH (`traverse_tiles`); ``csrc/bvh_rows.cu`` walks the row format, a whole
table (`traverse_rows`) or an instanced aggregate's prototype blocks
(`traverse_instanced`); the brute force's kernel is in ops/mt_cuda.py.
Each wrapper launches its kernel for CUDA tensors and runs its plain
version (``*_ref``) only for CPU tensors: there is no fallback from one to
the other. The kernels are compiled with nvcc at first use into
``tpuprt_torch/_build/`` and bound through ctypes. Under autograd each
wrapper is a `nondiff` function: its outputs carry no gradient, and the
callers recompute the winners' t from live tables, as tpuprt detaches
its walks (accel/bvh.py:69-72).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
import shutil

import torch

from ..core import transform as tf
from ..native import build_shared
from . import launch_counter

MAXD = 32          # per-depth mask slots (build_tiles rejects deeper trees)
ROWS_LOCAL_LEVELS = 32   # bvh_rows.cu kLocalLevels (stack levels, local)
_BIG = 1e30

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
KERNEL_SRC = os.path.join(_CSRC, "bvh_tiles.cu")
ROWS_SRC = os.path.join(_CSRC, "bvh_rows.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC"]

# Kernel launches by kernel name, counted by the wrappers where they launch
# (plain integers; callers may reset them); bvh_tiles_any counts the tile
# walk's any-hit launches among bvh_tiles'.
launches = launch_counter("bvh_tiles", "bvh_tiles_any", "bvh_rows",
                          "bvh_instanced")

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _nvcc_cmd():
    """nvcc from PATH, else from the toolkit's default location. Resolved
    once a process: every launch looks its library up by this command, so
    a launch does not search PATH."""
    return [shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"] + NVCC_FLAGS


def build(src):
    """Build (if needed) and load one kernel source's shared library."""
    return build_shared(src, _nvcc_cmd())


def _bind(src, name, argtypes):
    fn = getattr(build(src), name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def _tiles_entry():
    return _bind(KERNEL_SRC, "bvh_tiles_launch",
                 [_P, _P, _P, _I, _I, _I, _P, _P, _P])


def _rows_entry():
    return _bind(ROWS_SRC, "bvh_rows_launch",
                 [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P])


def _instanced_entry():
    return _bind(ROWS_SRC, "bvh_instanced_launch",
                 [_P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _P, _P,
                  _P, _P])


class NonDiff(torch.autograd.Function):
    """A kernel's wrapper under autograd (tpuprt's custom_vjp of mt_best,
    mt_pallas.py:159-179, and the stop_gradients around its walks):
    forward runs fn(*args, **kw) with autograd off, its outputs are marked
    non-differentiable, and backward gives no input a gradient."""

    @staticmethod
    def forward(ctx, fn, kw, *args):
        ctx.n_args = len(args)
        out = fn(*args, **kw)
        ctx.mark_non_differentiable(*out)
        return out

    @staticmethod
    def backward(ctx, *grads):
        return (None,) * (2 + ctx.n_args)


def nondiff(fn):
    """fn, returning a tuple of tensors, as a NonDiff call: its outputs
    carry no gradient to or from any of its arguments."""
    @functools.wraps(fn)
    def call(*args, **kw):
        return NonDiff.apply(fn, kw, *args)
    return call


def _check_tensors(dev, *specs):
    """Each (name, tensor, dtype) on `dev`, of that dtype, contiguous."""
    for name, x, dt in specs:
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, rays on {dev}")
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_rays(rays):
    if rays.dim() != 2 or rays.shape[0] != 8:
        raise ValueError(f"rays must be f32[8,N], got {tuple(rays.shape)}")
    if rays.numel() >= 2 ** 31:
        raise ValueError("the kernels index rays with 32-bit ints")


def _on_card(rays, *tables):
    """True for CUDA tensors (launch), False for CPU ones (plain version);
    anything else raises."""
    if rays.device.type == "cpu":
        return False
    if rays.device.type != "cuda":
        raise ValueError(f"no traversal kernel for device {rays.device}")
    if any(x.data_ptr() % 16 for x in tables):
        raise ValueError("node tables must be 16-byte aligned")
    return True


def _launch(name, fn, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1


def _check(nodesT, nodeskip, nodemeta, child, rays, nn):
    _check_tensors(rays.device, ("nodesT", nodesT, torch.float32),
                   ("nodeskip", nodeskip, torch.int32),
                   ("nodemeta", nodemeta, torch.int32),
                   ("child", child, torch.int32),
                   ("rays", rays, torch.float32))
    if nodesT.dim() != 2 or nodesT.shape[1] != 128 or \
            nodesT.shape[0] < nn or nodeskip.shape != (nodesT.shape[0],) or \
            nodemeta.shape != (nodesT.shape[0],):
        raise ValueError("node tables must be f32[NN,128], i32[NN], i32[NN]")
    if child.dim() != 2 or child.shape[1] != 8 or child.shape[0] < nn:
        raise ValueError("child must be i32[NN,8] (accel/bvh_build."
                         "child_table)")
    _check_rays(rays)


@nondiff
def traverse_tiles(nodesT, nodeskip, nodemeta, child, rays, *, nn: int,
                   any_hit: bool = False):
    """Nearest (or any) hit of packed rays f32[8,N] against the tile-format
    BVH. Returns (t f32[N], id i32[N], -1 = miss). CUDA tensors launch the
    kernel, which descends by the child-id table `child` and reads neither
    skip nor meta; CPU tensors run the plain version, the skip-link walk
    (bit-identical: both enter the same nodes in the same order)."""
    _check(nodesT, nodeskip, nodemeta, child, rays, nn)
    if not _on_card(rays, nodesT, child):
        return traverse_tiles_ref(nodesT, nodeskip, nodemeta, rays, nn=nn,
                                  any_hit=any_hit)
    n = rays.shape[1]
    t = torch.empty(n, dtype=torch.float32, device=rays.device)
    ids = torch.empty(n, dtype=torch.int32, device=rays.device)
    _launch("bvh_tiles", _tiles_entry(), nodesT.data_ptr(), child.data_ptr(),
            rays.data_ptr(), n, nn, int(any_hit), t.data_ptr(),
            ids.data_ptr(), torch.cuda.current_stream(rays.device).cuda_stream)
    if any_hit:
        launches["bvh_tiles_any"] += 1
    return t, ids


def _safe_inv(v):
    tiny = torch.where(v < 0, -1e-12, 1e-12)
    return 1.0 / torch.where(torch.abs(v) < 1e-12, tiny, v)


def traverse_tiles_ref(nodesT, nodeskip, nodemeta, rays, *, nn: int,
                       any_hit: bool = False, with_counts: bool = False):
    """The kernel's walk in plain torch ops, vectorized over rays: a cursor
    per ray, one gather of its node row per step, until every cursor
    reaches NN. Rays whose walk ended drop out of the active set.
    with_counts also returns the work done: dict(slab=ray-box tests,
    tri=ray-triangle tests), 8 of one or the other per entered node, and
    steps=the cursor's steps, entered or not."""
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
    counts = dict(slab=0, tri=0, steps=0)
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
        if with_counts:
            counts["slab"] += 8 * int(tested.sum())
            counts["tri"] += 8 * int(do_leaf.sum())
            counts["steps"] += int(nd.numel())
    if with_counts:
        return best_t, best_id, counts
    return best_t, best_id


def _check_rows(nodes, nn):
    if nodes.dim() != 2 or nodes.shape[1] != 128 or nodes.shape[0] < nn:
        raise ValueError("rows must be f32[NN,128] (accel/bvh_build."
                         "pad_rows)")


def rows_stack_scratch(max_depth: int, n: int, device):
    """The row walk's stack levels past its ROWS_LOCAL_LEVELS local ones,
    for a tree `max_depth` deep (the descent keeps at most one entry per
    ancestor of the node it is at, and a node has at most max_depth):
    i32[max_depth - ROWS_LOCAL_LEVELS, n], laid out by ray, or None when
    the local levels hold the tree."""
    extra = max_depth - ROWS_LOCAL_LEVELS
    if extra <= 0:
        return None
    return torch.empty((extra, n), dtype=torch.int32, device=device)


@nondiff
def traverse_rows(nodes, rays, *, nn: int, max_depth: int,
                  any_hit: bool = False):
    """Nearest (or any) hit of packed rays f32[8,N] against the row-format
    BVH nodes f32[>=NN,128], walking node ids [0, NN). Returns (t f32[N],
    id i32[N], -1 = miss). CUDA tensors launch bvh_rows.cu's row walk,
    which descends by the child ids in its interior rows (cols 8..15)
    with a stack sized from the tree's depth `max_depth` (BvhAccel.
    max_depth; rows_stack_scratch, any depth; a tree deeper than that
    traps the kernel); CPU tensors run the plain version, the skip-link
    walk (bit-identical)."""
    _check_tensors(rays.device, ("nodes", nodes, torch.float32),
                   ("rays", rays, torch.float32))
    _check_rows(nodes, nn)
    _check_rays(rays)
    if max_depth is None or max_depth < 0:
        raise ValueError(f"max_depth must be the tree's depth, got "
                         f"{max_depth}")
    if not _on_card(rays, nodes):
        return traverse_rows_ref(nodes, rays, nn=nn, any_hit=any_hit)
    n = rays.shape[1]
    t = torch.empty(n, dtype=torch.float32, device=rays.device)
    ids = torch.empty(n, dtype=torch.int32, device=rays.device)
    scratch = rows_stack_scratch(max_depth, n, rays.device)
    _launch("bvh_rows", _rows_entry(), nodes.data_ptr(), rays.data_ptr(), n,
            nn, int(any_hit), max_depth,
            None if scratch is None else scratch.data_ptr(), t.data_ptr(),
            ids.data_ptr(), torch.cuda.current_stream(rays.device).cuda_stream)
    return t, ids


def _slab_hit(box, o, inv, mint, clip):
    """Slab test of boxes box[..., 0:6] (lo xyz, hi xyz) against rays with
    origins o[..., 3], inverse directions inv[..., 3] and windows [mint,
    clip], all broadcast, in the kernels' order of operations."""
    t0 = [(box[..., k] - o[..., k]) * inv[..., k] for k in range(3)]
    t1 = [(box[..., 3 + k] - o[..., k]) * inv[..., k] for k in range(3)]
    near = torch.maximum(
        torch.maximum(torch.minimum(t0[0], t1[0]),
                      torch.minimum(t0[1], t1[1])),
        torch.maximum(torch.minimum(t0[2], t1[2]), mint))
    far = torch.minimum(
        torch.minimum(torch.maximum(t0[0], t1[0]),
                      torch.maximum(t0[1], t1[1])),
        torch.minimum(torch.maximum(t0[2], t1[2]), clip))
    return near <= far


def _walk_rows(nodes, o, d, mint, maxt, start, stop, base, any_hit):
    """The kernel's walk_range in plain torch ops, vectorized over lanes:
    lane k walks node ids [start[k], stop[k]), node n of lane k stored at
    row base[k] + n - start[k]. One gather of each active lane's row per
    step; lanes whose walk ended drop out of the active set. Returns
    (best_t, best_id, visits, leaves, entered): per lane, the nodes whose
    box it tested, the leaves whose 8 triangles it tested and the nodes
    whose box test passed (i64[n] each)."""
    n = o.shape[0]
    dev = o.device
    inv = _safe_inv(d)
    best_t = torch.full((n,), _BIG, dtype=torch.float32, device=dev)
    best_id = torch.full((n,), -1, dtype=torch.int32, device=dev)
    node = start.clone()
    visits = torch.zeros(n, dtype=torch.int64, device=dev)
    leaves = torch.zeros_like(visits)
    entered = torch.zeros_like(visits)
    act = torch.arange(n, device=dev)[node < stop]
    while act.numel():
        nd = node[act]
        row = nodes[base[act] + nd - start[act]]
        skip = row[:, 6].long()
        nprims = row[:, 7].long()

        # Slab test of the node's own box (bvh_pallas.py:107-124).
        hit = _slab_hit(row, o[act], inv[act], mint[act],
                        torch.minimum(maxt[act], best_t[act]) * (1.0 + 1e-6))
        leaf = nprims > 0

        # Leaf: 8 Moller-Trumbore tests in slot order, each against the
        # running best (bvh_pallas.py:128-160), on the lanes that hit it.
        lf = hit & leaf
        li = act[lf]
        if li.numel():
            r = row[lf]
            np_ = nprims[lf]
            ox, oy, oz = o[li, 0], o[li, 1], o[li, 2]
            dx, dy, dz = d[li, 0], d[li, 1], d[li, 2]
            mn, mx = mint[li], maxt[li]
            bt, bi = best_t[li], best_id[li]
            for j in range(8):
                c = 8 + 9 * j
                p0x, p0y, p0z = r[:, c], r[:, c + 1], r[:, c + 2]
                e1x, e1y, e1z = (r[:, c + 3] - p0x, r[:, c + 4] - p0y,
                                 r[:, c + 5] - p0z)
                e2x, e2y, e2z = (r[:, c + 6] - p0x, r[:, c + 7] - p0y,
                                 r[:, c + 8] - p0z)
                pid = r[:, 80 + j].to(torch.int32)
                s1x = dy * e2z - dz * e2y
                s1y = dz * e2x - dx * e2z
                s1z = dx * e2y - dy * e2x
                div = s1x * e1x + s1y * e1y + s1z * e1z
                ok = torch.abs(div) > 1e-12
                inv_div = 1.0 / torch.where(ok, div, 1.0)
                sx, sy, sz = ox - p0x, oy - p0y, oz - p0z
                b1 = (sx * s1x + sy * s1y + sz * s1z) * inv_div
                s2x = sy * e1z - sz * e1y
                s2y = sz * e1x - sx * e1z
                s2z = sx * e1y - sy * e1x
                b2 = (dx * s2x + dy * s2y + dz * s2z) * inv_div
                t = (e2x * s2x + e2y * s2y + e2z * s2z) * inv_div
                valid = ok & (b1 >= 0.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0) & \
                    (t > mn) & (t < torch.minimum(mx, bt)) & (j < np_) & \
                    (pid >= 0)
                if any_hit:
                    valid = valid & (bi < 0)
                upd = valid & (t < bt)
                bt = torch.where(upd, t, bt)
                bi = torch.where(upd, pid, bi)
            best_t[li] = bt
            best_id[li] = bi

        nxt = torch.where(hit & ~leaf, nd + 1, skip)
        node[act] = nxt
        keep = nxt < stop[act]
        if any_hit:
            keep = keep & (best_id[act] < 0)
        visits[act] += 1
        leaves[li] += 1
        entered[act] += hit.long()
        act = act[keep]
    return best_t, best_id, visits, leaves, entered


def traverse_rows_ref(nodes, rays, *, nn: int, any_hit: bool = False,
                      with_counts: bool = False):
    """traverse_rows in plain torch ops (the walk of [0, NN) from row 0 for
    every ray). with_counts also returns dict(slab=, tri=, entered=): the
    ray-box and ray-triangle tests of the walk and the nodes whose box test
    passed."""
    n = rays.shape[1]
    zero = torch.zeros(n, dtype=torch.int64, device=rays.device)
    t, ids, visits, leaves, entered = _walk_rows(
        nodes, rays[0:3].T, rays[3:6].T, rays[6], rays[7], zero,
        torch.full_like(zero, nn), zero, any_hit)
    if with_counts:
        return t, ids, dict(slab=int(visits.sum()), tri=8 * int(leaves.sum()),
                            entered=int(entered.sum()))
    return t, ids


@nondiff
def traverse_instanced(nodes, entry_block, entry_inst, entry_start,
                       entry_stop, entry_bbox, w2o12, rays, *, cap: int,
                       top, any_hit: bool = False):
    """Nearest (or any) hit of packed rays f32[8,N] against an instanced
    aggregate: per entry e (an instance's prototype node block), a world
    bbox test, then the walk of proto-local node ids [entry_start[e],
    entry_stop[e]) at rows entry_block[e] * cap + (node - entry_start[e])
    of `nodes`, with the ray moved to object space by the instance's w2o12
    row (the top 3 rows of w2o). Nearest: the least (t, entry). Returns
    (t f32[N], proto_tri i32[N], inst i32[N]), -1 = miss. CUDA tensors
    launch bvh_rows.cu's instanced walk, which visits the entries through
    the top-level BVH `top` f32[NN_top,16] (accel/instances.build_top);
    CPU tensors run the plain version, which does not need it."""
    i32, f32 = torch.int32, torch.float32
    _check_tensors(rays.device, ("nodes", nodes, f32), ("top", top, f32),
                   ("entry_block", entry_block, i32),
                   ("entry_inst", entry_inst, i32),
                   ("entry_start", entry_start, i32),
                   ("entry_stop", entry_stop, i32),
                   ("entry_bbox", entry_bbox, f32), ("w2o12", w2o12, f32),
                   ("rays", rays, f32))
    e = entry_block.shape[0]
    if nodes.dim() != 2 or nodes.shape[1] != 128 or \
            nodes.shape[0] % cap or \
            any(x.shape != (e,) for x in (entry_inst, entry_start,
                                         entry_stop)) or \
            entry_bbox.shape != (e, 8) or w2o12.dim() != 2 or \
            w2o12.shape[1] != 12 or top.dim() != 2 or top.shape[1] != 16:
        raise ValueError("instance tables must be f32[blocks*cap,128], "
                         "i32[E] x 4, f32[E,8], f32[I,12], f32[NN_top,16]")
    _check_rays(rays)
    if not _on_card(rays, nodes, top, entry_bbox, w2o12):
        return traverse_instanced_ref(
            nodes, entry_block, entry_inst, entry_start, entry_stop,
            entry_bbox, w2o12, rays, cap=cap, any_hit=any_hit)
    n = rays.shape[1]
    t = torch.empty(n, dtype=f32, device=rays.device)
    ids = torch.empty(n, dtype=i32, device=rays.device)
    inst = torch.empty(n, dtype=i32, device=rays.device)
    _launch("bvh_instanced", _instanced_entry(), nodes.data_ptr(),
            top.data_ptr(), top.shape[0], entry_block.data_ptr(),
            entry_inst.data_ptr(), entry_start.data_ptr(),
            entry_stop.data_ptr(), entry_bbox.data_ptr(), w2o12.data_ptr(),
            cap, rays.data_ptr(), n, int(any_hit), t.data_ptr(),
            ids.data_ptr(), inst.data_ptr(),
            torch.cuda.current_stream(rays.device).cuda_stream)
    return t, ids, inst


def traverse_instanced_ref(nodes, entry_block, entry_inst, entry_start,
                           entry_stop, entry_bbox, w2o12, rays, *, cap: int,
                           any_hit: bool = False, with_counts: bool = False):
    """traverse_instanced in plain torch ops, without a walk per entry:

    1. the (ray, entry) pairs whose world bbox test passes with the ray's
       full window, in chunks of entries;
    2. one vectorized row walk over all pairs, each in its own object
       space and node range, with its own best (_walk_rows);
    3. per ray, the pair with the least (t, entry) among those that hit;
       any-hit takes the least entry.

    That defines the result. The kernel visits entries out of this order
    (through its top-level BVH) with the best so far, and takes a hit at
    equal t only from an earlier entry than the best's, so the earliest
    entry wins at equal t; clipping by another entry's best only prunes
    hits that could not win. An any-hit result may come from another entry
    than the least: only its mask is the plain version's. Rays with an
    empty window (mint > maxt) test nothing, as in the kernel.

    with_counts also returns dict(entry=, slab=, tri=, xform=): the
    entry-box, node-box and triangle tests and the rays moved to object
    space that these inputs need. Nearest: the entries whose box meets the
    ray's final window [mint, min(maxt, t)], each walked within that
    window (no order of entries clips a walk further). Any hit: the
    entries whose box the ray meets up to its first hit, walked as the
    kernel walks them. The kernel's top-level walk also tests node boxes
    and the boxes of entries its window does not reach; the counts leave
    those tests out."""
    n = rays.shape[1]
    dev = rays.device
    n_e = entry_block.shape[0]
    o, d, mint, maxt = rays[0:3].T, rays[3:6].T, rays[6], rays[7]
    inv = _safe_inv(d)
    live = torch.arange(n, device=dev)[mint <= maxt]
    lo, li = o[live][:, None], inv[live][:, None]
    mn = mint[live][:, None]
    clip = torch.clamp(maxt[live], max=_BIG)[:, None] * (1.0 + 1e-6)
    pr, pe = [], []
    # Entry boxes in chunks, so a chunk's [rays, entries] temporaries stay
    # near 2^24 elements.
    step = max(1, (1 << 24) // max(live.numel(), 1))
    for e0 in range(0, n_e, step):
        r, c = _slab_hit(entry_bbox[None, e0:e0 + step], lo, li, mn,
                         clip).nonzero(as_tuple=True)
        pr.append(live[r])
        pe.append(c + e0)
    pr = torch.cat(pr) if pr else torch.zeros(0, dtype=torch.int64,
                                              device=dev)
    pe = torch.cat(pe) if pe else torch.zeros_like(pr)

    # Pairs into object space, in the kernel's order of terms.
    m = w2o12[entry_inst[pe].long()]
    c = [[m[:, 4 * i + j] for j in range(4)] for i in range(3)]
    oo = tf.rows_apply_vector(c, o[pr]) + torch.stack(
        [c[0][3], c[1][3], c[2][3]], dim=-1)
    od = tf.rows_apply_vector(c, d[pr])
    start, stop = entry_start[pe].long(), entry_stop[pe].long()
    base = entry_block[pe].long() * cap
    bt, bi, visits, leaves, _ = _walk_rows(nodes, oo, od, mint[pr],
                                           maxt[pr], start, stop, base,
                                           any_hit)

    t_out = torch.full((n,), _BIG, dtype=torch.float32, device=dev)
    id_out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    inst_out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    h = bi >= 0
    r, t, e, pid = pr[h], bt[h], pe[h], bi[h]
    if not any_hit:
        tmin = torch.full((n,), _BIG, dtype=torch.float32,
                          device=dev).scatter_reduce(0, r, t, "amin")
        win = t == tmin[r]
        r, t, e, pid = r[win], t[win], e[win], pid[win]
    emin = torch.full((n,), n_e, dtype=torch.int64,
                      device=dev).scatter_reduce(0, r, e, "amin")
    sel = e == emin[r]
    r = r[sel]
    t_out[r] = t[sel]
    id_out[r] = pid[sel]
    inst_out[r] = entry_inst[e[sel]]
    if not with_counts:
        return t_out, id_out, inst_out
    if any_hit:
        need = pe <= emin[pr]
        visits, leaves = visits[need], leaves[need]
    else:
        tfin = torch.minimum(maxt, t_out)[pr]
        need = _slab_hit(entry_bbox[pe], o[pr], inv[pr], mint[pr],
                         tfin * (1.0 + 1e-6))
        _, _, visits, leaves, _ = _walk_rows(
            nodes, oo[need], od[need], mint[pr][need], tfin[need],
            start[need], stop[need], base[need], any_hit)
    n_need = int(need.sum())
    return t_out, id_out, inst_out, dict(
        entry=n_need, slab=int(visits.sum()), tri=8 * int(leaves.sum()),
        xform=n_need)


def sort_key(lo, hi, o, d):
    """Coherence sort key: direction octant (3 bits) then a 7-bit-per-axis
    Morton code of the origin in the box [lo, hi] (a BVH's, an instance
    table's or a scene's bounds; bvh_pallas.py:1242-1264), in int64, below
    2^30."""
    oct_ = ((d[:, 0] < 0).long() * 4 + (d[:, 1] < 0).long() * 2 +
            (d[:, 2] < 0).long())
    ext = torch.clamp(hi - lo, min=1e-6)
    q = torch.clamp((o - lo) / ext * 127.0, 0.0, 127.0).long()

    def spread(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    morton = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | \
        spread(q[:, 2])
    return (oct_ << 27) | (morton & ((1 << 27) - 1))


def walked_only(bvh):
    """`bvh` without what `intersect` does not read: the tiles and their
    child-id table `bvh.child` when it has tiles, else the rows (whose
    interior rows hold their children's ids)."""
    if bvh.nodesT is None:
        return dataclasses.replace(bvh, child=None)
    return dataclasses.replace(bvh, nodes=None)


def unsort(order, *xs):
    """Per-ray results `xs` of rays taken in `order` back to ray order (one
    scatter each)."""
    return tuple(torch.empty_like(x).index_copy_(0, order, x) for x in xs)


def intersect(bvh, o, d, mint, maxt, any_hit: bool = False,
              sort: bool = True):
    """Traversal front end: (t_raw, prim_id, hit). Rays go to the kernel in
    sort-key order through one row gather of the packed [N, 8] rays, and
    the results come back to ray order by one scatter. The tile walk runs
    when the BVH has tiles, the row walk otherwise (bvh_pallas.py:1295).
    t_raw carries no gradient."""
    rays8 = torch.cat([o, d, mint[:, None], maxt[:, None]], dim=1)
    order = None
    if sort:
        order = torch.argsort(sort_key(bvh.bounds_lo, bvh.bounds_hi, o, d),
                              stable=True)
        rays8 = rays8[order]
    rays = rays8.T.contiguous()
    if bvh.nodesT is not None:
        t, ids = traverse_tiles(bvh.nodesT, bvh.nodeskip, bvh.nodemeta,
                                bvh.child, rays, nn=bvh.n_nodes,
                                any_hit=any_hit)
    else:
        t, ids = traverse_rows(bvh.nodes, rays, nn=bvh.n_nodes,
                               max_depth=bvh.max_depth, any_hit=any_hit)
    if order is not None:
        t, ids = unsort(order, t, ids)
    return t, ids, ids >= 0
