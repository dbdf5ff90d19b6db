"""Dense ray-triangle intersection: the hand-written CUDA kernel, its plain
torch version and the front end (port of tpuprt/ops/mt_pallas.py mt_best
and intersect_tris).

``csrc/mt_best.cu`` tests every ray against every triangle and keeps the
nearest hit, the lowest triangle index winning among equal t, or in any-hit
mode the lowest-index hit. It drops most pairs on exact sign tests before
the division; `settle_stage` is that predicate in torch ops, for the
bound's counts and the tests. `mt_best` launches the kernel for CUDA
tensors and runs `mt_best_ref` only for CPU tensors: there is no fallback
from one to the other. The kernel is compiled with nvcc at first use into
``tpuprt_torch/_build/`` and bound through ctypes, as the traversal
kernels are (ops/bvh_cuda.py).
"""
from __future__ import annotations

import ctypes
import os

import torch

from ..core import vecmath as vm
from ..shapes import triangle
from . import bvh_cuda, launch_counter

_BIG = 1e30
# The plain version's [rays, triangles] chunk: at most this many pairs, so
# its temporaries stay within a few GB at any scene size.
REF_CHUNK_PAIRS = 1 << 27

MT_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "mt_best.cu")

# Kernel launches, counted by the wrapper where it launches (plain
# integers; callers may reset them): all of them, and the any-hit ones.
launches = launch_counter("mt_best", "mt_best_any")
# The guards of the kernel's sign test (mt_best.cu kNumMin, kDivMax).
NUM_MIN, DIV_MAX = 1e-20, 1e20
# The stages at which the kernel settles a pair (settle_stage), in order.
STAGES = ("b1", "b2", "t", "full")

_P = ctypes.c_void_p
_I = ctypes.c_int


def _entry():
    fn = bvh_cuda.build(MT_SRC).mt_best_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [_P, _I, _P, _I, _I, _P, _P, _P]
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


@bvh_cuda.nondiff
def mt_best(rays, tris, any_hit: bool = False):
    """Nearest hit of packed rays f32[8,N] over packed triangles f32[9,T]
    (pack_tris), or with any_hit the lowest-index hit. Returns (t f32[N],
    1e30 = miss; id i32[N], -1 = miss), neither differentiable. CUDA
    tensors launch the kernel; CPU tensors run the plain version."""
    _check(rays, tris)
    if rays.device.type == "cpu":
        return mt_best_ref(rays, tris, any_hit=any_hit)
    if rays.device.type != "cuda":
        raise ValueError(f"no mt_best kernel for device {rays.device}")
    n = rays.shape[1]
    t = torch.empty(n, dtype=torch.float32, device=rays.device)
    ids = torch.empty(n, dtype=torch.int32, device=rays.device)
    err = _entry()(rays.data_ptr(), n, tris.data_ptr(), tris.shape[1],
                   int(any_hit), t.data_ptr(), ids.data_ptr(),
                   torch.cuda.current_stream(rays.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mt_best kernel launch failed: CUDA error {err}")
    launches["mt_best"] += 1
    if any_hit:
        launches["mt_best_any"] += 1
    return t, ids


def neg_settled(num, div):
    """The kernel's sign test, for |div| > 1e-12: True where fl(num *
    fl(1 / div)) is certainly negative, so that b >= 0 (or t > mint >= 0)
    fails: num with div's sign folded in is <= -NUM_MIN and |div| <=
    DIV_MAX (then |inv| >= 1e-20, and the product cannot round to -0)."""
    q = torch.where(torch.signbit(div), -num, num)
    return (q <= -NUM_MIN) & (torch.abs(div) <= DIV_MAX)


def settle_stage(v0, e1, e2, o, d, mint):
    """The stage at which mt_best.cu settles each pair (arguments broadcast
    as in triangle.intersect_edges), as i64: 0 when |div| <= 1e-12 or b1 is
    settled negative, 1 when b2 is, 2 when mint >= 0 and t is, 3 when the
    pair takes the full test. A pair the full rule accepts is always 3."""
    s1 = vm.cross(d, e2)
    div = vm.dot(s1, e1)
    s = o - v0
    n1 = vm.dot(s, s1)
    s2 = vm.cross(s, e1)
    n2 = vm.dot(d, s2)
    nt = vm.dot(e2, s2)
    r1 = ~(torch.abs(div) > 1e-12) | neg_settled(n1, div)
    r3 = (mint >= 0.0) & neg_settled(nt, div)
    return torch.where(r1, 0, torch.where(neg_settled(n2, div), 1,
                                          torch.where(r3, 2, 3)))


def mt_best_ref(rays, tris, any_hit: bool = False,
                with_counts: bool = False):
    """mt_best in plain torch ops: all pairs in chunks of rays, each chunk
    [chunk, T] under REF_CHUNK_PAIRS pairs. Nearest: invalid pairs masked to
    1e30 and torch.min along the triangles, which returns the first index
    at a tie (the kernel's rule). Any hit: the first valid index. A valid
    pair needs t < 1e30, as the kernel's first update does.

    with_counts also returns the pairs these rays need tested, by the stage
    that settles them (settle_stage): dict(tri=all of them, b1=, b2=, t=,
    full=). Nearest: every triangle for each ray with a non-empty window;
    any hit: those up to and including its first hit. Rays with an empty
    window test nothing (the kernel skips them)."""
    n = rays.shape[1]
    n_tris = tris.shape[1]
    dev = rays.device
    t_out = torch.full((n,), _BIG, dtype=torch.float32, device=dev)
    id_out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    v0, e1, e2 = tris[0:3].T, tris[3:6].T, tris[6:9].T
    stages = torch.zeros(len(STAGES), dtype=torch.int64, device=dev)
    step = max(1, REF_CHUNK_PAIRS // max(n_tris, 1))
    for r0 in range(0, n if n_tris else 0, step):
        r = rays[:, r0:r0 + step]
        o, d = r[0:3].T[:, None], r[3:6].T[:, None]
        mint, maxt = r[6][:, None], r[7][:, None]
        t, _, _, valid = triangle.intersect_edges(
            v0[None], e1[None], e2[None], o, d, mint, maxt)
        tv = torch.where(valid, t, _BIG)
        if any_hit:
            valid = tv < _BIG
            hit = valid.any(dim=1)
            arg = valid.to(torch.uint8).argmax(dim=1)
            tmin = torch.where(hit, tv.gather(1, arg[:, None])[:, 0], _BIG)
        else:
            tmin, arg = tv.min(dim=1)
            hit = tmin < _BIG
        t_out[r0:r0 + step] = tmin
        id_out[r0:r0 + step] = torch.where(hit, arg.to(torch.int32), -1)
        if with_counts:
            need = (mint <= maxt).expand(-1, n_tris)
            if any_hit:
                last = torch.where(hit, arg, n_tris - 1)
                need = need & (torch.arange(n_tris, device=dev)[None] <=
                               last[:, None])
            st = settle_stage(v0[None], e1[None], e2[None], o, d, mint)
            stages += torch.bincount(st[need], minlength=len(STAGES))
    if with_counts:
        counts = dict(zip(STAGES, stages.tolist()))
        counts["tri"] = sum(counts.values())
        return t_out, id_out, counts
    return t_out, id_out


def ray_order(box, o, d, mint, maxt):
    """intersect_packed's order of any-hit rays: bvh_cuda.sort_key over
    `box` (lo f32[3], hi f32[3]: any box around the scene), those with an
    empty window last."""
    key = torch.where(mint <= maxt, bvh_cuda.sort_key(box[0], box[1], o, d),
                      1 << 30)
    return torch.argsort(key, stable=True)


def winners(tris, box, o, d, mint, maxt, any_hit: bool = False):
    """Each ray's winning triangle id over packed triangles f32[9,T] by
    mt_best, -1 = none. With any_hit the kernel stops at each ray's
    lowest-index hit; those rays (shadow batches, incoherent) go to mt_best
    in ray_order over `box` and the ids come back to ray order. Nearest
    calls keep lane order: their rays come coherent, and the sort cost more
    than it saved there (PERF.md)."""
    rays = torch.cat([o, d, mint[:, None], maxt[:, None]], dim=1)
    if any_hit:
        order = ray_order(box, o, d, mint, maxt)
        ids, = bvh_cuda.unsort(order, mt_best(
            rays[order].T.contiguous(), tris, any_hit=True)[1])
        return ids
    return mt_best(rays.T.contiguous(), tris)[1]


def recompute(ids, v0, e1, e2, o, d, mint, maxt):
    """The winners' t through triangle.intersect_edges (the steps of
    intersect_pairs) on the winners' vertex v0 and edges e1, e2 f32[N,3]:
    (t f32[N], 1e30 = miss; id, -1 = miss; hit). A winner whose recompute
    is invalid is dropped. t is differentiable in o, d, mint and the
    vertices."""
    t_exact, _, _, v_exact = triangle.intersect_edges(v0, e1, e2, o, d, mint,
                                                      maxt)
    hit = (ids >= 0) & v_exact
    return torch.where(hit, t_exact, _BIG), torch.where(hit, ids, -1), hit


def intersect_packed(tris, box, o, d, mint, maxt, any_hit: bool = False):
    """Nearest hit over packed triangles f32[9,T]: (t f32[N], id i32[N],
    hit bool[N]): winners, then recompute on the packed rows of the
    winners (with any_hit, hit is the same mask, t and id the kernel's
    hit's). Gradients reach the triangles only through `tris`."""
    ids = winners(tris, box, o, d, mint, maxt, any_hit)
    if tris.shape[1] == 0:
        return torch.full_like(mint, _BIG), ids, ids >= 0
    w = tris[:, torch.clamp(ids, min=0).long()]
    return recompute(ids, w[0:3].T, w[3:6].T, w[6:9].T, o, d, mint, maxt)


def intersect_tris(p0, p1, p2, o, d, mint, maxt):
    """Nearest hit over T triangles given by their vertices f32[T,3]
    (intersect_tris of mt_pallas.py): pack_tris, then intersect_packed in
    the triangles' box."""
    pts = torch.cat([p0, p1, p2])
    box = (pts.amin(dim=0), pts.amax(dim=0)) if len(pts) else \
        (o.new_zeros(3), o.new_ones(3))
    return intersect_packed(pack_tris(p0, p1, p2), box, o, d, mint, maxt)
