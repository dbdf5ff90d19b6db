"""Scene-level BVH intersection (port of tpuprt/accel/bvh.py, the path the
reference takes for quadric-free scenes).

The traversal kernel (ops/bvh_cuda.py) finds each ray's winning triangle;
the winner's t is then recomputed through the triangle test from the
rays' own o/d/mint, as the reference does (accel/bvh.py:84-88), so t
follows the reference's arithmetic and a later gradient pass can reuse it.
"""
from __future__ import annotations

import torch

from ..ops import bvh_cuda
from ..scene.data import SceneData
from ..shapes import triangle

_BIG = 1e30


def _test_prims(scene: SceneData, pid, o, d, mint, maxt, active):
    """Test each lane's single candidate triangle; (t, valid)
    (accel/grid.py _test_prims, triangles only)."""
    nt = scene.triangles.count
    tid = torch.clamp(pid, 0, nt - 1).long()
    p0, p1, p2 = triangle.gather_verts(scene.triangles, tid)
    t, _, _, valid = triangle.intersect_pairs(p0, p1, p2, o, d, mint, maxt)
    valid = valid & active
    return torch.where(valid, t, _BIG), valid


def intersect(scene: SceneData, o, d, mint, maxt, any_hit: bool = False):
    """Nearest hit (t, prim_id, hit); any_hit stops at the first hit found
    (IntersectP) and returns t unrecomputed."""
    if scene.accel.n_quadrics:
        raise NotImplementedError("quadric-bearing BVH scenes are not ported")
    t_raw, best_id, hit = bvh_cuda.intersect(scene.accel, o, d, mint, maxt,
                                             any_hit=any_hit)
    if any_hit:
        return t_raw, best_id, hit
    t_diff, valid = _test_prims(scene, best_id, o, d, mint,
                                torch.full_like(maxt, _BIG), hit)
    return torch.where(hit & valid, t_diff, _BIG), best_id, hit
