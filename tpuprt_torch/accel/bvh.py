"""Scene-level BVH intersection (port of tpuprt/accel/bvh.py, the path the
reference takes for quadric-free scenes).

The traversal kernel (ops/bvh_cuda.py) finds each ray's winning triangle;
the winner's t is then recomputed through the triangle test from the
rays' own o/d/mint, as the reference does (accel/bvh.py:84-88, with the
grid's prim tester), so t follows the reference's arithmetic and a later
gradient pass can reuse it.
"""
from __future__ import annotations

from ..ops import bvh_cuda
from ..scene.data import SceneData
from .grid import recompute_t


def intersect(scene: SceneData, o, d, mint, maxt, any_hit: bool = False):
    """Nearest hit (t, prim_id, hit); any_hit stops at the first hit found
    (IntersectP) and returns t unrecomputed."""
    if scene.accel.n_quadrics:
        raise NotImplementedError("quadric-bearing BVH scenes are not ported")
    t_raw, best_id, hit = bvh_cuda.intersect(scene.accel, o, d, mint, maxt,
                                             any_hit=any_hit)
    if any_hit:
        return t_raw, best_id, hit
    return recompute_t(scene, best_id, o, d, mint)
