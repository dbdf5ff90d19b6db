"""The brute-force triangle kernel's plain version (ops/mt_cuda.mt_best_ref)
and front end (intersect_tris) held against tpuprt's Pallas mt_best and
intersect_tris, run in interpret mode, on the shapes of test_mt_pallas.py.

Half the rays aim at points inside random triangles, a fifth carry the
pool's empty window (mint 1 > maxt -1), and the last tenth of the
triangles repeat the first tenth, so the exact ties whose lowest index
must win are there. The any-hit mode, the stage counts of the bound and
the kernel's staged rejects (mt_cuda.settle_stage, neg_settled) are held
on random, duplicate and adversarial sets. The CUDA kernel itself runs
only on a card: chip_smoke.py holds it against mt_best_ref there.

The staged tests' mirror is checked in test_torch_mt_stages.py (no file
holds more than ten cases).
"""
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import chip_smoke
from test_mt_pallas import _random_rays, _random_tris
from test_torch_bvh import assert_hits_agree
from tpuprt.ops import mt_pallas
from tpuprt.shapes import triangle as jtri
from tpuprt_torch.ops import mt_cuda
from tpuprt_torch.scene.data import TriangleTable
from tpuprt_torch.shapes import triangle as ttri

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tris_and_rays(n, t, seed):
    """(p0, p1, p2 f32[t,3], o, d f32[n,3], mint, maxt f32[n]); the last
    t // 10 triangles copy the first ones."""
    p0, p1, p2 = _random_tris(t - t // 10, seed=seed)
    p0, p1, p2 = (np.concatenate([p, p[:t // 10]]) for p in (p0, p1, p2))
    o, d, mint, maxt = _random_rays(n, seed=seed + 1)
    rng = np.random.default_rng(seed + 2)
    k = rng.integers(0, t, n // 2)
    b = rng.dirichlet(np.ones(3), n // 2).astype(np.float32)
    tgt = b[:, :1] * p0[k] + b[:, 1:2] * p1[k] + b[:, 2:] * p2[k]
    aim = tgt - o[:n // 2]
    d[:n // 2] = aim / np.linalg.norm(aim, axis=1, keepdims=True)
    mint[::5], maxt[::5] = 1.0, -1.0
    return p0, p1, p2, o, d, mint, maxt


def condition(p0, p1, p2, o, d, ids):
    """How much each ray's pair with triangle `ids` amplifies rounding in
    t = (e2 . s2) / (s1 . e1): the sum of the two dot products'
    cancellation factors |a||b| / |a . b|, in float64."""
    k = np.maximum(ids, 0)
    v0, e1, e2 = (x.astype(np.float64) for x in (p0[k], p1[k] - p0[k],
                                                  p2[k] - p0[k]))
    s1 = np.cross(d.astype(np.float64), e2)
    s2 = np.cross(o.astype(np.float64) - v0, e1)
    n = np.linalg.norm
    return (n(s1, axis=1) * n(e1, axis=1) / np.abs((s1 * e1).sum(1)) +
            n(e2, axis=1) * n(s2, axis=1) / np.abs((e2 * s2).sum(1)))


def assert_t_agrees(t_ref, t, id_ref, ids, cond):
    """Equal hit masks, equal ids outside ties, and t within 1e-6 relative
    times the pair's condition number (at least 2) of tpuprt's. XLA:CPU
    contracts multiply-adds into FMAs and sums tpuprt's dot products in its
    own order; eager torch (and the CUDA kernel, built -fmad=false) does
    neither. A pair nearly parallel to the ray amplifies that rounding
    difference by its condition number (up to 1.6e-4 relative in these
    sets)."""
    rel = assert_hits_agree(t_ref, id_ref, t, ids, t_rtol=np.inf)
    hit = np.asarray(id_ref) >= 0
    assert np.all(rel <= 1e-6 * cond[hit]), (rel / cond[hit]).max()


def pallas_mt_best(p0, p1, p2, rays):
    """tpuprt's mt_best on rays f32[8,N], padded to its tiles as
    intersect_tris pads them (padding rays carry an empty window)."""
    n, t = rays.shape[1], len(p0)
    npad = -(-n // mt_pallas.RAY_TILE) * mt_pallas.RAY_TILE
    tpad = -(-t // mt_pallas.TRI_TILE) * mt_pallas.TRI_TILE
    r = np.pad(rays, ((0, 0), (0, npad - n)))
    r[6, n:], r[7, n:] = 1.0, -1.0
    tris = jnp.pad(mt_pallas.pack_tris(*map(jnp.asarray, (p0, p1, p2))),
                   ((0, 0), (0, tpad - t)))
    jt, jid = mt_pallas.mt_best(jnp.asarray(r), tris,
                                jnp.asarray([t], jnp.int32), interpret=True)
    return np.asarray(jt)[:n], np.asarray(jid)[:n]


@pytest.mark.parametrize("n,t", [(64, 33), (256, 512), (300, 1000)])
def test_plain_mt_best_matches_pallas_interpret(n, t):
    p0, p1, p2, o, d, mint, maxt = tris_and_rays(n, t, seed=n)
    rays = np.ascontiguousarray(np.concatenate(
        [o, d, mint[:, None], maxt[:, None]], 1).T)
    jt, jid = pallas_mt_best(p0, p1, p2, rays)
    tris = mt_cuda.pack_tris(*map(torch.from_numpy, (p0, p1, p2)))
    tt, tid = mt_cuda.mt_best(torch.from_numpy(rays), tris)
    hit = jid >= 0
    assert hit.sum() >= n // 3 and not (tid[::5] >= 0).any()
    # Ties go to the lowest index on both sides: every ray that hits a
    # repeated triangle reports the original.
    assert not (tid.numpy() >= t - t // 10).any()
    assert_t_agrees(jt, tt, jid, tid, condition(p0, p1, p2, o, d, jid))
    assert np.all(tt.numpy()[~hit] == 1e30)


@pytest.mark.parametrize("n,t", [(64, 33), (300, 1000)])
def test_intersect_tris_matches_pallas_interpret(n, t):
    """The front end recomputes the winner's t through the triangle test on
    both sides: equal hit masks and ids, t as assert_t_agrees."""
    args = tris_and_rays(n, t, seed=3 * n)
    jt, jid, jhit = mt_pallas.intersect_tris(*map(jnp.asarray, args),
                                             interpret=True)
    tt, tid, thit = mt_cuda.intersect_tris(*map(torch.from_numpy, args))
    np.testing.assert_array_equal(thit.numpy(), np.asarray(jhit))
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    assert int(thit.sum()) >= n // 3
    assert_t_agrees(jt, tt, jid, tid, condition(*args[:5], np.asarray(jid)))


def test_all_pairs_intersect_matches_tpuprt():
    """shapes/triangle.intersect, the all-pairs test over a triangle table,
    against tpuprt's (both eager, so every step rounds alike), and its
    per-ray minimum against mt_best_ref's."""
    p0, p1, p2, o, d, mint, maxt = tris_and_rays(200, 60, seed=5)
    t = len(p0)
    verts = np.concatenate([p0, p1, p2])
    idx = np.arange(3 * t, dtype=np.int32).reshape(3, t).T.copy()
    z = torch.zeros
    tab = TriangleTable(
        verts=torch.from_numpy(verts), idx=torch.from_numpy(idx),
        normals=z(3 * t, 3), uv=z(3 * t, 2), tangents=z(3 * t, 3),
        has_normals=z(t, dtype=torch.bool),
        has_tangents=z(t, dtype=torch.bool),
        material=z(t, dtype=torch.int32), area_light=z(t, dtype=torch.int32),
        flip_normal=torch.ones(t), count=t)
    jt, jv = jtri.intersect(jtri.TriangleTable(
        verts=jnp.asarray(verts), idx=jnp.asarray(idx), normals=None,
        uv=None, tangents=None, has_normals=None, has_tangents=None,
        material=None, area_light=None, flip_normal=None, count=t),
        *map(jnp.asarray, (o, d, mint, maxt)))
    tt, tv = ttri.intersect(tab, *map(torch.from_numpy, (o, d, mint, maxt)))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert np.asarray(jv).any(1).sum() > 60
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5)
    rays = torch.from_numpy(np.ascontiguousarray(np.concatenate(
        [o, d, mint[:, None], maxt[:, None]], 1).T))
    t_ref, _ = mt_cuda.mt_best_ref(rays, mt_cuda.pack_tris(
        *map(torch.from_numpy, (p0, p1, p2))))
    assert torch.equal(tt.min(dim=1).values, t_ref)


def test_plain_chunks_and_counts(monkeypatch):
    """mt_best_ref gives the same answer whatever its chunk of rays, never
    forms more than REF_CHUNK_PAIRS pairs at once, and counts every
    triangle for each ray with a non-empty window, by the stage that
    settles it."""
    p0, p1, p2, o, d, mint, maxt = tris_and_rays(300, 100, seed=9)
    rays = torch.from_numpy(np.ascontiguousarray(np.concatenate(
        [o, d, mint[:, None], maxt[:, None]], 1).T))
    tris = mt_cuda.pack_tris(*map(torch.from_numpy, (p0, p1, p2)))
    t0, id0, counts = mt_cuda.mt_best_ref(rays, tris, with_counts=True)
    assert counts["tri"] == 240 * 100
    assert sum(counts[k] for k in mt_cuda.STAGES) == counts["tri"]
    assert min(counts[k] for k in mt_cuda.STAGES) > 0
    seen = []
    real = mt_cuda.triangle.intersect_edges

    def spy(v0, e1, e2, o, *rest):
        seen.append(o.shape[0] * v0.shape[1])
        return real(v0, e1, e2, o, *rest)

    monkeypatch.setattr(mt_cuda, "REF_CHUNK_PAIRS", 700)
    monkeypatch.setattr(mt_cuda.triangle, "intersect_edges", spy)
    t1, id1 = mt_cuda.mt_best_ref(rays, tris)
    assert len(seen) == 43 and max(seen) <= 700
    assert torch.equal(t0, t1) and torch.equal(id0, id1)


def test_wrapper_checks():
    rays = torch.zeros(8, 4)
    tris = torch.zeros(9, 3)
    with pytest.raises(ValueError, match="no mt_best kernel"):
        mt_cuda.mt_best(rays.to("meta"), tris.to("meta"))
    with pytest.raises(ValueError, match="f32\\[9,T\\]"):
        mt_cuda.mt_best(rays, torch.zeros(16, 3))
    with pytest.raises(ValueError, match="f32\\[8,N\\]"):
        mt_cuda.mt_best(torch.zeros(7, 4), tris)
    with pytest.raises(TypeError, match="float32"):
        mt_cuda.mt_best(rays.double(), tris)
    with pytest.raises(ValueError, match="contiguous"):
        mt_cuda.mt_best(torch.zeros(4, 8).T, tris)
    t, ids = mt_cuda.mt_best(rays, torch.zeros(9, 0))
    assert torch.all(ids == -1) and torch.all(t == 1e30)


def _packed(p0, p1, p2, o, d, mint, maxt):
    rays = torch.from_numpy(np.ascontiguousarray(np.concatenate(
        [o, d, mint[:, None], maxt[:, None]], 1).T))
    return mt_cuda.pack_tris(*map(torch.from_numpy, (p0, p1, p2))), rays


def _sets():
    """(tris f32[9,T], rays f32[8,N]): random with repeats, every triangle
    repeated (coincident duplicates), and chip_smoke's adversarial set
    (grazing rays, vertex and edge hits, scales 1e-7 to 3e10)."""
    p0, p1, p2, o, d, mint, maxt = tris_and_rays(400, 120, seed=21)
    dup = [np.concatenate([p, p]) for p in (p0[:60], p1[:60], p2[:60])]
    tris, rays = chip_smoke.adversarial_mt_set(3, n_rays=1024)
    return {"random": _packed(p0, p1, p2, o, d, mint, maxt),
            "duplicates": _packed(*dup, o, d, mint, maxt),
            "adversarial": (torch.from_numpy(tris), torch.from_numpy(rays))}


def test_old_interface_is_checked(tmp_path):
    """chip_smoke --old binds an earlier bvh_tiles.cu or bvh_rows.cu only
    when every C interface OLD_INTERFACES lists for it is the listed one:
    the checkout's own sources, whose walks' interfaces differ, are refused
    before anything is built, and a source with the listed signatures is
    read as it."""
    for src, funcs in chip_smoke.OLD_INTERFACES.items():
        own = os.path.join(ROOT, "tpuprt_torch", "ops", "csrc", src)
        got = {name: chip_smoke.c_interface(own, name) for name in funcs}
        assert all(got.values()) and got != funcs
        with pytest.raises(SystemExit, match="not the interface"):
            chip_smoke.bind_old(os.path.dirname(own), src)
        text = ""
        for name, want in funcs.items():
            params = ", ".join(f"{t} a{i}" for i, t in
                               enumerate(want.split(", ")))
            text += f'extern "C" int {name}({params}) {{\n  return 0;\n}}\n'
        (tmp_path / src).write_text(text)
        for name, want in funcs.items():
            assert chip_smoke.c_interface(str(tmp_path / src), name) == want
