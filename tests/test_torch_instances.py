"""The port's ObjectInstance path held against tpuprt on the CPU.

The scene is chip_smoke.rocks_scene_text on config4's terrain(30) with
Accelerator "bvh": 6 rocks at subdiv 1 (80 triangles each), rock 0
mirrored and rock 3 scaled non-uniformly, at 16x16 x 2 spp. On the CPU the
port runs its plain walks; tpuprt runs its Pallas instanced kernel in
interpret mode and its jnp walk for the main BVH.

- The instance table and the BVH rows equal tpuprt's (through the bridge,
  which builds the port's top-level BVH over the entries too).
- traverse_instanced_ref matches bvh_pallas.traverse_instanced.
- The top-level BVH holds every entry once inside nested boxes, and a walk
  of the entries in its order (or backwards) with the kernel's tie rule
  gives the plain version's result where repeated instances tie.
- intersect_ids and hit_geometry per ray, and the whole render, match.
- What the slice does not cover raises NotImplementedError; render()
  without a device asks for the card.

The refusals, the top-level BVH and the out-of-order walk are in
test_torch_instances_top.py (no file holds more than ten cases).
"""
import os
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from chip_smoke import rocks_scene_text
from test_torch_bvh import (assert_hits_agree, assert_tables_equal,
                            numpy_tables)
from tpuprt import render as jax_render
from tpuprt.accel import intersect as jisect
from tpuprt.cameras import cameras as jcam
from tpuprt.ops import bvh_pallas
from tpuprt.samplers import samplers as jsmp
from tpuprt.scene.parser import load_scene_string as jax_load
from tpuprt_torch import render as torch_render
from tpuprt_torch.accel import intersect as tisect
from tpuprt_torch.core import transform as tf
from tpuprt_torch.ops import bvh_cuda
from tpuprt_torch.scene.bridge import from_numpy_tables
from tpuprt_torch.scene.parser import load_scene_string

torch.set_num_threads(1)
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, "tools"))
from make_scenes import config4  # noqa: E402

RES, SPP = 16, 2


def rocks_text():
    base = (config4(30).replace('Accelerator "kdtree"', 'Accelerator "bvh"')
            .replace("[128]", f"[{RES}]")
            .replace('"integer pixelsamples" [4]',
                     f'"integer pixelsamples" [{SPP}]'))
    return rocks_scene_text(base, 6, 1, 0)


@pytest.fixture(scope="module")
def scenes():
    text = rocks_text()
    jscene, jopts = jax_load(text)
    tscene, topts = load_scene_string(text)
    return jscene, jopts, tscene, topts


def rays_at_rocks(inst, origins, n, seed):
    """f32[n,3] unit directions from `origins` f32[n,3] to seeded points
    inside the instances' world boxes, and the packed f32[8,n] rays (a
    fifth with a short maxt)."""
    rng = np.random.default_rng(seed)
    bb = inst.entry_bbox.numpy()
    e = rng.integers(0, len(bb), n)
    tgt = bb[e, 0:3] + rng.uniform(0, 1, (n, 3)) * (bb[e, 3:6] - bb[e, 0:3])
    d = tgt - origins
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mint = np.full(n, 1e-3)
    maxt = np.full(n, 1e30)
    maxt[1::5] = rng.uniform(0.2, 2.0, len(maxt[1::5]))
    return np.ascontiguousarray(np.concatenate(
        [origins, d, mint[:, None], maxt[:, None]], 1).T.astype(np.float32))


def test_instance_tables_equal_tpuprt(scenes):
    jscene, _, tscene, _ = scenes
    inst = tscene.instances
    assert (inst.count, inst.n_tris, inst.n_entries) == (6, 80, 6)
    assert inst.inst_sign.tolist() == [-1.0] + [1.0] * 5
    assert tscene.triangles.count == 29 * 29 * 2
    t = from_numpy_tables(numpy_tables(jscene), "cpu")
    assert tscene.instances.top_nodes.shape == (1, 16)
    assert_tables_equal(tscene.instances, t.instances, "instances")
    assert_tables_equal(tscene.accel, t.accel, "accel")
    assert torch.equal(tscene.world_bound_lo, t.world_bound_lo)
    assert torch.equal(tscene.world_bound_hi, t.world_bound_hi)


@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_instanced_walk_matches_pallas_interpret(scenes, any_hit):
    jscene, _, tscene, _ = scenes
    rng = np.random.default_rng(4)
    n = 2048
    org = rng.uniform(-1.2, 1.2, (n, 3))
    org[:, 1] = rng.uniform(0.3, 1.5, n)
    rays = rays_at_rocks(tscene.instances, org, n, 5)
    ji = jscene.instances
    jt, jid, jinst = bvh_pallas.traverse_instanced(
        ji.nodes, ji.entry_block, ji.entry_inst, ji.entry_start,
        ji.entry_stop, ji.entry_bbox,
        ji.inst_w2o[:, :3, :].reshape(ji.count, 12), jnp.asarray(rays),
        n_entries=ji.n_entries, n_inst=ji.count, cap=ji.block_cap,
        leaf_k=ji.leaf_k, any_hit=any_hit, interpret=True)
    ti = tscene.instances
    t, ids, inst = bvh_cuda.traverse_instanced_ref(
        ti.nodes, ti.entry_block, ti.entry_inst, ti.entry_start,
        ti.entry_stop, ti.entry_bbox,
        ti.inst_w2o[:, :3, :].reshape(ti.count, 12).contiguous(),
        torch.from_numpy(rays), cap=ti.block_cap, any_hit=any_hit)
    hit = np.asarray(jid) >= 0
    assert hit.sum() > 500 and len(set(np.asarray(jinst)[hit])) == 6
    if any_hit:
        np.testing.assert_array_equal(hit, ids.numpy() >= 0)
        return
    # As test_plain_traversal_matches_pallas_interpret: XLA:CPU contracts
    # multiply-adds in the interpreted kernel, so t may move by a few 1e-6.
    rel = assert_hits_agree(jt, jid, t, ids, t_rtol=1e-5)
    assert np.mean(rel <= 1e-6) >= 0.99
    tie = np.abs(t.numpy() - np.asarray(jt)) <= 1e-6 * np.abs(np.asarray(jt))
    assert np.all((np.asarray(jinst) == inst.numpy()) | (hit & tie))


def kernel_order_walk(ti, rays, any_hit):
    """The instanced kernel's loop as bvh_rows.cu runs it: entry after
    entry in order, each box tested against the window clipped at the best
    so far, each met entry walked within that window. Returns (t, id,
    inst, dict of its work: entry boxes met, node boxes, triangles, rays
    moved to object space)."""
    n = rays.shape[1]
    o, d, mint, maxt = rays[0:3].T, rays[3:6].T, rays[6], rays[7]
    inv = bvh_cuda._safe_inv(d)
    w2o12 = ti.inst_w2o[:, :3, :].reshape(ti.count, 12)
    best_t = torch.full((n,), 1e30)
    best_id = torch.full((n,), -1, dtype=torch.int32)
    best_inst = torch.full((n,), -1, dtype=torch.int32)
    work = dict(entry=0, slab=0, tri=0, xform=0)
    for e in range(ti.n_entries):
        window = torch.minimum(maxt, best_t)
        on = (mint <= maxt) & bvh_cuda._slab_hit(
            ti.entry_bbox[e], o, inv, mint, window * (1.0 + 1e-6))
        if any_hit:
            on &= best_id < 0
        k = on.nonzero()[:, 0]
        m = w2o12[ti.entry_inst[e].long()].expand(len(k), 12)
        c = [[m[:, 4 * i + j] for j in range(4)] for i in range(3)]
        oo = tf.rows_apply_vector(c, o[k]) + torch.stack(
            [c[0][3], c[1][3], c[2][3]], dim=-1)
        od = tf.rows_apply_vector(c, d[k])
        lane = torch.ones(len(k), dtype=torch.int64)
        t, ids, visits, leaves, _ = bvh_cuda._walk_rows(
            ti.nodes, oo, od, mint[k], window[k],
            lane * int(ti.entry_start[e]), lane * int(ti.entry_stop[e]),
            lane * int(ti.entry_block[e]) * ti.block_cap, any_hit)
        better = ids >= 0
        best_t[k] = torch.where(better, t, best_t[k])
        best_id[k] = torch.where(better, ids, best_id[k])
        best_inst[k] = torch.where(better, ti.entry_inst[e], best_inst[k])
        work["entry"] += len(k)
        work["xform"] += len(k)
        work["slab"] += int(visits.sum())
        work["tri"] += 8 * int(leaves.sum())
    return best_t, best_id, best_inst, work


@pytest.mark.parametrize("any_hit", [False, True])
def test_instanced_counts_within_the_kernels_work(scenes, any_hit):
    """traverse_instanced_ref gives the kernel's loop's result, and the
    work it counts for the bound is never more than that loop does: the
    same work for any hit, at most as much for nearest hits."""
    _, _, tscene, _ = scenes
    ti = tscene.instances
    rng = np.random.default_rng(9)
    n = 2048
    org = rng.uniform(-1.2, 1.2, (n, 3))
    org[:, 1] = rng.uniform(0.3, 1.5, n)
    rays = torch.from_numpy(rays_at_rocks(ti, org, n, 10))
    rays[6:8, ::7] = torch.tensor([[1.0], [-1.0]])   # empty windows
    t, ids, inst, counts = bvh_cuda.traverse_instanced_ref(
        ti.nodes, ti.entry_block, ti.entry_inst, ti.entry_start,
        ti.entry_stop, ti.entry_bbox,
        ti.inst_w2o[:, :3, :].reshape(ti.count, 12).contiguous(), rays,
        cap=ti.block_cap, any_hit=any_hit, with_counts=True)
    kt, kid, kinst, work = kernel_order_walk(ti, rays, any_hit)
    assert torch.equal(ids >= 0, kid >= 0) and int((ids >= 0).sum()) > 500
    assert not bool((ids[::7] >= 0).any())
    if not any_hit:
        assert torch.equal(t, kt) and torch.equal(ids, kid)
        assert torch.equal(inst, kinst)
    assert set(counts) == set(work) and counts["tri"] > 0
    for k in work:
        if any_hit:
            assert counts[k] == work[k], k
        else:
            assert 0 < counts[k] <= work[k], k
    assert counts["entry"] < (rays[6] <= rays[7]).sum() * ti.n_entries


def test_intersect_and_hit_geometry_match_per_ray(scenes):
    """Every camera ray of the film, and as many rays from the camera aimed
    at the rocks: intersect_ids, then hit_geometry at the hits."""
    jscene, jopts, tscene, _ = scenes
    lin = np.arange(RES * RES * SPP)
    px = (lin // SPP % RES).astype(np.int32)
    py = (lin // SPP // RES).astype(np.int32)
    cs = jsmp.camera_samples(jopts.sampler, jnp.asarray(px), jnp.asarray(py),
                             jnp.asarray((lin % SPP).astype(np.int32)), 0)
    o, d, mint, maxt, _ = jcam.generate_rays(
        jscene.camera, cs["image_x"], cs["image_y"], cs["lens_u"],
        cs["lens_v"], cs["time"], RES, RES)
    aimed = rays_at_rocks(tscene.instances,
                          np.repeat(np.asarray(o)[:1], len(lin), 0),
                          len(lin), 6)
    o = np.concatenate([np.asarray(o), aimed[0:3].T])
    d = np.concatenate([np.asarray(d), aimed[3:6].T])
    mint = np.concatenate([np.asarray(mint), aimed[6]])
    maxt = np.concatenate([np.asarray(maxt), aimed[7]])
    jt, jid, jhit = jisect.intersect_ids(jscene, *map(jnp.asarray,
                                                      (o, d, mint, maxt)))
    tt, tid, thit = tisect.intersect_ids(
        tscene, *(torch.from_numpy(x) for x in (o, d, mint, maxt)))
    hit = np.asarray(jhit)
    np.testing.assert_array_equal(thit.numpy(), hit)
    n_inst = (np.asarray(jid) >= tscene.triangles.count).sum()
    assert n_inst > 50 and (hit.sum() - n_inst) > 200
    rel = assert_hits_agree(jt, jid, tt, tid, t_rtol=1e-5)
    assert np.mean(rel <= 1e-6) >= 0.99

    jdg = jisect.hit_geometry(jscene, jnp.maximum(jid, 0), jnp.asarray(o),
                              jnp.asarray(d), jt)
    tdg = tisect.hit_geometry(tscene, torch.clamp(tid, min=0),
                              torch.from_numpy(o), torch.from_numpy(d), tt)
    same = hit & (np.asarray(jid) == tid.numpy())
    for k in ("p", "nn", "sn", "dndu", "dndv", "u", "v"):
        np.testing.assert_allclose(tdg[k].numpy()[same],
                                   np.asarray(jdg[k])[same], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(tdg["material"].numpy()[same],
                                  np.asarray(jdg["material"])[same])


def test_render_matches_tpuprt(scenes):
    jscene, jopts, tscene, topts = scenes
    jrgb, jalpha = jax_render.render(jscene, jopts)
    trgb, talpha = torch_render.render(tscene, topts, device="cpu")
    assert trgb.shape == (RES, RES, 3) and np.isfinite(trgb).all()
    np.testing.assert_array_equal(talpha, jalpha)
    close = np.isclose(trgb, jrgb, atol=1e-4, rtol=1e-4).all(-1)
    assert close.mean() >= 0.995, close.mean()


_OBJECT = ('ObjectBegin "thing"\n{body}ObjectEnd\n'
           'AttributeBegin\n  Translate 0 0.2 0\n  ObjectInstance "thing"\n'
           'AttributeEnd\nWorldEnd\n')


_EMITTER = ('AreaLightSource "area" "color L" [4 4 4]\n'
            'Shape "trianglemesh" "integer indices" [0 1 2]\n'
            '  "point P" [0 0 0  1 0 0  0 1 0]\n')
_SPHERE = 'Shape "sphere" "float radius" [0.2]\n'


def test_render_defaults_to_the_card(scenes, monkeypatch):
    """render() without a device asks for the card, and raises where there
    is none instead of carrying on on the CPU."""
    _, _, tscene, topts = scenes
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_render.render(tscene, topts)


def top_children(top, n):
    """Child node ids of interior node n of a skip-link table."""
    skip = top[:, 6].long()
    kids, c = [], n + 1
    while c < int(skip[n]):
        kids.append(c)
        c = int(skip[c])
    return kids


def ordered_walk(ti, rays, order):
    """The instanced kernel's nearest walk in plain torch, visiting the
    entries in `order`: each entry's box against the window clipped at the
    best so far, then its block walked with that best as the limit, and at
    exactly the best t only when the entry is earlier than the best's
    (bvh_rows.cu eq_first). Returns (t, id, inst)."""
    n = rays.shape[1]
    o, d, mint, maxt = rays[0:3].T, rays[3:6].T, rays[6], rays[7]
    inv = bvh_cuda._safe_inv(d)
    w2o12 = ti.inst_w2o[:, :3, :].reshape(ti.count, 12)
    best_t = torch.full((n,), 1e30)
    best_id = torch.full((n,), -1, dtype=torch.int32)
    best_e = torch.full((n,), ti.n_entries, dtype=torch.int64)
    for e in order:
        window = torch.minimum(maxt, best_t)
        on = (mint <= maxt) & bvh_cuda._slab_hit(
            ti.entry_bbox[e], o, inv, mint, window * (1.0 + 1e-6))
        k = on.nonzero()[:, 0]
        eq = (best_id[k] >= 0) & (e < best_e[k])
        limit = torch.where(eq, torch.nextafter(best_t[k], torch.tensor(
            np.inf, dtype=torch.float32)), best_t[k])
        m = w2o12[ti.entry_inst[e].long()].expand(len(k), 12)
        c = [[m[:, 4 * i + j] for j in range(4)] for i in range(3)]
        oo = tf.rows_apply_vector(c, o[k]) + torch.stack(
            [c[0][3], c[1][3], c[2][3]], dim=-1)
        od = tf.rows_apply_vector(c, d[k])
        lane = torch.ones(len(k), dtype=torch.int64)
        t, ids, _, _, _ = bvh_cuda._walk_rows(
            ti.nodes, oo, od, mint[k], torch.minimum(maxt[k], limit),
            lane * int(ti.entry_start[e]), lane * int(ti.entry_stop[e]),
            lane * int(ti.entry_block[e]) * ti.block_cap, False)
        took = ids >= 0
        kk = k[took]
        best_t[kk], best_id[kk], best_e[kk] = t[took], ids[took], e
    hit = best_id >= 0
    inst = torch.where(hit, ti.entry_inst[best_e.clamp(max=ti.n_entries - 1)],
                       -1)
    return best_t, best_id, inst
