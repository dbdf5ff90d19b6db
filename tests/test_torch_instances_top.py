"""ObjectInstance's routes and the instance table's top-level BVH: an
emitter, a quadric and an area light on a cone in an object load as
tpuprt's tables; the top-level BVH holds every
entry once, and a walk in another order keeps the earliest entry; split
from test_torch_instances.py so no file holds more than ten cases.
"""
import numpy as np
import pytest
import torch

from chip_smoke import rocks_scene_text
from test_torch_bvh import assert_tables_equal, numpy_tables
from test_torch_instances import (_EMITTER, _OBJECT, _SPHERE, ordered_walk,
                                  rays_at_rocks, rocks_text, top_children)
from tpuprt.scene.parser import load_scene_string as jax_load
from tpuprt_torch.accel import instances as inst_mod
from tpuprt_torch.ops import bvh_cuda
from tpuprt_torch.scene.bridge import from_numpy_tables
from tpuprt_torch.scene.parser import load_scene_string


# An emitter, a quadric and an area light on a cone inside an object were
# refused before the port covered them; the cases keep their ids and now
# check the loaded tables.
@pytest.mark.parametrize("body, message", [
    pytest.param(_EMITTER, None, id=_EMITTER +
                 "-instanced area emitters are not ported"),
    pytest.param(_SPHERE, None, id=_SPHERE + "-quadric"),
    pytest.param('AreaLightSource "area"\nShape "cone"\n', None,
                 id='AreaLightSource "area"\nShape "cone"\n'
                 '-area lights on shape'),
])
def test_uncovered_objects_raise(body, message):
    """What an object may hold that the port does not render raises at
    its ObjectInstance; an emissive mesh (instanced, its own light), a
    quadric (folded into the quadric table) and an area light on a cone
    (a cone that emits nothing, as tpuprt's) load into tpuprt's
    tables."""
    text = rocks_text().replace("WorldEnd", _OBJECT.format(body=body))
    if message is not None:
        with pytest.raises(NotImplementedError, match=message):
            load_scene_string(text)
        return
    tscene, _ = load_scene_string(text)
    assert_tables_equal(tscene, from_numpy_tables(
        numpy_tables(jax_load(text)[0]), "cpu"))


@pytest.mark.parametrize("n_boxes", [6, 500])
def test_top_level_bvh_holds_every_entry_once(n_boxes):
    """build_top's table: every entry in exactly one leaf slot, each node's
    box containing its children's and its entries' boxes."""
    rng = np.random.default_rng(n_boxes)
    lo = rng.uniform(-1, 1, (n_boxes, 3)).astype(np.float32)
    box = np.concatenate([lo, lo + rng.uniform(0, 0.1, (n_boxes, 3)),
                          np.zeros((n_boxes, 2))], 1).astype(np.float32)
    top = torch.from_numpy(inst_mod.build_top(box))
    assert top.shape[1] == inst_mod.TOP_COLS
    nprims = top[:, 7].long()
    seen = torch.cat([top[n, 8:8 + int(nprims[n])] for n in
                      range(top.shape[0]) if nprims[n] > 0]).long()
    assert sorted(seen.tolist()) == list(range(n_boxes))
    assert bool((top[nprims == 0, 8:] == -1).all())
    b = torch.from_numpy(box)
    for n in range(top.shape[0]):
        inner = b[top[n, 8:8 + int(nprims[n])].long()] if nprims[n] > 0 \
            else top[top_children(top, n)]
        assert len(inner) > 0
        assert bool((top[n, 0:3] <= inner[:, 0:3]).all())
        assert bool((top[n, 3:6] >= inner[:, 3:6]).all())
    if n_boxes > 8:
        assert top.shape[0] > 1 and int(top[0, 6]) == top.shape[0]


@pytest.mark.parametrize("order", ["top-level", "reversed"])
def test_out_of_order_walk_keeps_the_earliest_entry(order):
    """Rocks with every other instance repeated under the same transform
    (exact ties between entries): visiting the entries in the top-level
    BVH's leaf order, or backwards, with the kernel's tie rule gives the
    plain version's t, ids and instances on every ray; the front end's call
    gives them too."""
    text = rocks_scene_text(rocks_text().split("ObjectBegin")[0] +
                            "WorldEnd\n", 6, 1, 0, dup_every=2)
    scene, _ = load_scene_string(text)
    ti = scene.instances
    assert (ti.count, ti.n_entries) == (9, 9)
    rng = np.random.default_rng(11)
    n = 2048
    org = rng.uniform(-1.2, 1.2, (n, 3))
    org[:, 1] = rng.uniform(0.3, 1.5, n)
    rays = torch.from_numpy(rays_at_rocks(ti, org, n, 12))
    w2o12 = ti.inst_w2o[:, :3, :].reshape(ti.count, 12).contiguous()
    want = bvh_cuda.traverse_instanced_ref(
        ti.nodes, ti.entry_block, ti.entry_inst, ti.entry_start,
        ti.entry_stop, ti.entry_bbox, w2o12, rays, cap=ti.block_cap)
    hit = want[1] >= 0
    # The repeats (entries 6-8) never win: their originals (0, 2, 4) tie.
    assert int(hit.sum()) > 500 and set(want[2][hit].tolist()) <= \
        {0, 1, 2, 3, 4, 5}
    top = ti.top_nodes
    leaves = [int(e) for row in top for e in row[8:8 + int(row[7])]]
    assert sorted(leaves) == list(range(9))
    got = ordered_walk(ti, rays, leaves if order == "top-level" else
                       list(range(9))[::-1])
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    o, d, mint, maxt = rays[0:3].T, rays[3:6].T, rays[6], rays[7]
    t, code, h = inst_mod.intersect(ti, o, d, mint, maxt)
    assert torch.equal(h, hit)
    assert torch.equal(code[h], (want[2] * ti.n_tris + want[1])[hit])
    assert torch.equal(t[h], want[0][hit])
