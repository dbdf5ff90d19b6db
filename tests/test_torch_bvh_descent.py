"""The BVH's child-id table and the torch mirror of the tile and row walks'
descent (descent_mirror) on test_torch_bvh.py's scenes, and the row walk's
refusal of a tree without its depth; split from test_torch_bvh.py so no
file holds more than ten cases. The module fixture `scenes` is
test_torch_bvh's, built again for this module.
"""
import numpy as np
import pytest
import torch

from test_torch_bvh import (_mirror_sets, descent_mirror, make_rays, scenes,
                            skip_link_children, slot_children)
from tpuprt_torch.accel import bvh_build
from tpuprt_torch.ops import bvh_cuda
from tpuprt_torch.scene.data import BvhAccel
from tpuprt_torch.scene.parser import load_scene_string


@pytest.mark.parametrize("tree", ["config4_big", "tiles_rejected", "deep"])
def test_child_table_is_the_skip_link_children(scenes, monkeypatch, tree):
    """accel/bvh_build.child_table (the table the tile walk descends by)
    holds each node's children by rank as the skip links give them, and
    the interior rows' own child ids (cols 8..15, indexed by the binary
    path, which the row walk descends by) name the same children in the
    same order, so both descents enter them in preorder: on config4_big's
    tree, on the terrain's tree built when build_tiles rejects it, and on
    chip_smoke's hand-built deep tree, whose depth is recorded."""
    import chip_smoke
    if tree == "config4_big":
        bvh = load_scene_string(open(chip_smoke.SCENE).read())[0].accel
        assert bvh.max_depth == 5
    elif tree == "tiles_rejected":
        monkeypatch.setattr(bvh_build, "MAX_TILE_DEPTH", 1)
        bvh = bvh_build.build_bvh(scenes[1].triangles)
        assert bvh.nodesT is None
        assert torch.equal(bvh.child, scenes[1].accel.child)
    else:
        bvh = chip_smoke.deep_tree(chip_smoke.DEEP_LEVELS, 6)
        assert bvh.max_depth == chip_smoke.DEEP_LEVELS
        assert bvh_build.build_tiles(bvh.nodes.numpy(), np.zeros(
            (bvh.n_nodes, 8), np.int32), bvh.n_nodes) is None
    assert bvh.child.dtype == torch.int32
    assert torch.equal(bvh.child, skip_link_children(bvh.nodes, bvh.n_nodes))
    own = slot_children(bvh.nodes, torch.arange(bvh.n_nodes))
    in_order = own.gather(1, (own < 0).int().argsort(dim=1, stable=True))
    assert torch.equal(in_order, bvh.child.long())
    assert int((bvh.child[:, 1] >= 0).sum()) > 5


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("walk", ["tiles", "rows"])
def test_descent_mirror_is_bit_equal(scenes, walk, any_hit):
    """The descent by child ids enters the nodes the skip-link walk enters,
    in the same order, so its t and ids equal traverse_tiles_ref's /
    traverse_rows_ref's bit for bit on the terrain's camera and random
    rays, in both modes; it moves to fewer nodes than the cursor steps
    (the tile walk: exactly the nodes the plain walk enters; the row walk:
    those plus the children whose re-test on entry fails)."""
    _, tscene = scenes
    a = tscene.accel
    for label, rays in _mirror_sets(tscene).items():
        if walk == "tiles":
            t0, id0, c = bvh_cuda.traverse_tiles_ref(
                a.nodesT, a.nodeskip, a.nodemeta, rays, nn=a.n_nodes,
                any_hit=any_hit, with_counts=True)
            t1, id1, steps, entered, _ = descent_mirror(
                a.nodesT, a.child, rays, a.n_nodes, any_hit, rows=False)
            assert int(steps.sum()) == (c["slab"] + c["tri"]) // 8
            cursor = c["steps"]
        else:
            t0, id0, c = bvh_cuda.traverse_rows_ref(
                a.nodes, rays, nn=a.n_nodes, any_hit=any_hit,
                with_counts=True)
            t1, id1, steps, entered, _ = descent_mirror(
                a.nodes, None, rays, a.n_nodes, any_hit, rows=True)
            assert int(entered.sum()) == c["entered"]
            cursor = c["slab"]
        assert torch.equal(t0, t1) and torch.equal(id0, id1), label
        assert int((id0 >= 0).sum()) > 100, label
        assert int(steps.sum()) < cursor / 2, (label, steps.sum(), cursor)


def test_row_walk_needs_the_depth(scenes):
    """traverse_rows sizes the kernel's stack from the tree's recorded depth
    and refuses a BVH without one (BvhAccel.max_depth None); with it, the
    front end on CPU tensors is the plain version's walk."""
    import chip_smoke
    _, tscene = scenes
    a = tscene.accel
    assert BvhAccel().max_depth is None
    rays = torch.from_numpy(make_rays(300, 5))
    with pytest.raises(ValueError, match="max_depth"):
        bvh_cuda.traverse_rows(a.nodes, rays, nn=a.n_nodes, max_depth=None)
    t, ids = bvh_cuda.traverse_rows(a.nodes, rays, nn=a.n_nodes,
                                    max_depth=a.max_depth)
    t0, id0 = bvh_cuda.traverse_rows_ref(a.nodes, rays, nn=a.n_nodes)
    assert torch.equal(t, t0) and torch.equal(ids, id0)
    deep = chip_smoke.deep_tree(chip_smoke.DEEP_LEVELS, 6)
    assert deep.max_depth > bvh_cuda.ROWS_LOCAL_LEVELS
