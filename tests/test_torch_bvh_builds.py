"""The BVH builder's source, the descent mirror on a deep hand-built tree,
the row walk's stack sizing and the kernels' C bindings; split from
test_torch_bvh.py so no file holds more than ten cases.
"""
import os

import pytest
import torch

from test_torch_bvh import _ROOT, descent_mirror
from tpuprt_torch.accel import bvh_build
from tpuprt_torch.ops import bvh_cuda


def test_builder_source_is_tpuprts():
    """The port builds its BVH from its own copy of tpuprt's native builder,
    line for line in everything but comments, so the trees (and the tables
    compared above) match; it builds its kernels from its own sources too."""
    port = bvh_build.BVH_BUILD8_SRC
    own = os.path.join(_ROOT, "tpuprt_torch")
    for src in (port, bvh_cuda.KERNEL_SRC, bvh_cuda.ROWS_SRC):
        assert os.path.commonpath([src, own]) == own and os.path.isfile(src)

    def code(path):
        with open(path) as f:
            lines = (ln.split("//", 1)[0].rstrip() for ln in f)
            return [ln for ln in lines if ln]

    ref = code(os.path.join(_ROOT, "tpuprt", "native", "csrc",
                            "bvh_build8.cpp"))
    assert len(ref) > 100 and code(port) == ref


@pytest.mark.parametrize("any_hit", [False, True])
def test_descent_mirror_deep_tree(any_hit):
    """On chip_smoke's hand-built 40-level tree the row walk's descent
    needs more stack entries than the kernel keeps in local memory (the
    scratch path, sized by rows_stack_scratch) and still equals
    traverse_rows_ref bit for bit."""
    import chip_smoke
    bvh = chip_smoke.deep_tree(chip_smoke.DEEP_LEVELS, 6)
    rays = torch.from_numpy(chip_smoke.deep_rays(1000, 7))
    t0, id0 = bvh_cuda.traverse_rows_ref(bvh.nodes, rays, nn=bvh.n_nodes,
                                         any_hit=any_hit)
    t1, id1, _, _, deepest = descent_mirror(bvh.nodes, None, rays,
                                            bvh.n_nodes, any_hit, rows=True)
    assert torch.equal(t0, t1) and torch.equal(id0, id1)
    assert int((id0 >= 0).sum()) > 300
    assert bvh_cuda.ROWS_LOCAL_LEVELS < deepest <= bvh.max_depth
    scratch = bvh_cuda.rows_stack_scratch(bvh.max_depth, 4, "cpu")
    assert scratch.shape == (bvh.max_depth - bvh_cuda.ROWS_LOCAL_LEVELS, 4)


def test_rows_stack_scratch_sizing(monkeypatch):
    """The row walk's wrapper keeps ROWS_LOCAL_LEVELS stack levels in the
    kernel's local memory and sizes a scratch tensor, by ray, for a deeper
    tree's other levels (shown with the cap lowered to 3); the kernel's own
    cap (bvh_rows.cu kLocalLevels) is the wrapper's."""
    assert bvh_cuda.rows_stack_scratch(32, 10, "cpu") is None
    monkeypatch.setattr(bvh_cuda, "ROWS_LOCAL_LEVELS", 3)
    assert bvh_cuda.rows_stack_scratch(3, 10, "cpu") is None
    s = bvh_cuda.rows_stack_scratch(40, 10, "cpu")
    assert s.shape == (37, 10) and s.dtype == torch.int32
    with open(bvh_cuda.ROWS_SRC) as f:
        assert "constexpr int kLocalLevels = 32;" in f.read()


def test_bindings_match_the_c_interfaces(monkeypatch):
    """Each wrapper's ctypes argument types are the parameter types of its
    C entry point in the checkout's source, in order (a pointer where the
    source has one, an int where it has an int), so a changed interface
    cannot be called with the old arguments. The library is stood in for
    (no nvcc here): only the binding is held."""
    import ctypes
    import types
    import chip_smoke
    names = ("bvh_tiles_launch", "bvh_rows_launch", "bvh_instanced_launch")
    monkeypatch.setattr(bvh_cuda, "build", lambda src: types.SimpleNamespace(
        **{n: types.SimpleNamespace() for n in names}))
    for src, name, entry in (
            (bvh_cuda.KERNEL_SRC, names[0], bvh_cuda._tiles_entry),
            (bvh_cuda.ROWS_SRC, names[1], bvh_cuda._rows_entry),
            (bvh_cuda.ROWS_SRC, names[2], bvh_cuda._instanced_entry)):
        params = chip_smoke.c_interface(src, name).split(", ")
        assert entry().argtypes == [
            ctypes.c_void_p if p.endswith("*") else ctypes.c_int
            for p in params], name
