"""mt_best's staged tests in their plain mirror (ops/mt_cuda.settle_stage):
the any-hit mask against the nearest hit, the stage counts, the exact sign
test and rejects that never drop a hit; split from test_torch_mt.py so no
file holds more than ten cases.
"""
import numpy as np
import pytest
import torch

from test_torch_mt import _sets
from tpuprt_torch.ops import mt_cuda
from tpuprt_torch.shapes import triangle as ttri


@pytest.mark.parametrize("name", ["random", "duplicates", "adversarial"])
def test_any_hit_mask_equals_nearest(name):
    """Any hit gives the nearest pass's hit mask, at each ray's first valid
    triangle (its t and id); the front end keeps the mask."""
    tris, rays = _sets()[name]
    t, ids = mt_cuda.mt_best_ref(rays, tris)
    ta, ia = mt_cuda.mt_best_ref(rays, tris, any_hit=True)
    assert torch.equal(ids >= 0, ia >= 0) and int((ids >= 0).sum()) > 100
    tt, _, _, valid = ttri.intersect_edges(
        tris[0:3].T[None], tris[3:6].T[None], tris[6:9].T[None],
        rays[0:3].T[:, None], rays[3:6].T[:, None], rays[6][:, None],
        rays[7][:, None])
    valid &= tt < 1e30
    first = valid.to(torch.uint8).argmax(dim=1)
    hit = ia >= 0
    assert torch.equal(ia[hit].long(), first[hit])
    assert torch.equal(ta[hit], tt[hit, first[hit]])
    assert bool((ia[hit] <= ids[hit]).all())
    o, d, mint, maxt = rays[0:3].T, rays[3:6].T, rays[6], rays[7]
    box = (o.amin(dim=0), o.amax(dim=0))
    near = mt_cuda.intersect_packed(tris, box, o, d, mint, maxt)
    anyh = mt_cuda.intersect_packed(tris, box, o, d, mint, maxt,
                                    any_hit=True)
    assert torch.equal(near[2], anyh[2]) and torch.equal(near[2], ids >= 0)
    assert torch.equal(near[1], ids) and torch.equal(anyh[1], ia)
    # Any-hit rays go to the kernel sorted; in lane order the same results.
    order = mt_cuda.ray_order(box, o, d, mint, maxt)
    assert not torch.equal(order, torch.arange(len(order)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mt_cuda, "ray_order",
                   lambda box, o, *a: torch.arange(len(o)))
        lane = mt_cuda.intersect_packed(tris, box, o, d, mint, maxt,
                                        any_hit=True)
    assert all(torch.equal(a, b) for a, b in zip(anyh, lane))


@pytest.mark.parametrize("any_hit", [False, True])
def test_stage_counts(any_hit):
    """with_counts' stages add up to the pairs the rays need: every
    triangle of a live ray, or in any-hit mode those up to its first hit;
    each stage as settle_stage gives it."""
    tris, rays = _sets()["adversarial"]
    _, ids, counts = mt_cuda.mt_best_ref(rays, tris, any_hit=any_hit,
                                         with_counts=True)
    n_tris = tris.shape[1]
    live = rays[6] <= rays[7]
    last = torch.where(ids >= 0, ids.long(), n_tris - 1) if any_hit else \
        torch.full_like(ids, n_tris - 1).long()
    need = live[:, None] & (torch.arange(n_tris)[None] <= last[:, None])
    st = mt_cuda.settle_stage(
        tris[0:3].T[None], tris[3:6].T[None], tris[6:9].T[None],
        rays[0:3].T[:, None], rays[3:6].T[:, None], rays[6][:, None])
    want = torch.bincount(st[need], minlength=4).tolist()
    assert [counts[k] for k in mt_cuda.STAGES] == want
    assert counts["tri"] == int(need.sum())
    if any_hit:
        assert counts["tri"] < int(live.sum()) * n_tris
    else:
        assert counts["tri"] == int(live.sum()) * n_tris


def test_sign_test_is_exact():
    """neg_settled only settles a product that rounds negative: numerators
    of +-0, subnormals, the guards' edges, FLT_MAX and infinities against
    divisors just above 1e-12, at the guard limit and beyond, and
    infinite."""
    f32 = np.float32
    num = [0.0, 1e-45, 1e-40, 1e-38, 1e-30, 1e-25, 1e-21, 1e-20, 2e-20,
           1e-12, 1.0, 1e20, 1e30, float(np.finfo(f32).max), np.inf,
           np.nan]
    num += [float(np.nextafter(f32(1e-20), f32(0))),
            float(np.nextafter(f32(1e-20), f32(1)))]
    div = [1e-12, 1.0000001e-12, 1e-6, 1.0, 1e12, 1e19, 1e20, 1e25, 1e30,
           3.4e38, np.inf]
    div += [float(np.nextafter(f32(1e-12), f32(1))),
            float(np.nextafter(f32(1e20), f32(0))),
            float(np.nextafter(f32(1e20), f32(1e30)))]
    n = torch.tensor([s * v for v in num for s in (1.0, -1.0)],
                     dtype=torch.float32)
    dv = torch.tensor([s * v for v in div for s in (1.0, -1.0)],
                      dtype=torch.float32)
    n, dv = n[:, None].expand(-1, len(dv)), dv[None].expand(len(n), -1)
    ok = torch.abs(dv) > 1e-12
    prod = n * (1.0 / torch.where(ok, dv, 1.0))
    settled = mt_cuda.neg_settled(n, dv) & ok
    assert bool((prod[settled] < 0).all())
    # The guards leave most opposite-sign pairs settled.
    assert int(settled.sum()) > 100
    # Without the guards a product rounds to -0, which b >= 0 accepts:
    # a tiny numerator, or FLT_MAX against an infinite divisor (inv = 0).
    for a, b in ((1e-30, -1e30), (-float(np.finfo(f32).max), np.inf)):
        a, b = torch.tensor([a]), torch.tensor([b])
        assert float(a * (1.0 / b)) == 0.0
        assert not bool(mt_cuda.neg_settled(a, b))


@pytest.mark.parametrize("name", ["random", "duplicates", "adversarial"])
def test_staged_rejects_never_drop_a_hit(name):
    """Every pair the kernel settles before the full test (settle_stage <
    3) is one the full rule rejects."""
    tris, rays = _sets()[name]
    args = (tris[0:3].T[None], tris[3:6].T[None], tris[6:9].T[None],
            rays[0:3].T[:, None], rays[3:6].T[:, None], rays[6][:, None])
    st = mt_cuda.settle_stage(*args)
    _, _, _, valid = ttri.intersect_edges(*args, rays[7][:, None])
    assert int(valid.sum()) > 100
    assert not bool((valid & (st < 3)).any())
    assert int((st < 3).sum()) > st.numel() // 2
