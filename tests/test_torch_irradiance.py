"""The irradiance cache (config9: SurfaceIntegrator "irradiancecache", the
Cornell box of bench6 with a disk light and a mirror sphere) in the port
held against tpuprt on the CPU at 16x16, a probe every 2nd pixel and 32
estimate samples a probe.

- The probe pass, and the estimate from tpuprt's probes.
- build_point_grid from the same numpy points (the cache's PointGrid).
- Li per camera sample from tpuprt's cache, carried across by the bridge.
"""
import numpy as np
import pytest
import torch

from test_torch_bvh import numpy_tables
from test_torch_gi import (RES, both, camera_chunk, per_sample_close,
                           port_li, tpuprt_chunk)
from tpuprt.accel import photon_grid as jgrid
from tpuprt.integrators import irradiancecache as jic
from tpuprt_torch.accel import photon_grid as tgrid
from tpuprt_torch.integrators import irradiancecache as tic
from tpuprt_torch.scene.bridge import point_grid_from_numpy

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cache9():
    """config9 at 16x16 with a probe every 2nd pixel: tpuprt's cache, the
    numpy columns its build_cache handed to build_point_grid (probes,
    normals, E, maxDist, cell), and its render_chunk from that cache."""
    jscene, jopts, tscene, topts = both("config9")
    jopts = jopts._replace(irrad=jopts.irrad._replace(probe_stride=2))
    topts = topts._replace(irrad=topts.irrad._replace(probe_stride=2))
    built = []
    real = jic.build_point_grid

    def spy(p, payload, radius, *a):
        built.append((np.array(p),) + tuple(np.array(x) for x in payload) +
                     (radius,))
        return real(p, payload, radius, *a)
    jic.build_point_grid = spy
    try:
        cache = jic.build_cache(jscene, jopts.irrad, RES, RES, 0)
    finally:
        jic.build_point_grid = real
    return (jscene, jopts, tscene, topts, cache, built[0],
            tpuprt_chunk(jscene, jopts, cache))


def test_probe_pass_matches_tpuprt(cache9):
    """The probes (hit points on a diffuse or glossy surface, first hits and
    the mirror's reflections): the same probes (masks equal), points and
    normals within 1e-6 (XLA contracts multiply-adds, o + t d among them,
    on some components: a few ulps)."""
    _, _, tscene, topts, _, (jp, jn, *_), _ = cache9
    pts, nrms, valid = tic.probe_points(tscene, topts.irrad, RES, RES, 0)
    # 64 probe pixels: the mirror's are no probes, their reflections are.
    assert valid.shape == (2 * 64,)
    assert 0 < int(valid[64:].sum()) <= 64 - int(valid[:64].sum())
    np.testing.assert_allclose(pts[valid].numpy(), jp, rtol=0, atol=1e-6)
    np.testing.assert_allclose(nrms[valid].numpy(), jn, rtol=0, atol=1e-6)


def test_irradiance_estimate_matches_tpuprt(cache9):
    """E and maxDist (clamped, times maxerror) at tpuprt's probes within
    1e-4 relative; the cell size equal."""
    _, _, tscene, topts, _, (jp, jn, jE, jmd, jcell), _ = cache9
    E, max_dist = tic.estimate_irradiance(tscene, topts.irrad,
                                          torch.from_numpy(jp),
                                          torch.from_numpy(jn), 0)
    assert jE.max() > 0.05
    np.testing.assert_allclose(E.numpy(), jE, rtol=1e-4, atol=1e-6)
    vol = float(np.abs(np.prod(tscene.world_bound_hi.numpy() -
                               tscene.world_bound_lo.numpy()))) ** (1 / 3)
    md = np.clip(max_dist.numpy(), 0.001 * vol, 0.125 * vol) * \
        topts.irrad.maxerror
    np.testing.assert_allclose(md, jmd, rtol=1e-4)
    assert float(max(md.max(), 1e-4)) == pytest.approx(jcell, rel=1e-4)


def test_irradiance_li_matches_tpuprt(cache9):
    jscene, jopts, tscene, topts, cache, _, (_, _, jout) = cache9
    tout = port_li(lambda *a, **k: tic.li(tscene, *a, **k),
                   point_grid_from_numpy(numpy_tables(cache), "cpu"),
                   camera_chunk(jscene, jopts), topts.irrad, jopts)
    assert jout[0].max() > 1.0
    per_sample_close(jout, tout)



def test_build_point_grid_matches_tpuprt():
    """From the same numpy points and payload (a crowded cell, a bucket over
    the lookup's cap): equal tables."""
    rng = np.random.default_rng(8)
    p = rng.uniform(-1, 1, (2000, 3)).astype(np.float32)
    p[:150] = rng.normal(0.325, 0.002, (150, 3))
    pay = (rng.normal(size=(2000, 3)).astype(np.float32),
           rng.uniform(0, 1, 2000).astype(np.float32))
    j = jgrid.build_point_grid(p, pay, 0.05)
    t = tgrid.build_point_grid(p, pay, 0.05)
    assert t.bucket_cap == j.bucket_cap == 64
    assert (t.n_buckets, t.radius, t.count) == (j.n_buckets, j.radius,
                                               j.count)
    np.testing.assert_array_equal(t.start.numpy(), np.asarray(j.start))
    np.testing.assert_array_equal(t.p.numpy(), np.asarray(j.p))
    for a, b in zip(t.payload, j.payload):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    bridged = point_grid_from_numpy(numpy_tables(j), "cpu")
    np.testing.assert_array_equal(bridged.p.numpy(), t.p.numpy())
