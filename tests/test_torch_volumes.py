"""The port's volumes held against tpuprt on the CPU: the regions' queries,
the optical depth and transmittance, the phase functions, the
emission-only march, the parsed table, test_volumes.py's properties and
the pool against the scan.

tpuprt's volume code runs eagerly here, never jitted: a jit of its volume
pool or march compiles for minutes on the CPU. Next-event estimation
through a medium is in test_torch_volumes_nee.py, the chunked driver's
composition in test_torch_volumes_driver.py, the single-scattering march in
test_torch_volumes_single.py, the GI preprocesses' attenuation in
test_torch_volumes_gi.py: each file keeps within a worker's budget.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from test_torch_bvh import assert_tables_equal, numpy_tables
from tpuprt.core import mc as jmc
from tpuprt.integrators import volume as jvi
from tpuprt.scene.parser import load_scene_string as jax_load
from tpuprt.volumes import regions as jvr
from tpuprt_torch import render as torch_render
from tpuprt_torch.core import mc as tmc
from tpuprt_torch.integrators import volume as tvi
from tpuprt_torch.scene.bridge import from_numpy_tables
from tpuprt_torch.scene.build import SceneBuilder
from tpuprt_torch.scene.parser import load_scene_string
from tpuprt_torch.volumes import regions as tvr

torch.set_num_threads(1)

# Per-lane tolerance: the marches sum 32 exp-weighted steps, in XLA's
# order there and torch's here.
RTOL = 1e-5
ATOL = 1e-6

# test_wavefront.VOLUME_BOX at a test size: a homogeneous box around a
# matte sphere and a point light.
VOLUME_BOX = """
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Camera "perspective" "float fov" [55]
Sampler "lowdiscrepancy" "integer pixelsamples" [2]
SurfaceIntegrator "path" "integer maxdepth" [3]
VolumeIntegrator "emission"
WorldBegin
LightSource "point" "color I" [14 14 14] "point from" [0 1.6 2]
Volume "homogeneous" "color sigma_a" [0.12 0.1 0.08]
  "color sigma_s" [0.25 0.25 0.3] "color Le" [0.01 0.01 0.012]
  "point p0" [-2 -2 1] "point p1" [2 2 5]
Material "matte" "color Kd" [0.7 0.6 0.5]
Translate 0 0 3
Shape "sphere" "float radius" [0.8]
WorldEnd
"""

# Three overlapping regions, one of each kind; the grid is rotated and
# moved, with a seeded density.
_GRID = " ".join(f"{x:.4f}" for x in
                 np.random.default_rng(1).uniform(0, 2, 24))
REGIONS = f"""
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Camera "perspective" "float fov" [55]
VolumeIntegrator "single"
WorldBegin
LightSource "point" "color I" [14 14 14] "point from" [0 1.6 2]
AttributeBegin
AreaLightSource "area" "color L" [3 3 3]
Translate -1.2 1.2 3.5
Shape "sphere" "float radius" [0.3]
AttributeEnd
Volume "homogeneous" "color sigma_a" [0.12 0.1 0.08]
  "color sigma_s" [0.25 0.25 0.3] "color Le" [0.01 0.01 0.012]
  "point p0" [-2 -2 1] "point p1" [2 2 5] "float g" [0.3]
Volume "exponential" "color sigma_a" [0.2 0.1 0.1]
  "color sigma_s" [0.2 0.3 0.1] "point p0" [-1 -1 0] "point p1" [1 1 4]
  "float a" [1.5] "float b" [2] "vector updir" [0 1 0.2] "float g" [-0.4]
AttributeBegin
Translate 0.5 0 2
Rotate 30 0 1 0
Volume "volumegrid" "integer nx" [3] "integer ny" [2] "integer nz" [4]
  "float density" [{_GRID}] "color sigma_s" [0.5 0.5 0.5]
  "color sigma_a" [0.1 0.1 0.1] "color Le" [0.2 0.1 0.0]
  "point p0" [-1 -1 -1] "point p1" [1 1 1] "float g" [0.5]
AttributeEnd
Material "matte" "color Kd" [0.7 0.6 0.5]
Translate 0 0 3
Shape "sphere" "float radius" [0.8]
WorldEnd
"""


@pytest.fixture(scope="module")
def regions():
    return jax_load(REGIONS)[0], load_scene_string(REGIONS)[0]


def lanes(n=64, seed=0):
    """Rays through the regions from outside and inside, windows of all
    lengths, jitters and points on them, as numpy."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    o[:, 2] = rng.uniform(-1, 3, n)
    tgt = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    tgt[:, 2] = rng.uniform(1, 5, n)
    d = (tgt - o) / np.linalg.norm(tgt - o, axis=1, keepdims=True)
    maxt = rng.uniform(0.5, 12, n).astype(np.float32)
    maxt[::5] = 1e30
    return dict(o=o, d=d.astype(np.float32), mint=np.zeros(n, np.float32),
                maxt=maxt, u=rng.uniform(0, 1, n).astype(np.float32),
                p=(o + d * rng.uniform(0, 6, (n, 1))).astype(np.float32))


def close(j, t, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol,
                               atol=atol)


def test_density_and_coefficients_match_tpuprt(regions):
    """density for the three kinds (two regions overlapping at most
    points, the grid's trilinear clamp at its faces), then sigma_a,
    sigma_s, sigma_t, Lve and the mean g per lane, to an ulp or two of
    the exponential's exp."""
    js, ts = regions
    x = lanes()
    # Points on the grid's faces and corners too.
    grid_pts = (ts.volumes.v2w[2].numpy() @ np.array(
        [[0, 0, 0, 1], [1, 1, 1, 1], [0.5, 0, 1, 1], [1, 0.5, 0, 1]],
        np.float32).T).T[:, :3]
    p = np.concatenate([x["p"], grid_pts.astype(np.float32)])
    d_j = np.asarray(jvr.density(js.volumes, jnp.asarray(p)))
    assert (d_j > 0).sum(1).max() >= 2 and (d_j[:, 2] > 0).any()
    for fn in ("density", "sigma_a", "sigma_s", "sigma_t", "lve", "mean_g"):
        close(getattr(jvr, fn)(js.volumes, jnp.asarray(p)),
              getattr(tvr, fn)(ts.volumes, torch.from_numpy(p)), 3e-7, 0)


def test_tau_and_transmittance_match_tpuprt(regions):
    js, ts = regions
    x = lanes()
    args = [x[k] for k in ("o", "d", "mint", "maxt", "u")]
    for fn in ("tau", "transmittance"):
        j = getattr(jvr, fn)(js.volumes, *map(jnp.asarray, args))
        t = getattr(tvr, fn)(ts.volumes, *map(torch.from_numpy, args))
        close(j, t)
    assert (t.numpy() < 0.99).any() and (t.numpy() == 1.0).any()


def test_li_emission_matches_tpuprt(regions):
    js, ts = regions
    x = lanes(seed=1)
    args = [x[k] for k in ("o", "d", "mint", "maxt", "u")]
    j = jvi.li_emission(js, *map(jnp.asarray, args))
    t = tvi.li_emission(ts, *map(torch.from_numpy, args))
    close(j, t)
    assert (t.numpy() > 0).any()


def test_phase_functions_match_tpuprt():
    c = np.linspace(-1, 1, 257).astype(np.float32)
    g = np.random.default_rng(2).uniform(-0.9, 0.9, c.shape).astype(
        np.float32)
    for name in ("phase_isotropic", "phase_rayleigh", "phase_mie_hazy",
                 "phase_mie_murky"):
        close(getattr(jmc, name)(jnp.asarray(c)),
              getattr(tmc, name)(torch.from_numpy(c)), 1e-6, 0)
    for name in ("phase_schlick", "hg_pdf"):
        close(getattr(jmc, name)(jnp.asarray(c), jnp.asarray(g)),
              getattr(tmc, name)(torch.from_numpy(c), torch.from_numpy(g)),
              1e-6, 0)
    # Each integrates to 1 over the sphere (test_volumes' check).
    u = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, 200000).astype(np.float32))
    for fn in (tmc.phase_isotropic, tmc.phase_rayleigh, tmc.phase_mie_hazy,
               lambda c: tmc.phase_schlick(c, 0.4),
               lambda c: tmc.hg_pdf(c, torch.tensor(-0.6))):
        assert abs(float(fn(u).mean()) * 4 * np.pi - 1.0) < 2e-2


def test_volume_table_matches_tpuprt_through_bridge(regions):
    """The parsed VolumeTable (the grid packed in one column) equals
    tpuprt's carried across, as does the whole scene; the world bound
    covers the regions and the options read VolumeIntegrator."""
    js, ts = regions
    bridged = from_numpy_tables(numpy_tables(js), "cpu")
    assert_tables_equal(ts, bridged)
    assert ts.volumes.count == 3 and ts.volumes.grids == ((2, 0, 4, 2, 3),)
    assert load_scene_string(REGIONS)[1].volume_integrator == "single"
    assert load_scene_string(VOLUME_BOX)[1].volume_integrator == "emission"


def _box(kind="homogeneous", **kw):
    """A scene holding one region over [p0, p1] and a light and a sphere
    far from it (the builder asks for both)."""
    b = SceneBuilder()
    b.matte()
    b.add_point_light(np.eye(4, dtype=np.float32))
    b.add_sphere(np.asarray([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 50],
                             [0, 0, 0, 1]], np.float32), 0.1)
    b.add_volume(kind, np.eye(4), **kw)
    return b.build()


def test_volume_properties():
    """test_volumes.py's properties, on the port: the analytic
    transmittance and emission across a homogeneous box, no attenuation
    beside it, the exponential falloff, the grid's trilinear rise."""
    t = lambda *r: torch.tensor(np.asarray(r, np.float32))
    sc = _box(p0=(-1, -1, -1), p1=(1, 1, 1), sigma_a=(0.5,) * 3,
              sigma_s=(0.0,) * 3)
    o, d, mint, maxt, u = t([-5.0, 0, 0]), t([1.0, 0, 0]), t(0.0), \
        t(100.0), t(0.5)
    tr = tvr.transmittance(sc.volumes, o, d, mint, maxt, u)
    assert np.allclose(tr.numpy(), np.exp(-1.0), rtol=0.05)
    tr = tvr.transmittance(sc.volumes, t([-5.0, 3.0, 0]), d, mint, maxt, u)
    assert np.allclose(tr.numpy(), 1.0)
    sc = _box(p0=(-1, -1, -1), p1=(1, 1, 1), sigma_a=(0.1,) * 3,
              sigma_s=(0.0,) * 3, le=(1.0, 2.0, 3.0))
    L = tvi.li_emission(sc, o, d, mint, maxt, u)
    assert np.allclose(L.numpy()[0], np.array([1.0, 2.0, 3.0]) *
                       (1 - np.exp(-0.2)) / 0.1, rtol=0.06)
    sc = _box("exponential", p0=(-1, -1, -1), p1=(1, 1, 1),
              sigma_a=(1.0,) * 3, a=2.0, b=3.0, updir=(0, 1, 0))
    dens = tvr.density(sc.volumes, t([0, -1.0, 0], [0, 0, 0],
                                     [0, 0.99, 0])).numpy()[:, 0]
    assert np.allclose(dens[:2], [2.0, 2.0 * np.exp(-3.0)], rtol=1e-3)
    assert dens[2] < dens[1] < dens[0]
    g = np.zeros((2, 2, 2), np.float32)
    g[:, :, 1] = 1.0
    sc = _box("volumegrid", p0=(0, 0, 0), p1=(1, 1, 1), sigma_a=(1.0,) * 3,
              density=g.ravel(), density_shape=(2, 2, 2))
    dens = tvr.density(sc.volumes, t([0.25, 0.5, 0.5],
                                     [0.75, 0.5, 0.5])).numpy()[:, 0]
    assert dens[1] > dens[0]


def test_pool_equals_scan_per_sample():
    """VOLUME_BOX at 16x16 through the port's pool and its scan driver, in
    path mode (every segment attenuated) and directlighting (the camera
    segment), for emission and single scattering: the same samples, so
    the same image."""
    for vi in ("emission", "single"):
        for integ in ("path", "directlighting"):
            text = VOLUME_BOX.replace('"emission"', f'"{vi}"').replace(
                '"path"', f'"{integ}"')
            scene, opts = load_scene_string(text)
            opts = opts._replace(filter_kind="box", filter_xwidth=0.5,
                                 filter_ywidth=0.5, chunk_size=200)
            pool = torch_render.render(scene, opts._replace(
                driver="wavefront"), device="cpu")
            scan = torch_render.render(scene, opts._replace(driver="scan"),
                                       device="cpu")
            for a, b in zip(pool, scan):
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
            assert pool[0].mean() > 0.01
