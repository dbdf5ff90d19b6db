"""Extended photon mapping in the port held against tpuprt on the CPU:
config7 (the Cornell box with a disk light and a mirror sphere;
SurfaceIntegrator "exphotonmap", final gather) at 16x16, with maxdist 0.3
in place of the file's 0.25 (below).

- build_maps with the radiance photons (shoot_batch's candidates picked
  with probability 1/8), small targets: the same maps and radiance
  photons; the plain shooting unchanged.
- The radiance photons' Lo from tpuprt's maps and photons.
- The lookups at random points from tpuprt's state: the kernel estimate
  (lphoton_kernel), the photon-cone pdf, the reservoir draw (one pass
  against tpuprt's loop) and the nearest radiance photon.
- Li per camera sample with tpuprt's ExPhotonAux carried across (the
  final gather of 2 samples); the driver's whole image.

At the file's maxdist of 0.25 the walls (at +-1) lie on cell boundaries
of the photon maps (4 cells) and of the radiance grid (radius 1): a hit
point's last bit picks its cell. The reservoir draw numbers a query's
candidates by their cell relative to the query's, so a point one ulp to
the other side draws another photon, in tpuprt as in the port
(test_reservoir_draw_at_a_cell_boundary). XLA contracts o + t d into a
multiply-add for some components and not others, so the two packages'
hit points differ in their last bit on about a fifth of the wall hits,
and at 0.25 a fifth of the samples draw other gather directions. With
maxdist 0.3 no wall lies on a boundary, and the samples agree.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from test_torch_bvh import numpy_tables
from test_torch_gi import (RES, both, camera_chunk, image_close,
                           per_sample_close, port_li, tpuprt_chunk)
from test_torch_path import unit
from test_torch_photonmap import _recorded_build
from tpuprt.bsdf import bsdf as jB
from tpuprt.core import rng as jrng
from tpuprt.integrators import exphotonmap as jex
from tpuprt.integrators import photonmap as jpm
from tpuprt.materials import factory as jF
from tpuprt_torch import render as torch_render
from tpuprt_torch.bsdf import bsdf as tB
from tpuprt_torch.integrators import exphotonmap as tex
from tpuprt_torch.integrators import photonmap as tpm
from tpuprt_torch.materials import factory as tF
from tpuprt_torch.scene.bridge import (exphoton_aux_from_numpy,
                                       photon_maps_from_numpy)

torch.set_num_threads(1)
N = 2048
# build_aux at a test size (exphotonmap's batches are 16384 paths).
SMALL = dict(caustic=500, direct=4000, indirect=4000, batch=4096,
             max_shot=32768, gather_samples=2, max_dist=0.3)


@pytest.fixture(scope="module")
def config7():
    """config7 at 16x16 x 2 spp with SMALL: tpuprt's ExPhotonAux, the
    radiance photons its build_maps returned with the photons and n_paths
    of each map (recorded at build_photon_grid), and its render_chunk."""
    jscene, jopts, tscene, topts = both("config7")
    jopts = jopts._replace(photon=jopts.photon._replace(**SMALL))
    topts = topts._replace(photon=topts.photon._replace(**SMALL))
    rads = []
    real = jex.build_maps

    def spy(*a, **k):
        out = real(*a, **k)
        rads.append(out[1])
        return out
    jex.build_maps = spy
    try:
        aux, built = _recorded_build(jpm, lambda: jex.build_aux(
            jscene, jopts.photon, 0))
    finally:
        jex.build_maps = real
    return (jscene, jopts, tscene, topts, aux, (rads[0], built),
            tpuprt_chunk(jscene, jopts, aux))


def test_build_maps_radiance_photons_match_tpuprt(config7):
    """The maps keep the same photons and n_paths; the radiance photons
    (every picked deposit of every batch, in path order) are the same; the
    shooting without them returns its five tensors as before."""
    _, _, tscene, topts, aux, (jrad, jbuilt), _ = config7
    prm = tpm.PhotonParams(**{k: getattr(topts.photon, k) for k in (
        "caustic", "direct", "indirect", "max_dist", "shoot_depth", "batch",
        "max_shot")})
    (maps, rad), built = _recorded_build(tpm, lambda: tpm.build_maps(
        tscene, prm, 0, collect_radiance=True))
    for (jp, _, jn), (tp, _, tn) in zip(jbuilt, built):
        assert (len(tp), tn) == (len(jp), jn)
    assert len(rad["p"]) == len(jrad["p"]) > 1000
    for k in ("p", "n", "rho_r", "rho_t"):
        np.testing.assert_allclose(rad[k], jrad[k], atol=1e-3, err_msg=k)
    assert tpm.build_maps(tscene, prm, 0).direct.count == maps.direct.count
    plain = tpm.shoot_batch(tscene, 0, N, 8, 0)
    full = tpm.shoot_batch(tscene, 0, N, 8, 0, radiance=True)
    assert (len(plain), len(full)) == (5, 9)
    for a, b in zip(plain, full):
        assert torch.equal(a, b)
    picked = full[4] & full[8]
    assert 0.08 < float(picked.sum() / full[4].sum()) < 0.17


def test_radiance_lo_matches_tpuprt(config7):
    """Lo at tpuprt's radiance photons from tpuprt's maps, within 1e-4
    relative, and build_aux's grid of them equal to tpuprt's."""
    _, _, _, _, aux, (jrad, _), _ = config7
    maps = photon_maps_from_numpy(numpy_tables(aux.maps), "cpu")
    Lo = tex.radiance_lo(maps, *(torch.from_numpy(jrad[k]) for k in (
        "p", "n", "rho_r", "rho_t"))).numpy()
    grid = aux.radiance
    order = np.argsort(np.asarray(jex.build_point_grid(
        jrad["p"], (np.arange(len(jrad["p"]), dtype=np.float32),),
        grid.radius).payload[0]).astype(np.int64))
    jLo = np.asarray(grid.payload[1])[order]
    assert (jLo.max(-1) > 0).mean() > 0.9
    np.testing.assert_allclose(Lo, jLo, rtol=1e-4, atol=1e-6)


def _random_points(tscene, rng, n):
    """Points near the box's walls with normals facing in, and random
    shading frames on a matte BSDF (config7's wall material)."""
    axis = rng.integers(0, 3, n)
    p = rng.uniform(-0.95, 0.95, (n, 3)).astype(np.float32)
    p[np.arange(n), axis] = np.where(rng.uniform(size=n) < 0.5, -0.99, 0.99)
    ng = np.zeros((n, 3), np.float32)
    ng[np.arange(n), axis] = -np.sign(p[np.arange(n), axis])
    return p, ng


def test_lookups_match_tpuprt(config7):
    """At random points near the walls, from tpuprt's state: the caustic
    map's kernel estimate, the indirect map's cone pdf at random
    directions, the reservoir draw and the nearest radiance photon equal
    tpuprt's (the draw and the lookup exactly, the estimates within 1e-5
    relative)."""
    jscene, _, tscene, _, jaux, _, _ = config7
    taux = exphoton_aux_from_numpy(numpy_tables(jaux), "cpu")
    rng = np.random.default_rng(3)
    p, ng = _random_points(tscene, rng, N)
    wi = np.where((unit(rng, N) * ng).sum(1, keepdims=True) < 0,
                  -unit(rng, N), unit(rng, N))
    cos_ga = jaux.cos_gather
    jpdf, jtot = jex._photon_dir_pdf(jaux.maps.indirect, jnp.asarray(p),
                                     jnp.asarray(wi), cos_ga)
    tpdf, ttot = tex._photon_dir_pdf(taux.maps.indirect, torch.from_numpy(p),
                                     torch.from_numpy(wi), taux.cos_gather)
    np.testing.assert_array_equal(ttot.numpy(), np.asarray(jtot))
    assert (np.asarray(jtot) > 0).mean() > 0.5
    np.testing.assert_allclose(tpdf.numpy(), np.asarray(jpdf), rtol=1e-5)
    ph = jrng.hash_u32(jnp.arange(N, dtype=jnp.uint32), 5, 0x77)
    s_idx = np.arange(N, dtype=np.int32) % 3
    jdir, jhas = jex._reservoir_photon_dir(jaux.maps.indirect,
                                           jnp.asarray(p), ph,
                                           jnp.asarray(s_idx), 1, 4)
    tdir, thas = tex._reservoir_photon_dir(
        taux.maps.indirect, torch.from_numpy(p),
        torch.from_numpy(np.asarray(ph).astype(np.int64)),
        torch.from_numpy(s_idx), 1, torch.full((N,), 4))
    np.testing.assert_array_equal(thas.numpy(), np.asarray(jhas))
    np.testing.assert_array_equal(tdir.numpy(), np.asarray(jdir))
    jlo = jex._radiance_lookup(jaux.radiance, jnp.asarray(p),
                               jnp.asarray(ng))
    tlo = tex._radiance_lookup(taux.radiance, torch.from_numpy(p),
                               torch.from_numpy(ng))
    assert (np.asarray(jlo).max(-1) > 0).mean() > 0.8
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    # The kernel estimate on config7's white matte.
    tm = tscene.materials
    mat = np.full(N, tm.kind.tolist().index(tF.MAT_MATTE), np.int32)
    tex_vals = rng.uniform(0.05, 1.0, (tscene.textures.fparams.shape[0], N,
                                       3)).astype(np.float32)
    dpdu, wo = unit(rng, N), wi
    jb = jB.BsdfBatch(*jB.make_frame(*map(jnp.asarray, (ng, dpdu, ng))),
                      lobes=jF.make_lobes(jscene.materials, jnp.asarray(mat),
                                          jnp.asarray(tex_vals)))
    tb = tB.BsdfBatch(*tB.make_frame(*map(torch.from_numpy, (ng, dpdu, ng))),
                      lobes=tF.make_lobes(tm, torch.from_numpy(mat),
                                          torch.from_numpy(tex_vals)))
    active = rng.uniform(size=N) < 0.9
    for k in ("caustic", "direct"):
        jl = np.asarray(jex.lphoton_kernel(
            getattr(jaux.maps, k), jb, jnp.asarray(wo), jnp.asarray(p),
            jnp.asarray(active), False))
        tl = tex.lphoton_kernel(getattr(taux.maps, k), tb,
                                torch.from_numpy(wo), torch.from_numpy(p),
                                torch.from_numpy(active), False).numpy()
        assert (jl.max(-1) > 0).sum() > N // 8, k
        np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5 * jl.max(),
                                   err_msg=k)


def test_li_matches_tpuprt(config7):
    """Li per camera sample with the final gather (2 samples), from
    tpuprt's ExPhotonAux (maxdist 0.3: no wall on a cell boundary)."""
    jscene, jopts, tscene, topts, aux, _, (_, _, jout) = config7
    tout = port_li(lambda *a, **k: tex.li(tscene, *a, **k),
                   exphoton_aux_from_numpy(numpy_tables(aux), "cpu"),
                   camera_chunk(jscene, jopts), topts.photon, jopts)
    assert jout[0].max() > 1.0
    per_sample_close(jout, tout)


def test_driver_image_matches_tpuprt(config7):
    _, _, tscene, topts, aux, _, (jrgb, jalpha, _) = config7
    trgb, talpha = torch_render.render(
        tscene, topts, device="cpu",
        aux=exphoton_aux_from_numpy(numpy_tables(aux), "cpu"))
    image_close(jrgb, jalpha, trgb, talpha, RES)


def test_reservoir_draw_at_a_cell_boundary():
    """At query points on a cell boundary (a coordinate exactly 1.0 with
    radius 0.25), and one ulp inside: the port draws tpuprt's photon at
    both, and tpuprt's own draws differ between the two for many points."""
    rng = np.random.default_rng(12)
    photons = rng.uniform(-1, 1, (20000, 3)).astype(np.float32)
    photons[:, 0] = rng.uniform(0.6, 1.0, 20000)
    wi, alpha = unit(rng, 20000), np.ones((20000, 3), np.float32)
    jg = jpm.build_photon_grid(photons, wi, alpha, 0.25, 1e4)
    tg = tpm.build_photon_grid(photons, wi, alpha, 0.25, 1e4)
    q = rng.uniform(-0.9, 0.9, (N, 3)).astype(np.float32)
    draws = []
    for x in (np.float32(1.0), np.nextafter(np.float32(1.0), np.float32(0))):
        q[:, 0] = x
        ph = jrng.hash_u32(jnp.arange(N, dtype=jnp.uint32), 9, 0x77)
        jd, jh = jex._reservoir_photon_dir(jg, jnp.asarray(q), ph,
                                           jnp.zeros(N, jnp.int32), 0, 1)
        td, th = tex._reservoir_photon_dir(
            tg, torch.from_numpy(q),
            torch.from_numpy(np.asarray(ph).astype(np.int64)),
            torch.zeros(N, dtype=torch.int32), 0,
            torch.ones(N, dtype=torch.int32))
        assert np.asarray(jh).all()
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        draws.append(np.asarray(jd))
    assert (draws[0] != draws[1]).any(-1).mean() > 0.5
