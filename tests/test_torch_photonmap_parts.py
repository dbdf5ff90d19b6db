"""Photon mapping's parts held against tpuprt without its maps: the
parsed tables and PhotonParams, the lights' photon emission and the
grid-hash build over placed photons; split from test_torch_photonmap.py so
no file holds more than ten cases.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from test_torch_bvh import assert_tables_equal, numpy_tables
from test_torch_path import unit
from test_torch_photonmap import N, lights_text, scene_text
from tpuprt.accel import photon_grid as jgrid
from tpuprt.lights import emission as jem
from tpuprt.scene.parser import load_scene_string as jax_load
from tpuprt_torch.accel import photon_grid as tgrid
from tpuprt_torch.integrators import photonmap as tpm
from tpuprt_torch.lights import emission as tem
from tpuprt_torch.scene.bridge import from_numpy_tables
from tpuprt_torch.scene.parser import load_scene_string


def test_parses_into_tpuprts_tables_and_params():
    for name, gather, samples in (("config6", True, 8), ("bench6", True, 16),
                                  ("bench6ng", False, 16)):
        text = scene_text(name)
        jscene, jopts = jax_load(text)
        tscene, topts = load_scene_string(text)
        assert topts.integrator == "photonmap"
        assert tuple(topts.photon) == tuple(jopts.photon)
        assert (topts.photon.final_gather, topts.photon.gather_samples,
                topts.photon.max_dist) == (gather, samples, 0.25)
        assert tscene.accel is None
        assert (tscene.triangles.count, tscene.quadrics.count) == (10, 2)
        assert_tables_equal(tscene, from_numpy_tables(numpy_tables(jscene),
                                                      "cpu"))
    # A file without the parameters: pbrt-v1's defaults, finalgather
    # read as true.
    text = scene_text().replace('"bool finalgather" ["true"]', "")
    assert load_scene_string(text)[1].photon == \
        tpm.PhotonParams(max_dist=0.25, gather_samples=8, final_gather=True)


@pytest.mark.parametrize("which", ["disk", "point_distant_infinite"])
def test_sample_emission_matches_tpuprt(which):
    text = scene_text() if which == "disk" else lights_text()
    jscene, tscene = jax_load(text)[0], load_scene_string(text)[0]
    rng = np.random.default_rng(11)
    n_lights = tscene.lights.count
    lid = rng.integers(0, n_lights, N).astype(np.int32)
    u = rng.uniform(0, 1, (5, N)).astype(np.float32)
    je = jem.sample_emission(jscene, jnp.asarray(lid), *map(jnp.asarray, u))
    te = tem.sample_emission(tscene, torch.from_numpy(lid),
                             *map(torch.from_numpy, u))
    for k in ("o", "d", "pdf", "Le"):
        np.testing.assert_allclose(te[k].numpy(), np.asarray(je[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert sorted(set(tscene.lights.kind.tolist())) == (
        [3] if which == "disk" else [0, 2, 4])
    jl, jpdf = jem.pick_light_uniform(jscene, jnp.asarray(u[0]))
    tl, tpdf = tem.pick_light_uniform(tscene, torch.from_numpy(u[0]))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tpdf == jpdf


def test_build_photon_grid_matches_tpuprt():
    rng = np.random.default_rng(4)
    p = rng.uniform(-1, 1, (3000, 3)).astype(np.float32)
    p[:200] = rng.normal(0.35, 0.005, (200, 3))     # one crowded cell
    wi, alpha = unit(rng, 3000), rng.uniform(0, 2, (3000, 3)).astype(
        np.float32)
    j = jgrid.build_photon_grid(p, wi, alpha, 0.1, 5000.0)
    t = tgrid.build_photon_grid(p, wi, alpha, 0.1, 5000.0)
    assert t.bucket_cap == j.bucket_cap == 32 and t.count == j.count < 3000
    assert (t.n_buckets, t.radius) == (j.n_buckets, j.radius)
    np.testing.assert_array_equal(t.start.numpy(), np.asarray(j.start))
    np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed))
    assert float(t.n_paths) == float(j.n_paths)
