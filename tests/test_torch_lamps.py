"""Instanced area emitters in the port held against tpuprt on the CPU, per
lane: test_torch_tessellate.lamp_text's lamps (three placements of one
emissive quad, each its own light; no mirror, where tpuprt's sampled
normal is right): the light sample, the photon emission, a hit's light and
its radiance. A render per camera sample is in test_torch_lamps_render.py.
"""
import numpy as np
import jax.numpy as jnp
import torch

from test_torch_tessellate import lamp_text
from tpuprt.accel import intersect as jisect
from tpuprt.lights import emission as jem, lights as jlt
from tpuprt.scene.parser import load_scene_string as jax_load
from tpuprt_torch.accel import intersect as tisect
from tpuprt_torch.lights import emission as tem, lights as tlt
from tpuprt_torch.scene.parser import load_scene_string

torch.set_num_threads(1)
N = 256


def _both():
    return jax_load(lamp_text())[0], load_scene_string(lamp_text())[0]


def _lanes(seed):
    rng = np.random.default_rng(seed)
    p = np.stack([rng.uniform(-2.5, 2.5, N), np.full(N, -0.5),
                  rng.uniform(-2, 2, N)], -1).astype(np.float32)
    return (np.tile(np.float32([[0, 1, 0]]), (N, 1)), p,
            rng.integers(0, 3, N).astype(np.int32),
            rng.uniform(0, 1, (5, N)).astype(np.float32))


def _close(j, t, what, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=atol, err_msg=what)


def test_light_sample_matches_tpuprt():
    """Sample_L from floor points toward each lane's lamp: a prototype
    triangle by the area CDF, a point on it under the instance's
    transform; Li, wi, pdf and the shadow segment per lane."""
    js, ts = _both()
    nrm, p, lid, u = _lanes(0)
    j = jlt.sample(js, *map(jnp.asarray, (lid, p, nrm, u[0], u[1], u[2])))
    t = tlt.sample(ts, *map(torch.from_numpy, (lid, p, nrm, u[0], u[1],
                                               u[2])))
    assert (np.asarray(j["Li"]) > 0).any(1).mean() > 0.5
    for k in ("Li", "wi", "pdf", "vis_maxt"):
        _close(j[k], t[k], k)


def test_photon_emission_matches_tpuprt():
    """Sample_L for photons: origin on the lamp, direction over its
    emitting hemisphere, pdf and Le per lane."""
    js, ts = _both()
    _, _, lid, u = _lanes(1)
    j = jem.sample_emission(js, *map(jnp.asarray, (lid, *u)))
    t = tem.sample_emission(ts, *map(torch.from_numpy, (lid, *u)))
    for k in ("o", "d", "pdf", "Le"):
        _close(j[k], t[k], k)


def test_hit_light_and_radiance_match_tpuprt():
    """Rays up from the floor: the instance's own light id where they hit a
    lamp, and its emitted radiance toward the ray's origin."""
    js, ts = _both()
    nrm, p, _, u = _lanes(2)
    d = np.stack([u[0] - 0.5, np.ones(N), u[1] - 0.5], -1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    win = (np.full(N, 1e-3, np.float32), np.full(N, 1e30, np.float32))
    out = []
    for isect, lt, arr in ((jisect, jlt, jnp.asarray),
                           (tisect, tlt, torch.from_numpy)):
        sc = js if isect is jisect else ts
        o, dd = arr(p), arr(d)
        t, pid, hit = isect.intersect_ids(sc, o, dd, *map(arr, win))
        dg = isect.hit_geometry(sc, pid, o, dd, t)
        out.append([np.asarray(x) for x in (
            hit, dg["area_light"], lt.area_emission(
                sc, dg["area_light"], dg["nn"], -dd))])
    (hj, aj, lj), (ht, at, lt_) = out
    np.testing.assert_array_equal(ht, hj)
    np.testing.assert_array_equal(at[ht], aj[hj])
    assert set(at[ht].tolist()) == {0, 1, 2}
    _close(lj[hj], lt_[ht], "Le")
