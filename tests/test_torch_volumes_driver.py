"""The port's volumes through its integrators, held against tpuprt on the
CPU: the chunked driver's composition L = T L + Lv per camera sample
(test_torch_volumes.py holds the regions, the marches and next-event
estimation). tpuprt runs eagerly, never jitted.
"""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from test_torch_volumes import VOLUME_BOX
from tpuprt import render as jax_render
from tpuprt.scene.parser import load_scene_string as jax_load
from tpuprt_torch import render as torch_render
from tpuprt_torch.scene.parser import load_scene_string

torch.set_num_threads(1)


def _splatted(module, call):
    """The radiance render_chunk splats, per sample, as numpy."""
    got, real = [], module.film_mod.add_samples

    def spy(film, ix, iy, L, *a, **k):
        got.append(np.array(L))
        return real(film, ix, iy, L, *a, **k)
    module.film_mod.add_samples = spy
    try:
        call()
    finally:
        module.film_mod.add_samples = real
    return got[0]


def test_render_chunk_composition_matches_tpuprt():
    """The chunked driver's L = T L + Lv per camera sample, emission, path
    at depth 1 (its second segment attenuated too), tpuprt's render_chunk
    eager."""
    text = VOLUME_BOX.replace("[16]", "[8]").replace(
        '"integer maxdepth" [3]', '"integer maxdepth" [1]')
    js, jo = jax_load(text)
    ts, to = load_scene_string(text)
    spp = 2
    lin = np.arange(8 * 8 * spp)
    ids = [(lin // spp % 8).astype(np.int32),
           (lin // spp // 8).astype(np.int32), (lin % spp).astype(np.int32)]
    from tpuprt.film import film as jfilm
    from tpuprt_torch.film import film as tfilm
    with jax.disable_jit():
        lj = _splatted(jax_render, lambda: jax_render.render_chunk(
            js, jo, jfilm.make_film(8, 8), *map(jnp.asarray, ids),
            jnp.ones(lin.shape, bool)))
    lt_ = _splatted(torch_render, lambda: torch_render.render_chunk(
        ts, to, tfilm.make_film(8, 8, device="cpu"),
        *map(torch.from_numpy, ids)))
    assert (lj > 0).any()
    np.testing.assert_allclose(lt_, lj, rtol=1e-4, atol=1e-5)
