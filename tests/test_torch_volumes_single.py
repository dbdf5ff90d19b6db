"""The port's single-scattering march held against tpuprt's on the CPU, per
lane: VOLUME_BOX's homogeneous box, its point light, and rays through it
(test_torch_volumes.py holds the regions and the emission march). tpuprt's
li_single runs eagerly once, under jax.disable_jit, for the whole file: a
jit of it does not compile within minutes on the CPU. The port's renders
of a small "single" scene are held to tpuprt's image of it, rendered
eagerly (scenes/single_box.exr).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import chip_smoke
from test_torch_volumes import VOLUME_BOX, lanes
from tpuprt.integrators import volume as jvi
from tpuprt.scene.parser import load_scene_string as jax_load
from tpuprt_torch.accel import intersect as tisect
from tpuprt_torch.integrators import volume as tvi
from tpuprt_torch.io.exr import read_exr
from tpuprt_torch.render import render
from tpuprt_torch.scene.parser import load_scene_string

torch.set_num_threads(1)

TEXT = VOLUME_BOX.replace('"emission"', '"single"')
N = 64


@pytest.fixture(scope="module")
def single():
    """(port scene, the lanes' arguments as numpy, tpuprt's Li)."""
    js = jax_load(TEXT)[0]
    x = lanes(N, seed=4)
    rng = np.random.default_rng(5)
    ph = rng.integers(0, 2 ** 32, N, dtype=np.uint32)
    s_idx = rng.integers(0, 8, N).astype(np.int32)
    args = [x[k] for k in ("o", "d", "mint", "maxt")] + [ph, s_idx]
    with jax.disable_jit():
        L = np.asarray(jvi.li_single(js, *map(jnp.asarray, args), 0))
    return load_scene_string(TEXT)[0], args, L


def port_args(args):
    return [torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32
                             else a) for a in args]


def test_li_single_matches_tpuprt_per_lane(single):
    """Emission and the in-scattered light of every step, each draw keyed
    by (pixel, sample, step, purpose 0x71-0x75); the 32 steps' transmittance
    sums in tpuprt's order (rtol 1e-5)."""
    ts, args, L = single
    got = tvi.li_single(ts, *port_args(args), 0).numpy()
    assert (L > 0).sum() > N // 4
    np.testing.assert_allclose(got, L, rtol=1e-5, atol=1e-6)


def test_li_single_sends_its_shadow_rays_in_one_call(single):
    """The 32 steps' shadow rays of a call go to the traversal together:
    one occluded() call of 32 x N rays, the same Li."""
    ts, args, L = single
    calls, real = [], tisect.occluded

    def spy(scene, o, *a):
        calls.append(o.shape[0])
        return real(scene, o, *a)
    tisect.occluded = spy
    try:
        got = tvi.li_single(ts, *port_args(args), 0).numpy()
    finally:
        tisect.occluded = real
    assert calls == [32 * N]
    np.testing.assert_allclose(got, L, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("driver", ["wavefront", "scan"])
def test_single_render_matches_tpuprts_image(driver):
    """chip_smoke.single_text's small scene ("single" over a homogeneous
    region and a 4^3 volumegrid, a point and a disk area light, 14
    triangles under Accelerator "none") rendered on the CPU by the pool
    and by the scan with f16 readback, against scenes/single_box.exr,
    tpuprt's eager render of the same text (tools/volume_refs.py single):
    within one f16 step (rtol 2^-10), alpha equal."""
    ref, ref_alpha = read_exr(chip_smoke.SINGLE_EXR)
    scene, opts = load_scene_string(chip_smoke.single_text())
    rgb, alpha = render(scene, opts._replace(driver=driver,
                                             half_readback=True),
                        device="cpu")
    assert opts.volume_integrator == "single" and ref.mean() > 0.01
    np.testing.assert_allclose(rgb, ref, rtol=2 ** -10, atol=1e-6)
    np.testing.assert_array_equal(alpha, ref_alpha)
