"""Photon shooting through a medium, the port held against tpuprt on the
CPU per path: each photon's power attenuated by each segment's
transmittance (tpuprt/integrators/photonmap.py:109-114), on
test_torch_volumes_gi.BOX. tpuprt's paths run eagerly under
jax.disable_jit: a jit of its volume code compiles for minutes on the CPU.
"""
import numpy as np
import jax
import torch

from test_torch_volumes_gi import BOX
from tpuprt.integrators import photonmap as jpm
from tpuprt.scene.parser import load_scene_string as jax_load
from tpuprt_torch.integrators import photonmap as tpm
from tpuprt_torch.scene.parser import load_scene_string

torch.set_num_threads(1)


def test_photons_attenuated_as_tpuprt():
    """256 photon paths of 2 bounces: each deposit's validity, position and
    power (rtol 1e-5); the medium takes a share of the power."""
    js = jax_load(BOX)[0]
    ts = load_scene_string(BOX)[0]
    with jax.disable_jit():
        j = [np.asarray(x) for x in jpm.shoot_batch(js, 0, 256, 2, 0)]
    t = [x.numpy() for x in tpm.shoot_batch(ts, 0, 256, 2, 0)]
    valid = j[4]
    np.testing.assert_array_equal(t[4], valid)
    assert valid.sum() >= 32
    for k in (0, 2):
        np.testing.assert_allclose(t[k][valid], j[k][valid], rtol=1e-5,
                                   atol=1e-6)
    # Without the box, the same photons carry more power.
    bare = load_scene_string(BOX.replace("Volume ", "#"))[0]
    free = tpm.shoot_batch(bare, 0, 256, 2, 0)[2].numpy()
    assert (t[2][valid] < free[valid]).all()
