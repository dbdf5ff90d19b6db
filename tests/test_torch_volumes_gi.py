"""igi's preprocess through a medium, the port held against tpuprt on the
CPU per path: the virtual lights' power attenuated by each segment's
transmittance (tpuprt/integrators/igi.py:93-97), on VOLUME_BOX (its point
light inside the box) with a floor across the box. The photons' are in
test_torch_volumes_photons.py.
tpuprt's paths run eagerly under jax.disable_jit: a jit of its volume code
compiles for minutes on the CPU.
"""
import numpy as np
import jax
import torch

from test_torch_volumes import VOLUME_BOX
from tpuprt.integrators import igi as jigi
from tpuprt.scene.parser import load_scene_string as jax_load
from tpuprt_torch.integrators import igi as tigi
from tpuprt_torch.scene.parser import load_scene_string

torch.set_num_threads(1)

BOX = VOLUME_BOX.replace("WorldBegin\n", """WorldBegin
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-4 -1.5 0  4 -1.5 0  4 -1.5 6  -4 -1.5 6]
""")


def test_virtual_lights_attenuated_as_tpuprt():
    """igi with one set of 64 paths of 2 vertices: every valid virtual
    light's position and power (rtol 1e-5)."""
    js = jax_load(BOX)[0]
    ts = load_scene_string(BOX)[0]
    prm = dict(nlights=64, nsets=1, depth_bound=2)
    with jax.disable_jit():
        j = jigi.build_virtual_lights(js, jigi.IgiParams(**prm), 0)
    t = tigi.build_virtual_lights(ts, tigi.IgiParams(**prm), 0)
    valid = np.asarray(j.valid)
    np.testing.assert_array_equal(t.valid.numpy(), valid)
    assert valid.sum() >= 8
    np.testing.assert_allclose(t.p.numpy()[valid], np.asarray(j.p)[valid],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t.Le.numpy()[valid], np.asarray(j.Le)[valid],
                               rtol=1e-5, atol=1e-7)
