"""Next-event estimation through a medium, the port held against tpuprt on
the CPU per lane: uniform_sample_all_lights at the sphere's camera-ray hits
of VOLUME_BOX with a spherical area light added, each light's radiance
attenuated by its shadow segment's transmittance (tpuprt/integrators/
common.py:288-292). tpuprt runs eagerly, never jitted. Split from
test_torch_volumes.py so each file keeps within a worker's budget.
"""
import numpy as np
import jax.numpy as jnp
import torch

from test_torch_gi import camera_chunk
from test_torch_volumes import VOLUME_BOX, close
from tpuprt.accel import intersect as jisect
from tpuprt.integrators import common as jcommon
from tpuprt.scene.parser import load_scene_string as jax_load
from tpuprt_torch.accel import intersect as tisect
from tpuprt_torch.integrators import common as tcommon
from tpuprt_torch.scene.parser import load_scene_string

torch.set_num_threads(1)


# VOLUME_BOX with a spherical area light beside the point light.
LIT_BOX = VOLUME_BOX.replace("WorldBegin\n", """WorldBegin
AttributeBegin
AreaLightSource "area" "color L" [3 3 3]
Translate -1.2 1.2 3.5
Shape "sphere" "float radius" [0.3]
AttributeEnd
""")


def test_next_event_estimation_through_the_medium():
    """uniform_sample_all_lights per lane at the sphere's camera-ray hits:
    the point and the area light's radiance attenuated by the shadow
    segment's transmittance, held to tpuprt's."""
    js, jo = jax_load(LIT_BOX)
    ts = load_scene_string(LIT_BOX)[0]
    cam = camera_chunk(js, jo._replace(xres=8, yres=8))
    rng = np.random.default_rng(3)
    n = len(cam["px"])
    u = rng.uniform(0, 1, (2, 4, 2, n)).astype(np.float32)
    ray = [cam[k] for k in ("o", "d", "mint", "maxt")]
    outs = []
    for isect, common, arr in ((jisect, jcommon, jnp.asarray),
                               (tisect, tcommon, torch.from_numpy)):
        sc = js if isect is jisect else ts
        r = list(map(arr, ray))
        t, pid, hit = isect.intersect_ids(sc, *r)
        dg = isect.hit_geometry(sc, pid, r[0], r[1], t)
        bsdf = common.make_bsdf_at(sc, dg)
        nn = bsdf.nn
        outs.append((np.asarray(hit), common.uniform_sample_all_lights(
            sc, dg["p"], nn, -r[1], bsdf,
            lambda i, k: (arr(u[i, k, 0]), arr(u[i, k, 1])), hit)))
    (hj, lj), (ht, lt_) = outs
    np.testing.assert_array_equal(hj, ht)
    assert hj.sum() > 10 and (lt_.numpy()[hj] > 0).any()
    close(lj, lt_, 1e-4, 1e-5)
