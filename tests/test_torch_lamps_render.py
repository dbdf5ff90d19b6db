"""Instanced area emitters in the port's renderer held against tpuprt on
the CPU: test_torch_tessellate.lamp_text's three instanced lamps over a
floor at 16x16 x 4 spp, directlighting "all", per camera sample. tpuprt's
render_chunk runs as test_torch_gi runs it (its scan jitted: this scene has
no volume).
"""
import numpy as np
import torch

from test_torch_gi import camera_chunk, per_sample_close, tpuprt_chunk
from test_torch_tessellate import lamp_text
from tpuprt.scene.parser import load_scene_string as jax_load
from tpuprt_torch import render as torch_render
from tpuprt_torch.scene.parser import load_scene_string

torch.set_num_threads(1)


def test_render_per_sample_matches_tpuprt():
    """16x16 x 4 spp, directlighting "all": L, alpha and t_first per camera
    sample against tpuprt's render_chunk (per_sample_close's measures)."""
    js, jo = jax_load(lamp_text())
    ts, to = load_scene_string(lamp_text())
    cam = camera_chunk(js, jo)
    _, _, jout = tpuprt_chunk(js, jo)
    arr = {k: torch.from_numpy(v) for k, v in cam.items()
           if isinstance(v, np.ndarray)}
    tout = torch_render.li(
        ts, to, None, arr["o"], arr["d"], arr["mint"], arr["maxt"],
        arr["px"], arr["py"], arr["s_idx"],
        tuple(map(torch.from_numpy, cam["rx"])),
        tuple(map(torch.from_numpy, cam["ry"])))
    assert (jout[0] > 0).any()
    per_sample_close(jout, [x.numpy() for x in tout])
