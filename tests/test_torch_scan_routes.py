"""The render driver's routing (RenderOptions.driver and the integrator
decide between the pool and the chunked driver) as tpuprt routes; split
from test_torch_scan.py so no file holds more than ten cases.
"""
import pytest

from test_torch_scan import CORNELL_LIGHTS
from tpuprt_torch import render as torch_render
from tpuprt_torch.integrators import path_wavefront as tpool
from tpuprt_torch.scene.parser import load_scene_string


@pytest.mark.parametrize("driver,integrator,ckpt,expect", [
    ("auto", "path", False, "pool"), ("auto", "photonmap", False, "pool"),
    ("auto", "directlighting", True, "scan"), ("auto", "debug", False,
                                               "scan"),
    ("auto", "igi", False, "scan"), ("scan", "whitted", False, "scan"),
    ("wavefront", "whitted", True, "pool")])
def test_driver_routes_as_tpuprt(monkeypatch, driver, integrator, ckpt,
                                 expect):
    """tpuprt/render.py:226-234: "auto" takes the pool for path,
    directlighting, whitted and photonmap unless a checkpoint, a resume or
    a writefrequency is asked for; "scan" never; "wavefront" always."""
    scene, opts = load_scene_string(CORNELL_LIGHTS)
    went = []
    monkeypatch.setattr(tpool, "render",
                        lambda *a, **k: went.append("pool"))
    monkeypatch.setattr(torch_render, "render_chunked",
                        lambda *a, **k: went.append("scan"))
    torch_render.render(scene, opts._replace(driver=driver,
                                             integrator=integrator),
                        device="cpu",
                        checkpoint_path="unused.npz" if ckpt else None)
    assert went == [expect]
    if integrator == "path":
        went.clear()
        torch_render.render(scene, opts._replace(integrator=integrator,
                                                 writefrequency=64),
                            device="cpu")
        assert went == ["scan"]
    with pytest.raises(ValueError, match="driver"):
        torch_render.render(scene, opts._replace(driver="pool"),
                            device="cpu")
