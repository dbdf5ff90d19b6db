"""The plain reference against the renderer under test on the CPU, on
crops of both scenes at their full-size cameras: each pixel, and the
gradient cell's losses and gradients. The reference's sample streams
against the renderer's, bit for bit."""
import os

import numpy as np
import pytest
import torch

from conftest import BENCH
from reference import render as rr, sampling, scene as rs

SCENES = os.path.join(BENCH, "configs")


def port_frame(name, window, seed, driver):
    from tpuprt_torch import render as R
    from tpuprt_torch.scene.parser import load_scene
    sc, opts = load_scene(os.path.join(SCENES, f"{name}.pbrt"))
    x0, x1, y0, y1 = window
    opts = opts._replace(crop=(x0 / opts.xres, x1 / opts.xres,
                               y0 / opts.yres, y1 / opts.yres), seed=seed,
                         driver=driver)
    return R.render(sc, opts, device="cpu")


@pytest.mark.parametrize("name,window,seed,driver", [
    ("config4_big", (250, 262, 300, 312), 11, "auto"),
    ("config4_big", (0, 8, 0, 8), 2 ** 31 + 7, "scan"),
    ("bench3", (100, 108, 100, 108), 7, "auto"),
    ("bench3", (30, 42, 200, 212), 123456789, "scan"),
])
def test_reference_matches_the_renderer_on_a_crop(name, window, seed,
                                                  driver):
    rgb, alpha = port_frame(name, window, seed, driver)
    ref = rr.Reference(rs.load(os.path.join(SCENES, f"{name}.pbrt")), "cpu")
    r2, a2 = ref.frame(seed, window)
    x0, x1, y0, y1 = window
    cut = (slice(y0, y1), slice(x0, x1))
    got, want = rgb[cut], r2.numpy()[cut]
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())
    assert np.array_equal(alpha[cut], a2.numpy()[cut])
    assert want.mean() > 0.01


def test_reference_gradients_match_the_renderer():
    """render_loss_fn's loss and its gradients in the checkerboard's two
    colours and the distant light's L, against the reference's, on a
    crop of config4_big at 1 spp."""
    import dataclasses
    from tpuprt_torch.parallel import shard
    from tpuprt_torch.scene.data import LIGHT_DISTANT
    from tpuprt_torch.scene.parser import load_scene
    path = os.path.join(SCENES, "config4_big.pbrt")
    sc, opts = load_scene(path)
    window, seed = (240, 256, 300, 316), 99
    ys, xs = torch.meshgrid(torch.arange(300, 316), torch.arange(240, 256),
                            indexing="ij")
    px, py = xs.reshape(-1).int(), ys.reshape(-1).int()
    s = torch.zeros_like(px)
    target = torch.rand(opts.yres, opts.xres, 3,
                        generator=torch.Generator().manual_seed(0))
    node = next(i for i, m in enumerate(sc.textures.nodes)
                if m.kind == "checkerboard2d")
    kids = list(sc.textures.nodes[node].children)
    lid = sc.lights.kinds_list.index(LIGHT_DISTANT)
    p = [(0.5 * sc.textures.fparams[k, :3]).clone().requires_grad_(True)
         for k in kids] + [sc.lights.spectrum[lid].clone()
                           .requires_grad_(True)]
    fp = sc.textures.fparams.clone()
    for k, v in zip(kids, p[:2]):
        fp[k, :3] = v
    spec = sc.lights.spectrum.clone()
    spec[lid] = p[2]
    sc2 = dataclasses.replace(
        sc, textures=dataclasses.replace(sc.textures, fparams=fp),
        lights=dataclasses.replace(sc.lights, spectrum=spec))
    loss = shard.render_loss_fn(sc2, opts._replace(seed=seed), px, py, s,
                                target, device="cpu")
    g = torch.autograd.grad(loss, p)

    rsc = rs.load(path)
    c = rsc.materials[0]["Kd"][1]
    leaves = {n: torch.tensor(v, dtype=torch.float32, requires_grad=True)
              for n, v in zip(("tex1", "tex2", "distant_L"),
                              (0.5 * c["tex1"], 0.5 * c["tex2"],
                               rsc.lights[1]["L"]))}
    ref = rr.Reference(rsc, "cpu", params=leaves)
    rl = ref.loss(seed, target, window)
    rg = torch.autograd.grad(rl, list(leaves.values()))
    assert loss.item() == pytest.approx(rl.item(), rel=1e-5)
    for a, b in zip(g, rg):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-7)
        assert float(b.abs().max()) > 0


def test_sample_streams_equal_the_renderers():
    from tpuprt_torch.core import rng
    from tpuprt_torch.samplers import samplers as smp
    g = torch.Generator().manual_seed(1)
    px = torch.randint(0, 512, (4096,), generator=g, dtype=torch.int32)
    py = torch.randint(0, 512, (4096,), generator=g, dtype=torch.int32)
    s = torch.randint(0, 32, (4096,), generator=g, dtype=torch.int32)
    seed = 2 ** 31 + 99
    cfg = smp.SamplerConfig(kind="lowdiscrepancy", pixelsamples=32)
    cs = smp.camera_samples(cfg, px, py, s, seed)
    ix, iy = sampling.camera_sample(px, py, s, seed)
    assert torch.equal(ix, cs["image_x"]) and torch.equal(iy, cs["image_y"])
    for b, purpose in ((0, 10), (3, 101)):
        assert torch.equal(sampling.sample1(px, py, s, b, purpose, seed),
                           smp.integrator_1d(cfg, px, py, s, b, purpose,
                                             seed))
        for u, v in zip(sampling.sample2(px, py, s, b, purpose, seed),
                        smp.integrator_2d(cfg, px, py, s, b, purpose, seed)):
            assert torch.equal(u, v)
    assert torch.equal(sampling.uniform(px, s, 3, 30),
                       rng.uniform(px, s, 3, 30))


def test_the_reference_refuses_what_it_cannot_check():
    with pytest.raises(NotImplementedError):
        rs.parse('Shape "cylinder" "float radius" [1]')
    with pytest.raises(NotImplementedError):
        rs.parse('SurfaceIntegrator "photonmap"')
