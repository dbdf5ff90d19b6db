"""The boundary (silhouette) terms in the port, continued from
test_torch_silhouette.py (split from it so no file holds more than ten
cases): the rank blocks of the edge samples summing to the whole batch's
term, a mesh light's interior gradient and masked lanes' gradients staying
finite. The module fixture `results` is test_torch_silhouette's, computed
again for this module.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from test_torch_silhouette import (CASES, RES, RTOL, TERM_OF, batch, loss_fns,
                                   moved, occluder_scene, options, results)
from tpuprt import render as jax_render
from tpuprt.cameras import cameras as jcam
from tpuprt.diff import silhouette as jsil
from tpuprt.parallel.shard import render_loss_fn as jax_loss
from tpuprt.samplers.samplers import SamplerConfig as JaxSampler
from tpuprt.scene.build import SceneBuilder as JaxBuilder
from tpuprt_torch import render as R
from tpuprt_torch.cameras import cameras as cam
from tpuprt_torch.diff import silhouette as sil
from tpuprt_torch.parallel.shard import render_loss_fn
from tpuprt_torch.samplers.samplers import SamplerConfig
from tpuprt_torch.scene.build import SceneBuilder


@pytest.mark.parametrize("name", list(CASES))
def test_rank_blocks_sum_to_whole(results, name):
    """Three ranks' blocks of the edge samples (of uneven sizes): their
    shares sum to the whole term, value and gradient, and every block
    has live lanes of the case's term."""
    r = results(name)
    _, _, _, spp, _, rows, fn, n, seed = CASES[name]
    term = TERM_OF[fn]
    fns = loss_fns(r["target"], spp, torch)
    value, grad = 0.0, 0.0
    for rank in range(3):
        sil.live_lanes[term] = 0
        cx = torch.zeros((), requires_grad=True)
        v = getattr(sil, fn)(moved(r["scene"], cx, rows, False), r["opts"],
                             fns[1 if name == "area" else 0], n, seed,
                             part=(rank, 3))
        v.backward()
        assert sil.live_lanes[term] > 0, (rank, term)
        value, grad = value + float(v), grad + float(cx.grad)
    np.testing.assert_allclose(value, r["tv"], rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(grad, r["tg"], rtol=RTOL)


def test_mesh_light_interior_gradient_finite():
    """The interior gradient of the area-shadow scene (a quad area light)
    in the light's spectrum and the occluder's vertices: finite here.
    tpuprt's is NaN: a lane whose BSDF-strategy ray misses the light
    keeps a far hit point, and pdf_area_from_hit's backward takes 0 * inf
    there (tpuprt/lights/lights.py:515-522)."""
    make, kw, integ, spp, cx_t, rows, _, _, _ = CASES["area"]
    opts = options(R, SamplerConfig, integ, spp)
    jopts = options(jax_render, JaxSampler, integ, spp)
    ids = batch(spp)
    target = np.zeros((RES, RES, 3), np.float32)
    jscene = make(JaxBuilder, jcam, **kw)
    jg = jax.jit(jax.grad(lambda c: jax_loss(
        moved(jscene, c, rows, True), jopts,
        *(jnp.asarray(a) for a in ids), jnp.asarray(target))))(0.0)
    assert np.isnan(float(jg))
    scene = make(SceneBuilder, cam, **kw)
    spectrum = scene.lights.spectrum.clone().requires_grad_(True)
    cx = torch.zeros((), requires_grad=True)
    loss = render_loss_fn(moved(dataclasses.replace(
        scene, lights=dataclasses.replace(scene.lights, spectrum=spectrum)),
        cx, rows, False), opts, *(torch.from_numpy(a) for a in ids),
        torch.from_numpy(target), device="cpu")
    loss.backward()
    assert torch.isfinite(spectrum.grad).all() and torch.isfinite(cx.grad)
    assert float(spectrum.grad.abs().max()) > 0


def test_masked_lanes_leave_gradient_finite():
    """_image_jump_surrogate with a curve whose masked lanes sit at an
    infinite position (u = 0 divides): the port's gradient is finite and
    equals the live lanes' sum; tpuprt's backward meets 0 * inf there."""
    scene = occluder_scene(SceneBuilder, cam)
    jscene = occluder_scene(JaxBuilder, jcam)
    opts = options(R, SamplerConfig, "debug", 1)
    jopts = options(jax_render, JaxSampler, "debug", 1)
    u = np.asarray([0.0, 0.25, 0.5, 0.75], np.float32)
    live = u > 0

    def curve(theta, uu, module):
        x = 4.0 + theta / uu * 0.0 + 8.0 * uu
        y = 6.0 + theta * uu
        return module.stack([x, y], -1), module.ones_like(uu) > 0

    jump = lambda L_m, L_p, px, py: L_m[:, 0] * 0.0 + 1.0  # noqa: E731
    theta = torch.ones((), requires_grad=True)
    s = sil._image_jump_surrogate(
        scene, opts, jump, lambda uu: curve(theta, uu, torch),
        torch.from_numpy(u), (), torch.from_numpy(live), 1.0, 0.5,
        "primary")
    s.backward()
    assert torch.isfinite(theta.grad)
    # d/dtheta of sum_live n_perp . xy: n_perp = (dy/du, -dx/du)/|..|.
    dxy = np.stack([np.full(3, 8.0), np.ones(3)], -1)
    n = np.stack([dxy[:, 1], -dxy[:, 0]], -1) / np.linalg.norm(dxy, axis=1,
                                                              keepdims=True)
    want = float((np.linalg.norm(dxy, axis=1) * (n[:, 1] * u[live])).sum())
    np.testing.assert_allclose(float(theta.grad), want, rtol=1e-5)
    jg = jax.jit(jax.grad(lambda th: jsil._image_jump_surrogate(
        jscene, jopts, jump, lambda uu: curve(th, uu, jnp),
        jnp.asarray(u), jnp.asarray(live), 1.0, 0.5)))(1.0)
    assert np.isnan(float(jg))
