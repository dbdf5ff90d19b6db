"""Gradients in the port on the CPU: torch autograd of render_loss_fn
(tpuprt_torch/parallel/shard.py) held against jax.grad of tpuprt's and
against the port's own central finite differences, at tpuprt's
tolerances (tests/test_grad.py).

- Against tpuprt (16x16, tests/test_grad.py:18-37's sphere and point
  light): whitted albedo, directlighting light intensity, path Kd through
  two bounces; tpuprt's scene is built once and each of its gradients
  computed once, jitted (one XLA compile each, 14 s for the three on
  this CPU against 39 s op by op under jax.disable_jit; the gradients
  agree to 1e-8).
- Against finite differences: the camera's translation, a texel of an
  imagemap texture, a vertex translation through the BVH's recompute on a
  5,040-triangle sphere (interior rays), a vertex translation through the
  brute force on a scene that already holds its packed table (render()'s
  tris_packed), an instance's translation through instances.recompute_t.
- The kernels' autograd wrappers: outputs non-differentiable, no gradient
  to rays or tables.
- The loss runs on the card unless asked for the CPU.
- Adam recovers a matte sphere's albedo (tests/test_fixes.py:143).
Every gradient is finite.

The finite-difference cases are in test_torch_grad_fd.py (no file holds
more than ten cases).
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tpuprt.cameras import cameras as jcam
from tpuprt.core import transform as jtf
from tpuprt.parallel.shard import render_loss_fn as jax_loss
from tpuprt import render as jax_render
from tpuprt.samplers.samplers import SamplerConfig as JaxSampler
from tpuprt.scene.build import SceneBuilder as JaxBuilder
from tpuprt_torch import render as R
from tpuprt_torch.accel import intersect as isect
from tpuprt_torch.cameras import cameras as cam
from tpuprt_torch.core import transform as tf
from tpuprt_torch.io.exr import write_exr
from tpuprt_torch.ops import bvh_cuda, mt_cuda
from tpuprt_torch.parallel.shard import (render_loss_fn, sample_losses,
                                         split_float_params)
from tpuprt_torch.samplers.samplers import SamplerConfig
from tpuprt_torch.scene.build import SceneBuilder
from tpuprt_torch.scene.data import BvhAccel
from tpuprt_torch.scene.parser import load_scene_string

torch.set_num_threads(1)
RES = 16


def sphere_scene(builder, camera, transform, kd=(0.6, 0.3, 0.2), res=RES):
    """tests/test_grad.py:18-37: a matte unit sphere, a point light of 30,
    the camera at z = -4; `builder`, `camera` and `transform` are either
    package's."""
    b = builder()
    mat = b.matte(kd=kd)
    b.add_sphere(np.asarray(transform.translate([0.0, 0.0, 0.0])), 1.0,
                 material=mat)
    b.add_point_light(np.asarray(transform.translate([2.0, 2.0, -3.0])),
                      intensity=(30.0,) * 3)
    c2w = np.asarray(transform.look_at([0, 0, -4], [0, 0, 0], [0, 1, 0]))
    b.set_camera(camera.build_projective(
        0, c2w, np.asarray(transform.perspective(45.0, 1e-2, 100.0)),
        camera.default_screen_window(res, res), res, res))
    return b.build()


def options(module, sampler, integrator="whitted", max_depth=0, spp=None):
    cfg = sampler(kind="stratified", xsamples=1, ysamples=1,
                  jitter=False) if spp is None else \
        sampler(kind="lowdiscrepancy", pixelsamples=spp)
    return module.RenderOptions(
        xres=RES, yres=RES, sampler=cfg, filter_kind="box",
        filter_xwidth=0.5, filter_ywidth=0.5, integrator=integrator,
        max_depth=max_depth, chunk_size=RES * RES * (spp or 1))


def batch(res=RES, spp=1):
    lin = np.arange(res * res * spp)
    return ((lin // spp % res).astype(np.int32),
            (lin // spp // res).astype(np.int32),
            (lin % spp).astype(np.int32))


def autograd(scene, loss_of_scene):
    """Loss and the scene with every float table's .grad filled; asserts
    every gradient is finite."""
    params, rebuild = split_float_params(scene)
    params = tuple(p.detach().clone().requires_grad_(True) for p in params)
    sc = rebuild(params)
    loss = loss_of_scene(sc)
    loss.backward()
    for p in params:
        assert p.grad is None or torch.isfinite(p.grad).all()
    return loss.item(), sc


def central_fd(loss_of_value, eps):
    with torch.no_grad():
        return (float(loss_of_value(eps)) -
                float(loss_of_value(-eps))) / (2 * eps)


# (integrator, max_depth, spp, table, field): tests/test_grad.py:40-88
# and :262-296.
TPUPRT_CASES = {
    "whitted_albedo": ("whitted", 0, None, "textures", "fparams"),
    "directlighting_intensity": ("directlighting", 0, None, "lights",
                                 "spectrum"),
    "path_multibounce_kd": ("path", 2, 4, "textures", "fparams"),
}


@pytest.fixture(scope="module")
def tpuprt_grads():
    """jax.grad of tpuprt's loss for each of TPUPRT_CASES, jitted, on one
    build of tpuprt's scene: {case: numpy gradient}."""
    jscene = sphere_scene(JaxBuilder, jcam, jtf)
    out = {}
    for case, (integrator, depth, spp, table, field) in \
            TPUPRT_CASES.items():
        ids = [jnp.asarray(a) for a in batch(spp=spp or 1)]
        jopts = options(jax_render, JaxSampler, integrator, depth, spp)

        def jloss(v, table=table, field=field, jopts=jopts, ids=ids):
            sc = dataclasses.replace(jscene, **{table: dataclasses.replace(
                getattr(jscene, table), **{field: v})})
            return jax_loss(sc, jopts, *ids, jnp.zeros((RES, RES, 3)))
        out[case] = np.asarray(jax.jit(jax.grad(jloss))(
            getattr(getattr(jscene, table), field)))
    return out


@pytest.mark.parametrize("case", list(TPUPRT_CASES))
def test_grad_matches_tpuprt(case, tpuprt_grads):
    """d loss / d (Kd or I) of a zero target, every element of the table,
    torch autograd against jax.grad within rtol 1e-3."""
    integrator, depth, spp, table, field = TPUPRT_CASES[case]
    px, py, si = batch(spp=spp or 1)
    jg = tpuprt_grads[case]
    topts = options(R, SamplerConfig, integrator, depth, spp)
    t = [torch.from_numpy(x) for x in (px, py, si)]
    _, sc = autograd(sphere_scene(SceneBuilder, cam, tf),
                     lambda s: render_loss_fn(s, topts, *t,
                                              torch.zeros(RES, RES, 3),
                                              device="cpu"))
    tg = getattr(getattr(sc, table), field).grad.numpy()
    assert np.abs(jg).max() > 1e-4
    np.testing.assert_allclose(tg, jg, rtol=1e-3,
                               atol=1e-3 * np.abs(jg).max())


def camera_case():
    """tests/test_grad.py:238-259: the camera moved by dx along x, the
    target rendered (scan) from dx = 0.05."""
    opts = options(R, SamplerConfig)
    scene0 = sphere_scene(SceneBuilder, cam, tf)

    def moved(sc, dx):
        c2w = sc.camera.cam2world.clone()
        c2w[0, 3] = c2w[0, 3] + dx
        return dataclasses.replace(sc, camera=dataclasses.replace(
            sc.camera, cam2world=c2w))
    target = torch.from_numpy(R.render(moved(scene0, 0.05), opts._replace(
        driver="scan"), device="cpu")[0])
    t = [torch.from_numpy(x) for x in batch()]
    dx = torch.zeros((), requires_grad=True)
    loss = render_loss_fn(moved(scene0, dx), opts, *t, target,
                          device="cpu")
    loss.backward()
    fd = central_fd(lambda e: render_loss_fn(moved(scene0, e), opts, *t,
                                             target, device="cpu"), 1e-2)
    g = float(dx.grad)
    assert fd < 0 and g < 0, (g, fd)
    return g, fd, 0.3 * abs(fd) + 1e-4


TEXEL_SCENE = """
Film "image" "integer xresolution" [16] "integer yresolution" [16]
LookAt 0 0 -4  0 0 0  0 1 0
Camera "perspective" "float fov" [45]
Sampler "stratified" "integer xsamples" [1] "integer ysamples" [1]
    "bool jitter" ["false"]
PixelFilter "box" "float xwidth" [0.5] "float ywidth" [0.5]
SurfaceIntegrator "whitted" "integer maxdepth" [0]
WorldBegin
LightSource "point" "point from" [2 2 -3] "color I" [30 30 30]
Texture "tx" "color" "imagemap" "string filename" ["t.exr"]
Material "matte" "texture Kd" "tx"
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-1 -1 0  1 -1 0  1 1 0  -1 1 0]
  "float uv" [0 0  1 0  1 1  0 1]
WorldEnd
"""


def texel_case(tmp_path):
    """tests/test_grad.py:182-235: texel (1, 1)'s red channel of a 4x4
    imagemap's level 0, through the MIPMap lookup."""
    write_exr(str(tmp_path / "t.exr"), np.full((4, 4, 3), 0.5, np.float32),
              np.ones((4, 4), np.float32))
    scene, opts = load_scene_string(TEXEL_SCENE, str(tmp_path))
    img = scene.images
    k = int(img.level_off[0, 0]) + 1 * int(img.level_w[0, 0]) + 1
    t = [torch.from_numpy(x) for x in batch()]
    target = torch.zeros(RES, RES, 3)

    def with_texel(delta):
        tex = img.texels.clone()
        tex[k, 0] = tex[k, 0] + delta
        return dataclasses.replace(scene, images=dataclasses.replace(
            img, texels=tex))
    _, sc = autograd(scene, lambda s: render_loss_fn(s, opts, *t, target,
                                                     device="cpu"))
    g = float(sc.images.texels.grad[k, 0])
    fd = central_fd(lambda e: render_loss_fn(with_texel(e), opts, *t,
                                             target, device="cpu"), 1e-3)
    assert abs(fd) > 1e-6, fd
    return g, fd, 0.03 * max(abs(fd), 1e-4)


def uv_sphere(n_u=72, n_v=36):
    """tests/test_grad.py:303-320's sphere: 72 x 35 x 2 = 5,040
    triangles."""
    us = np.linspace(0, 2 * np.pi, n_u, endpoint=False)
    vs = np.linspace(1e-3, np.pi - 1e-3, n_v)
    U, V = np.meshgrid(us, vs)
    P = np.stack([np.cos(U) * np.sin(V), np.cos(V),
                  np.sin(U) * np.sin(V)], -1).reshape(-1, 3)
    idx = []
    for j in range(n_v - 1):
        for i in range(n_u):
            a, b = j * n_u + i, j * n_u + (i + 1) % n_u
            c, d = (j + 1) * n_u + i, (j + 1) * n_u + (i + 1) % n_u
            idx += [[a, b, c], [b, d, c]]
    return np.asarray(idx, np.int32), P.astype(np.float32)


def interior_rays():
    """tests/test_grad.py:345-355: 256 rays along +z through an
    asymmetric grid of the sphere's interior."""
    gx, gy = np.meshgrid(np.linspace(0.08, 0.42, 16),
                         np.linspace(-0.3, 0.3, 16))
    o = torch.from_numpy(np.stack([gx.ravel(), gy.ravel(),
                                   np.full(256, -3.0)], -1).astype(
                                       np.float32))
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(256, 1)
    return o, d, torch.full((256,), 1e-3), torch.full((256,), 1e30)


def t_sum_case(moved, eps=1e-3):
    """d/d dx of the sum of interior rays' nearest t, on the rays whose hit
    is stable across the stencil (tests/test_grad.py:357-380): the
    winners come from tables built before the move (static accelerator,
    moving geometry)."""
    rays = interior_rays()

    def raw(dx):
        t, _, hit = isect.intersect_ids(moved(dx), *rays)
        return t, hit & (t < 1e6)
    with torch.no_grad():
        mask = raw(-eps)[1] & raw(0.0)[1] & raw(eps)[1]
    assert int(mask.sum()) > 200, int(mask.sum())

    def loss(dx):
        t, ok = raw(dx)
        return torch.where(mask & ok, t, 0.0).sum()
    dx = torch.zeros((), requires_grad=True)
    loss(dx).backward()
    g = float(dx.grad)
    assert np.isfinite(g)
    fd = central_fd(loss, eps)
    assert abs(fd) > 1e-3, fd
    return g, fd, 0.02 * abs(fd)


def mesh_scene(accel):
    b = SceneBuilder()
    b.accel_kind = accel
    idx, P = uv_sphere() if accel == "bvh" else (
        np.asarray([[0, 1, 2], [0, 2, 3]], np.int32),
        # A tilted quad in front of the rays: t depends on x.
        np.asarray([[-1, -1, -0.3], [1, -1, 0.3], [1, 1, 0.3],
                    [-1, 1, -0.3]], np.float32))
    b.add_trianglemesh(np.eye(4, dtype=np.float32), idx, P,
                       material=b.matte())
    b.add_point_light(np.asarray(tf.translate([2.0, 2.0, -3.0])))
    return b.build()


def bvh_case():
    scene = mesh_scene("bvh")
    assert isinstance(scene.accel, BvhAccel) and \
        scene.triangles.count == 5040

    def moved(dx):
        return dataclasses.replace(scene, triangles=dataclasses.replace(
            scene.triangles, verts=scene.triangles.verts +
            torch.tensor([1.0, 0.0, 0.0]) * dx))
    return t_sum_case(moved)


def brute_case():
    """The brute force on a scene holding render()'s packed table: the
    kernel's winners come from it, t from the triangle table's vertices."""
    scene = mesh_scene("none")
    assert scene.accel is None
    scene = dataclasses.replace(scene, tris_packed=mt_cuda.pack_table(
        scene.triangles))

    def moved(dx):
        return dataclasses.replace(scene, triangles=dataclasses.replace(
            scene.triangles, verts=scene.triangles.verts +
            torch.tensor([1.0, 0.0, 0.0]) * dx))
    return t_sum_case(moved)


def instance_case():
    """An instance of the tilted quad moved by dx along x:
    instances.recompute_t over its world vertices (tpuprt/accel/
    instances.py:181-204)."""
    b = SceneBuilder()
    b.add_sphere(np.asarray(tf.translate([0.0, 0.0, 40.0])), 0.1,
                 material=b.matte())
    idx, P = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32), np.asarray(
        [[-1, -1, -0.3], [1, -1, 0.3], [1, 1, 0.3], [-1, 1, -0.3]],
        np.float32)
    proto = b.add_prototype(idx, P, material=b.matte())
    b.add_instance(proto, np.asarray(tf.translate([0.0, 0.0, 0.5])))
    b.add_point_light(np.asarray(tf.translate([2.0, 2.0, -3.0])))
    scene = b.build()
    inst = scene.instances
    assert inst is not None and inst.count == 1

    def moved(dx):
        o2w, w2o = inst.inst_o2w.clone(), inst.inst_w2o.clone()
        o2w[:, 0, 3] = o2w[:, 0, 3] + dx
        w2o[:, 0, 3] = w2o[:, 0, 3] - dx
        return dataclasses.replace(scene, instances=dataclasses.replace(
            inst, inst_o2w=o2w, inst_w2o=w2o))
    return t_sum_case(moved)


def test_kernel_wrappers_are_not_differentiable():
    """mt_best and the three walks under autograd: outputs that carry no
    gradient, inputs that get none (NonDiff's backward)."""
    rng = np.random.default_rng(0)
    rays = torch.from_numpy(np.concatenate([
        rng.uniform(-0.5, 0.5, (3, 64)), np.tile([[0.0], [0.0], [1.0]],
                                                  (1, 64)),
        np.full((1, 64), -5.0), np.full((1, 64), 1e30)]).astype(
            np.float32)).requires_grad_(True)
    scene = mesh_scene("none")
    tris = mt_cuda.pack_table(scene.triangles).requires_grad_(True)
    bvh = mesh_scene("bvh").accel
    calls = [mt_cuda.mt_best(rays, tris), mt_cuda.mt_best(rays, tris, True),
             bvh_cuda.traverse_rows(bvh.nodes, rays, nn=bvh.n_nodes,
                                    max_depth=bvh.max_depth)]
    if bvh.nodesT is not None:
        calls.append(bvh_cuda.traverse_tiles(
            bvh.nodesT, bvh.nodeskip, bvh.nodemeta, bvh.child, rays,
            nn=bvh.n_nodes))
    for out in calls:
        assert all(not x.requires_grad for x in out)
    assert (calls[0][1] >= 0).sum() > 0
    # The generic wrapper: its backward gives every input None.
    x = torch.ones(3, requires_grad=True)
    y, = bvh_cuda.nondiff(lambda v: (v * 2.0,))(x)
    assert not y.requires_grad
    assert bvh_cuda.NonDiff.backward(
        type("Ctx", (), {"n_args": 1})(), torch.ones(3)) == (None,) * 3
    # The front end: t differentiable in the rays through the recompute,
    # the packed table untouched.
    o = rays[0:3].T.detach().clone().requires_grad_(True)
    t, ids, hit = mt_cuda.intersect_packed(
        tris, (scene.world_bound_lo, scene.world_bound_hi), o,
        rays[3:6].T.detach(), rays[6].detach(), rays[7].detach())
    t[hit].sum().backward()
    assert o.grad is not None and torch.isfinite(o.grad).all() and \
        o.grad[:, 0].abs().sum() > 0 and tris.grad is not None
    assert rays.grad is None


@pytest.mark.parametrize("fn", [render_loss_fn, sample_losses],
                         ids=["render_loss_fn", "sample_losses"])
def test_loss_runs_on_the_card_unless_asked(fn, monkeypatch):
    """The loss, like render(), runs on the card unless the caller asks
    for the CPU: without a CUDA device a call that does not pass
    device="cpu" raises; the CPU's gradient reaches the caller's tables."""
    scene = sphere_scene(SceneBuilder, cam, tf)
    opts = options(R, SamplerConfig)
    t = [torch.from_numpy(x) for x in batch()]
    target = torch.zeros(RES, RES, 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(scene, opts, *t, target)
    loss, sc = autograd(scene, lambda s: fn(s, opts, *t, target,
                                            device="cpu").sum())
    assert loss > 0 and sc.textures.fparams.grad.abs().sum() > 0


def test_adam_recovers_albedo():
    """tests/test_fixes.py:143: 24x24 Whitted, 1 spp, 80 Adam steps at lr
    0.05 from a wrong albedo; the loss falls below 5% of the first, the
    albedo within 0.05 of the truth."""
    def build(albedo):
        b = SceneBuilder()
        mat = b.matte(kd=albedo)
        b.add_sphere(np.asarray(tf.translate([0, 0, 2.0])), 0.6,
                     material=mat)
        b.add_point_light(np.asarray(tf.translate([2, 3, -1])), (12.0,) * 3)
        b.set_camera(cam.build_projective(
            0, np.eye(4, dtype=np.float32),
            np.asarray(tf.perspective(45.0, 1e-2, 100.0)),
            cam.default_screen_window(24, 24), 24, 24))
        return b.build()
    opts = R.RenderOptions(xres=24, yres=24, integrator="whitted",
                           sampler=SamplerConfig(kind="lowdiscrepancy",
                                                 pixelsamples=1),
                           chunk_size=24 * 24)
    true_albedo = (0.8, 0.3, 0.5)
    target = torch.from_numpy(R.render(build(true_albedo), opts,
                                       device="cpu")[0])
    scene = build((0.4, 0.6, 0.2))
    fp = scene.textures.fparams.clone().requires_grad_(True)
    t = [torch.from_numpy(x) for x in batch(24)]
    adam = torch.optim.Adam([fp], lr=0.05)
    losses = []
    for _ in range(80):
        adam.zero_grad()
        loss = render_loss_fn(dataclasses.replace(
            scene, textures=dataclasses.replace(scene.textures, fparams=fp)),
            opts, *t, target, device="cpu")
        loss.backward()
        assert torch.isfinite(fp.grad).all()
        adam.step()
        losses.append(loss.item())
    assert losses[-1] < 0.05 * losses[0], losses
    np.testing.assert_allclose(fp.detach()[0, 0:3].numpy(), true_albedo,
                               atol=0.05)
