"""The boundary gradients of the port (tpuprt_torch/diff/silhouette.py) held
against tpuprt's on the CPU, on 16x16 analogues of tests/test_grad.py's
four finite-difference scenes: a dark quad before an infinite light (the
primary term), a quad out of frame shadowing a floor from a point light
and from a distant light (the delta-light shadow term's two branches) and
from a quad area light (area shadow), and a dark sphere before an
infinite light (the rim).

- core/jrandom against jax.random bit for bit on every call the estimators
  make.
- mesh_edges equal.
- Each surrogate's value and its gradient in the scene's translation
  against jax.grad of tpuprt's (rtol 1e-5), and per sample: the side rays'
  raster positions and radiances, caught in both packages' _radiance_at,
  agree on every lane (positions within 1e-4 px, radiance within atol =
  rtol = 1e-5); a mismatch would be allowed only where a side ray lands
  on a graze or a tie, and none does here. tpuprt's side runs jitted: one
  XLA compile of its surrogate costs less than its ops one by one.
- Split over ranks (part=(rank, size)): the blocks' shares of each term
  sum to the whole term, value and gradient, and each case's term has
  live lanes.
- render_loss_with_silhouette against tpuprt's, value and gradient.
- A divergence named: with the area light's triangles turned around
  (ReverseOrientation, so the emitting side still faces the floor),
  tpuprt's area term tests emission against the unflipped normal and
  gives 0 (tpuprt/diff/silhouette.py:525); the port's agrees in sign with
  its own central difference of the loss.
- The interior gradient of the quad-area-light scene is finite, where
  tpuprt's is NaN (its pdf_area_from_hit's backward on lanes whose
  BSDF-strategy ray missed the light).
- Masked lanes give finite gradients: a lane whose curve position is
  infinite, masked out, leaves the gradient finite here and NaN in
  tpuprt's tail (0 * inf in its backward).
- The loss runs on the card unless asked for the CPU.

The rank blocks and the finite-gradient checks are in
test_torch_silhouette_ranks.py, the jrandom streams in
test_torch_silhouette_jrandom.py (no file holds more than ten cases).
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tpuprt import render as jax_render
from tpuprt.cameras import cameras as jcam
from tpuprt.core import transform as jtf
from tpuprt.diff import silhouette as jsil
from tpuprt.samplers.samplers import SamplerConfig as JaxSampler
from tpuprt.scene.build import SceneBuilder as JaxBuilder
from tpuprt_torch import render as R
from tpuprt_torch.cameras import cameras as cam
from tpuprt_torch.diff import silhouette as sil
from tpuprt_torch.parallel.shard import render_loss_fn
from tpuprt_torch.samplers.samplers import SamplerConfig
from tpuprt_torch.scene.build import SceneBuilder

torch.set_num_threads(1)
RES = 16
RTOL = 1e-5


def test_mesh_edges_equal():
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 40, (60, 3)).astype(np.int32)
    for a, b in zip(sil.mesh_edges(idx), jsil.mesh_edges(idx)):
        np.testing.assert_array_equal(a, b)


def look(builder_cam, b, eye, at, fov):
    c2w = np.asarray(jtf.look_at(eye, at, [0, 1, 0]))
    b.set_camera(builder_cam.build_projective(
        0, c2w, np.asarray(jtf.perspective(fov, 1e-2, 100.0)),
        builder_cam.default_screen_window(RES, RES), RES, RES))


def occluder_scene(B, C):
    """tests/test_grad.py:129-152: a black quad tilted 15 degrees in its
    plane before a white infinite light."""
    b = B()
    dark = b.matte(kd=(0.0, 0.0, 0.0))
    c15, s15 = np.cos(0.26), np.sin(0.26)
    sq = np.asarray([[-0.6, -0.6], [0.6, -0.6], [0.6, 0.6], [-0.6, 0.6]],
                    np.float32)
    rot = sq @ np.asarray([[c15, s15], [-s15, c15]], np.float32)
    quad = np.concatenate([rot, np.ones((4, 1), np.float32)], axis=1)
    b.add_trianglemesh(np.eye(4), [[0, 1, 2], [0, 2, 3]], quad,
                       material=dark)
    b.add_infinite_light(np.eye(4), L=(1.0, 1.0, 1.0))
    look(C, b, [0, 0, -4], [0, 0, 0], 45.0)
    return b.build()


def floor_scene(B, C, light="point", flip=False):
    """tests/test_grad.py:382-421: a floor seen obliquely, a quad out of
    frame between it and a point light, a distant light from above it or
    a quad area light (flip: its triangles wound the other way with
    ReverseOrientation, emitting to the same side)."""
    b = B()
    fl = b.matte(kd=(0.7, 0.7, 0.7))
    dark = b.matte(kd=(0.2, 0.2, 0.2))
    floor = np.asarray([[-3, 0, -3], [3, 0, -3], [3, 0, 3], [-3, 0, 3]],
                       np.float32)
    b.add_trianglemesh(np.eye(4), [[0, 1, 2], [0, 2, 3]], floor,
                       material=fl)
    quad = np.asarray([[-0.5, 1.5, -0.5], [0.5, 1.5, -0.5],
                       [0.5, 1.5, 0.5], [-0.5, 1.5, 0.5]], np.float32)
    b.add_trianglemesh(np.eye(4), [[0, 1, 2], [0, 2, 3]], quad,
                       material=dark)
    if light == "point":
        b.add_point_light(np.asarray(jtf.translate([0.0, 4.0, 0.0])),
                          intensity=(25.0,) * 3)
    elif light == "distant":
        # Declared under a translation: both packages end a distant light's
        # shadow ray at |light origin - p| (lights.py), so the origin sits
        # beyond the occluder.
        b.add_distant_light(np.asarray(jtf.translate([0.0, 10.0, 0.0])),
                            L=(3.0,) * 3, frm=(0.3, 4.0, 0.2),
                            to=(0.0, 0.0, 0.0))
    else:
        lq = np.asarray([[-0.6, 4.0, -0.6], [0.6, 4.0, -0.6],
                         [0.6, 4.0, 0.6], [-0.6, 4.0, 0.6]], np.float32)
        idx = [[0, 2, 1], [0, 3, 2]] if flip else [[0, 1, 2], [0, 2, 3]]
        lid = b.add_trianglemesh(np.eye(4), idx, lq, material=dark,
                                 reverse_orientation=flip)
        b.add_area_light_mesh(lid, L=(14.0,) * 3)
    look(C, b, [0, 0.8, -2.8], [0, 0, 0.3], 32.0)
    return b.build()


def sphere_scene(B, C):
    """tests/test_grad.py:478-492: a black sphere of radius 0.8 before a
    white infinite light."""
    b = B()
    b.add_sphere(np.eye(4), 0.8, material=b.matte(kd=(0.0, 0.0, 0.0)))
    b.add_infinite_light(np.eye(4), L=(1.0, 1.0, 1.0))
    look(C, b, [0, 0, -4], [0, 0, 0], 45.0)
    return b.build()


def moved(scene, cx, rows, jaxside):
    """The scene translated by cx along x: the vertex rows `rows` (all
    when None), or the first quadric's transforms when rows == "sphere"."""
    if rows == "sphere":
        q = scene.quadrics
        if jaxside:
            o2w, w2o = q.o2w.at[0, 0, 3].add(cx), q.w2o.at[0, 0, 3].add(-cx)
        else:
            o2w, w2o = q.o2w.clone(), q.w2o.clone()
            o2w[0, 0, 3] = o2w[0, 0, 3] + cx
            w2o[0, 0, 3] = w2o[0, 0, 3] - cx
        return dataclasses.replace(scene, quadrics=dataclasses.replace(
            q, o2w=o2w, w2o=w2o))
    v = scene.triangles.verts
    m = np.zeros(tuple(v.shape), np.float32)
    m[slice(None) if rows is None else rows, 0] = 1.0
    v = v + (jnp.asarray(m) if jaxside else torch.from_numpy(m)) * cx
    return dataclasses.replace(scene, triangles=dataclasses.replace(
        scene.triangles, verts=v))


def options(module, sampler, integrator, spp):
    cfg = sampler(kind="stratified", xsamples=1, ysamples=1,
                  jitter=False) if spp == 1 else \
        sampler(kind="lowdiscrepancy", pixelsamples=spp)
    return module.RenderOptions(
        xres=RES, yres=RES, sampler=cfg, filter_kind="box",
        filter_xwidth=0.5, filter_ywidth=0.5, integrator=integrator,
        max_depth=0, chunk_size=RES * RES * spp)


def batch(spp):
    lin = np.arange(RES * RES * spp)
    return ((lin // spp % RES).astype(np.int32),
            (lin // spp // RES).astype(np.int32),
            (lin % spp).astype(np.int32))


# name: (scene, its kwargs, integrator, spp, target's cx, moved rows,
# surrogate, samples, seed); tests/test_grad.py's seeds.
CASES = {
    "primary": (occluder_scene, {}, "whitted", 4, 0.2, None,
                "silhouette_surrogate", 256, 3),
    "shadow": (floor_scene, {}, "directlighting", 1, 0.25, [4, 5, 6, 7],
               "shadow_silhouette_surrogate", 256, 5),
    "distant": (floor_scene, {"light": "distant"}, "directlighting", 1,
                0.25, [4, 5, 6, 7], "shadow_silhouette_surrogate", 256, 5),
    "area": (floor_scene, {"light": "area"}, "directlighting", 4, 0.25,
             [4, 5, 6, 7], "area_shadow_surrogate", 2048, 5),
    "rim": (sphere_scene, {}, "whitted", 1, 0.15, "sphere",
            "sphere_rim_surrogate", 256, 7),
}


def loss_fns(target, spp, module):
    """(jump_fn, adjoint_fn) of the mean-L2 sample loss, as
    render_loss_with_silhouette builds them, for either package."""
    w = spp / (RES * RES * spp)
    at = (lambda T, x, y: T[y, x]) if module is jnp else \
        (lambda T, x, y: T[y.long(), x.long()])

    def jump(L_m, L_p, px, py):
        T = at(target, px, py)
        return (((L_m - T) ** 2).sum(-1) - ((L_p - T) ** 2).sum(-1)) * w

    def adjoint(px, py, I):
        return 2.0 * (I - at(target, px, py)) * w
    return jump, adjoint


def caught(module, name, store, jaxside):
    """A stand-in for module._radiance_at that records each call's (x, y,
    L) in `store`, inside tpuprt's jit by an ordered debug callback."""
    real = getattr(module, name)

    def spy(scene, opts, x, y):
        L = real(scene, opts, x, y)
        if jaxside:
            jax.debug.callback(lambda *a: store.append(
                [np.asarray(v) for v in a]), x, y, L, ordered=True)
        else:
            store.append([v.detach().numpy() for v in (x, y, L)])
        return L
    return spy


@pytest.fixture(scope="module")
def results():
    """Each case computed once, in both packages, on demand."""
    cache = {}

    def get(name, **scene_kw):
        key = (name, tuple(sorted(scene_kw.items())))
        if key not in cache:
            cache[key] = surrogate_case(name, **scene_kw)
        return cache[key]
    return get


_JITTED = {}


def surrogate_case(name, **scene_kw):
    make, kw, integ, spp, cx_t, rows, fn, n, seed = CASES[name]
    kw = dict(kw, **scene_kw)
    opts = options(R, SamplerConfig, integ, spp)
    jopts = options(jax_render, JaxSampler, integ, spp)
    target = torch.from_numpy(R.render(
        moved(make(SceneBuilder, cam, **kw), cx_t, rows, False),
        opts._replace(driver="scan"), device="cpu")[0])
    tscene = make(SceneBuilder, cam, **kw)
    jscene = make(JaxBuilder, jcam, **kw)
    topo = {} if rows == "sphere" else {
        "topology": jsil.mesh_edges(np.asarray(jscene.triangles.idx))}
    tfns = loss_fns(target, spp, torch)
    pick = 1 if name == "area" else 0

    jstore, tstore = [], []
    mp = pytest.MonkeyPatch()
    mp.setattr(jsil, "_radiance_at", caught(jsil, "_radiance_at", jstore,
                                            True))
    mp.setattr(sil, "_radiance_at", caught(sil, "_radiance_at", tstore,
                                           False))
    try:
        # The scene and the target are arguments: the flipped area light
        # (the same shapes and edges) reuses the unflipped one's compile.
        if name not in _JITTED:
            _JITTED[name] = jax.jit(jax.value_and_grad(
                lambda c, sc, T: getattr(jsil, fn)(
                    moved(sc, c, rows, True), jopts,
                    loss_fns(T, spp, jnp)[pick], n, seed, **topo)))
        jv, jg = _JITTED[name](0.0, jscene, jnp.asarray(target.numpy()))
        jax.effects_barrier()
        cx = torch.zeros((), requires_grad=True)
        tv = getattr(sil, fn)(moved(tscene, cx, rows, False), opts,
                              tfns[pick], n, seed)
        tv.backward()
    finally:
        mp.undo()
    return dict(jv=float(jv), jg=float(jg), tv=float(tv),
                tg=float(cx.grad), jstore=jstore, tstore=tstore,
                opts=opts, scene=tscene, target=target, rows=rows,
                n=n, seed=seed, spp=spp)


@pytest.mark.parametrize("name", list(CASES))
def test_surrogate_matches_tpuprt(results, name):
    r = results(name)
    assert np.isfinite(r["tg"]) and abs(r["jg"]) > 1e-3, r
    np.testing.assert_allclose(r["tv"], r["jv"], rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(r["tg"], r["jg"], rtol=RTOL)
    # Per sample: the side rays (or the area term's pixel rays), lane by
    # lane.
    assert len(r["tstore"]) == len(r["jstore"]) > 0
    for (tx, ty, tL), (jx, jy, jL) in zip(r["tstore"], r["jstore"]):
        # Where a lane can be live: a half pixel about the film (masked
        # lanes may sit anywhere: at 1e31 or NaN for a receiver missed).
        near = (np.abs(jx - RES / 2) <= RES / 2 + 1) & \
            (np.abs(jy - RES / 2) <= RES / 2 + 1)
        assert near.sum() > 0
        for t, j in ((tx, jx), (ty, jy)):
            np.testing.assert_allclose(t[near], j[near], atol=1e-4, rtol=0)
        np.testing.assert_allclose(tL[near], jL[near], atol=RTOL,
                                   rtol=RTOL)


TERM_OF = {"silhouette_surrogate": "primary", "sphere_rim_surrogate": "rim",
           "shadow_silhouette_surrogate": "shadow",
           "area_shadow_surrogate": "area"}


def test_render_loss_with_silhouette_matches_tpuprt():
    """The occluder scene's loss with every term (the primary one acts;
    the others find no light or quadric of theirs) and the interior, value
    and gradient in the quad's translation."""
    make, kw, integ, spp, cx_t, rows, _, _, seed = CASES["primary"]
    opts = options(R, SamplerConfig, integ, spp)
    jopts = options(jax_render, JaxSampler, integ, spp)
    target = R.render(moved(make(SceneBuilder, cam), cx_t, rows, False),
                      opts._replace(driver="scan"), device="cpu")[0]
    ids = batch(spp)
    jscene = make(JaxBuilder, jcam)
    topo = jsil.mesh_edges(np.asarray(jscene.triangles.idx))
    jv, jg = jax.jit(jax.value_and_grad(
        lambda c: jsil.render_loss_with_silhouette(
            moved(jscene, c, rows, True), jopts,
            *(jnp.asarray(a) for a in ids), jnp.asarray(target),
            n_edge_samples=256, seed=seed, topology=topo)))(0.0)
    cx = torch.zeros((), requires_grad=True)
    tv = sil.render_loss_with_silhouette(
        moved(make(SceneBuilder, cam), cx, rows, False), opts,
        *(torch.from_numpy(a) for a in ids), torch.from_numpy(target),
        n_edge_samples=256, seed=seed, device="cpu")
    tv.backward()
    np.testing.assert_allclose(float(tv), float(jv), rtol=RTOL)
    np.testing.assert_allclose(float(cx.grad), float(jg), rtol=RTOL)
    assert float(cx.grad) < -1e-2      # toward the target, all boundary


def test_flipped_area_light_divergence(results):
    """tpuprt's area term ignores flip_normal (silhouette.py:525): with the
    emitter's triangles turned around and ReverseOrientation, the floor is
    lit exactly as before, tpuprt's term is 0, and the port's agrees in
    sign with the central difference of its loss (the boundary term is
    all of the gradient: the quad is out of frame)."""
    r = results("area", flip=True)
    assert r["jg"] == 0.0 and r["jv"] == 0.0
    ids = [torch.from_numpy(a) for a in batch(r["spp"])]

    def loss(e):
        return float(render_loss_fn(moved(r["scene"], e, r["rows"], False),
                                    r["opts"], *ids, r["target"],
                                    device="cpu"))
    fd = (loss(0.05) - loss(-0.05)) / 0.1
    assert fd < -1e-3 and r["tg"] < -1e-3, (fd, r["tg"])
    # The unflipped light's term, within test_grad.py's 25% for the area
    # term: the NEE samples on the turned triangles differ, and with them
    # the image and its adjoint.
    same = results("area")
    np.testing.assert_allclose(r["tg"], same["tg"], rtol=0.25)


def test_loss_runs_on_the_card_unless_asked(monkeypatch):
    scene = occluder_scene(SceneBuilder, cam)
    opts = options(R, SamplerConfig, "whitted", 1)
    ids = [torch.from_numpy(a) for a in batch(1)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sil.render_loss_with_silhouette(scene, opts, *ids,
                                        torch.zeros(RES, RES, 3))
