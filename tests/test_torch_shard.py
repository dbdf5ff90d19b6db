"""The several-device layer of the port (tpuprt_torch/parallel/shard.py and
multihost.py) over torch.distributed's gloo backend on the CPU.

- Two ranks, spawned processes of one thread each, render the 16x16
  Whitted sphere of tests/multihost_worker.py (with the box filter the
  port has) with render_sharded and
  render_multihost (several global chunks): both equal the port's
  single-process render_chunked within 1e-5, and tpuprt's render_sharded
  over a 2-device mesh of conftest's 8 virtual CPUs within the per-sample
  rule of the port's files (2e-4).
- train_step_sharded on a world of 1 against tpuprt's on a 1-device mesh,
  with and without the boundary terms (the occluder quad of
  test_torch_silhouette.py under the debug integrator's t, one and hit
  channels: an interior gradient in the vertices and the camera, and a
  boundary one at the quad's silhouette): the loss and every float
  table's gradient within rtol 1e-5.
- Two ranks against one, boundary on (each rank takes its block of the
  edge samples): the loss and the gradients within 1e-5 relative, on
  that scene and on the point-light shadow scene. The
  divergence named: over make_mesh(2), tpuprt's gradient (JAX 0.9.0) is
  2x its 1-device one in the interior and 4x in the boundary term, its
  loss right: inside shard_map, the gradient of each device's loss w.r.t.
  the replicated scene is already summed over the devices, and the pmean
  after it does not divide it back (D x); the boundary weight spp / n
  takes the shard's n (D x more, silhouette.py:605-609).
- Entry points raise without CUDA unless they are given the CPU.
"""
import os
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from test_torch_silhouette import (batch, floor_scene, moved,
                                   occluder_scene, options)
from tpuprt_torch import render as R
from tpuprt_torch.cameras import cameras as cam
from tpuprt_torch.parallel import multihost, shard
from tpuprt_torch.samplers.samplers import SamplerConfig
from tpuprt_torch.scene.build import SceneBuilder
from tpuprt_torch.scene.parser import load_scene_string

torch.set_num_threads(1)
CHANNELS = ("t", "one", "hit")
CHUNK = 96               # lanes a rank a chunk: 3 global chunks of 2 ranks
SCENE = """
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Camera "perspective" "float fov" [60]
Sampler "lowdiscrepancy" "integer pixelsamples" [1]
PixelFilter "box" "float xwidth" [0.5] "float ywidth" [0.5]
SurfaceIntegrator "whitted"
WorldBegin
LightSource "point" "point from" [1 2 -2] "color I" [12 12 12]
Material "matte" "color Kd" [0.7 0.3 0.2]
Translate 0 0 3
Shape "sphere" "float radius" [1]
WorldEnd
"""


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def train_cases():
    """name -> (scene, opts, target, ids, boundary's seed, moved rows): the
    debug occluder (its target from cx = 0.2) and the point-light shadow
    scene (from cx = 0.25)."""
    out = {}
    for name, make, rows, integ, cx, seed in (
            ("occluder", occluder_scene, None, "debug", 0.2, 3),
            ("shadow", floor_scene, [4, 5, 6, 7], "directlighting", 0.25,
             5)):
        opts = options(R, SamplerConfig, integ, 1)._replace(
            debug_channels=CHANNELS)
        scene = make(SceneBuilder, cam)
        target = torch.from_numpy(R.render(
            moved(scene, cx, rows, False), opts._replace(driver="scan"),
            device="cpu")[0])
        out[name] = (scene, opts, target, [torch.from_numpy(a)
                                           for a in batch(1)], seed, rows)
    return out


def train_step(case, mesh, boundary=True):
    """(loss, {table.field: gradient} of the nonzero float tables)."""
    scene, opts, target, ids, seed, _ = case
    loss, g = shard.train_step_sharded(scene, opts, target, *ids, mesh,
                                       boundary=boundary,
                                       n_edge_samples=256, seed=seed)
    grads = {}
    for table in ("triangles", "camera", "lights", "quadrics"):
        for k, v in vars(getattr(g, table)).items():
            if isinstance(v, torch.Tensor) and v.is_floating_point() and \
                    v.numel() and bool(v.abs().max() > 0):
                grads[f"{table}.{k}"] = v.numpy()
    return float(loss), grads


def rank_main(rank, world, port, out):
    """One rank of the spawned world: the renders and the train steps,
    saved by every rank to out-{rank}.npz."""
    torch.set_num_threads(1)
    mesh = multihost.init_distributed(f"localhost:{port}", world, rank,
                                      device="cpu")
    assert (mesh.rank, mesh.size, mesh.device.type) == (rank, world, "cpu")
    scene, opts = load_scene_string(SCENE)
    opts = opts._replace(chunk_size=CHUNK)
    res = {}
    res["sharded_rgb"], res["sharded_alpha"] = shard.render_sharded(
        scene, opts, mesh)
    res["multihost_rgb"], res["multihost_alpha"] = \
        multihost.render_multihost(scene, opts, mesh)
    for name, case in train_cases().items():
        loss, grads = train_step(case, mesh)
        res[f"{name}/loss"] = loss
        res.update({f"{name}/{k}": v for k, v in grads.items()})
    np.savez(f"{out}-{rank}.npz", **res)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' results, each rank a spawned process of one thread."""
    out = str(tmp_path_factory.mktemp("ranks") / "out")
    ctx = mp.get_context("spawn")
    port = free_port()
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        procs = [ctx.Process(target=rank_main, args=(r, 2, port, out))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=300)
    finally:
        if old is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = old
    for p in procs:
        if p.is_alive():
            p.kill()
        assert p.exitcode == 0, p.exitcode
    return [dict(np.load(f"{out}-{r}.npz")) for r in range(2)]


@pytest.fixture(scope="module")
def world_of_one():
    """A gloo world of this process alone, for the one-rank steps."""
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    yield shard.make_mesh(device="cpu")
    dist.destroy_process_group()


@pytest.mark.parametrize("entry", ["sharded", "multihost"])
def test_two_rank_render_matches_render_chunked(two_ranks, entry):
    scene, opts = load_scene_string(SCENE)
    rgb, alpha = R.render_chunked(R.on_device(scene, "cpu"), opts, "cpu")
    for res in two_ranks:
        np.testing.assert_allclose(res[f"{entry}_rgb"], rgb, atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(res[f"{entry}_alpha"], alpha, atol=1e-5)
    assert rgb.max() > 0.1 and alpha.min() == 0.0


def test_two_rank_render_matches_tpuprt_render_sharded(two_ranks):
    from tpuprt.parallel import shard as jshard
    from tpuprt.scene.parser import load_scene_string as jax_load
    jscene, jopts = jax_load(SCENE)
    rgb, alpha = jshard.render_sharded(
        jscene, jopts._replace(chunk_size=CHUNK), jshard.make_mesh(2))
    np.testing.assert_allclose(two_ranks[0]["sharded_rgb"], rgb, atol=2e-4,
                               rtol=2e-4)
    np.testing.assert_allclose(two_ranks[0]["sharded_alpha"], alpha,
                               atol=1e-5)


@pytest.fixture(scope="module")
def tpuprt_steps():
    """tpuprt's train_step_sharded on the debug occluder: {(devices,
    boundary): (loss, {table.field: gradient})}."""
    import jax.numpy as jnp
    from tpuprt import render as jax_render
    from tpuprt.cameras import cameras as jcam
    from tpuprt.diff.silhouette import mesh_edges
    from tpuprt.parallel import shard as jshard
    from tpuprt.samplers.samplers import SamplerConfig as JaxSampler
    from tpuprt.scene.build import SceneBuilder as JaxBuilder
    _, _, target, ids, seed, _ = train_cases()["occluder"]
    jscene = occluder_scene(JaxBuilder, jcam)
    jopts = options(jax_render, JaxSampler, "debug", 1)._replace(
        debug_channels=CHANNELS)
    topo = mesh_edges(np.asarray(jscene.triangles.idx))
    out = {}
    for ndev, boundary in ((1, False), (1, True), (2, True)):
        loss, g = jshard.train_step_sharded(
            jscene, jopts, jnp.asarray(target.numpy()),
            *(jnp.asarray(a.numpy()) for a in ids), jshard.make_mesh(ndev),
            boundary=boundary, topology=topo, n_edge_samples=256,
            seed=seed)
        grads = {}
        for table in ("triangles", "camera", "lights", "quadrics"):
            for k, v in vars(getattr(g, table)).items():
                v = None if v is None else np.asarray(v)
                if v is not None and v.dtype.kind == "f" and v.size and \
                        np.abs(v).max() > 0:
                    grads[f"{table}.{k}"] = v
        out[ndev, boundary] = (float(loss), grads)
    return out


@pytest.mark.parametrize("boundary", [False, True],
                         ids=["interior", "boundary"])
def test_train_step_matches_tpuprt(world_of_one, tpuprt_steps, boundary):
    loss, grads = train_step(train_cases()["occluder"], world_of_one,
                             boundary)
    jloss, jgrads = tpuprt_steps[1, boundary]
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    # The camera's clip distances are tpuprt leaves, the port's floats.
    assert set(jgrads) - set(grads) <= {"camera.cliphither",
                                        "camera.clipyon"}
    assert set(grads) <= set(jgrads) and "triangles.verts" in grads
    for k in grads:
        np.testing.assert_allclose(grads[k], jgrads[k], rtol=1e-5,
                                   atol=1e-5 * np.abs(jgrads[k]).max(),
                                   err_msg=k)


@pytest.mark.parametrize("name", ["occluder", "shadow"])
def test_two_ranks_equal_one(world_of_one, two_ranks, name):
    loss, grads = train_step(train_cases()[name], world_of_one)
    assert abs(grads["triangles.verts"][:, 0].sum()) > 1e-3
    for res in two_ranks:
        np.testing.assert_allclose(res[f"{name}/loss"], loss, rtol=1e-5)
        for k, g in grads.items():
            np.testing.assert_allclose(res[f"{name}/{k}"], g, rtol=1e-5,
                                       atol=1e-5 * np.abs(g).max(),
                                       err_msg=k)


def test_tpuprt_two_device_gradient_divergence(tpuprt_steps):
    """The divergence named: tpuprt's gradient over 2 devices is 2x the
    1-device interior plus 4x the 1-device boundary term; the port's 2
    ranks equal its 1 (above)."""
    (l1, interior), (_, one), (l2, two) = (
        tpuprt_steps[k] for k in ((1, False), (1, True), (2, True)))
    assert l2 == pytest.approx(l1, rel=1e-6)
    a, b, c = (g["triangles.verts"] for g in (interior, one, two))
    assert np.abs(a).max() > 1e-2 and np.abs(b - a).max() > 1e-2
    np.testing.assert_allclose(c, 2.0 * a + 4.0 * (b - a), rtol=1e-5,
                               atol=1e-6)


def test_entry_points_need_cuda_unless_given_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene, opts = load_scene_string(SCENE)
    ids = [torch.from_numpy(a) for a in batch(1)]
    calls = [lambda: shard.make_mesh(),
             lambda: multihost.global_mesh(),
             lambda: multihost.init_distributed("localhost:1", 1, 0),
             lambda: shard.render_sharded(scene, opts),
             lambda: multihost.render_multihost(scene, opts),
             lambda: shard.train_step_sharded(scene, opts,
                                              torch.zeros(16, 16, 3), *ids),
             lambda: multihost.train_step_multihost(scene, opts,
                                                    torch.zeros(16, 16, 3))]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    mesh = shard.Mesh(torch.device("cuda", 0), 0, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard.render_sharded(scene, opts, mesh)
