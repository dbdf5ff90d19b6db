"""The port's operability held against tpuprt's on the CPU: the stats
registry and the progress bar (tests/test_operability.py:38-60, ported),
tpuprt's counters from a tiny pool render and a tiny chunked render of the
same text and seed, the tone maps and the imaging pipeline, the
best-candidate table generator, and ``python -m tpuprt_torch``'s main()
end to end with --device cpu: its EXR, --spp on a stratified sampler,
--checkpoint and --resume, and its refusal to run without a card unless
asked for the CPU. tpuprt's pool is compiled once (a one-lobe matte
scene), its chunked driver once.
"""
import contextlib
import io
import os

import numpy as np
import pytest
import torch

from tpuprt import render as jax_render
from tpuprt.samplers import bc_gen as jbc
from tpuprt.scene.parser import load_scene_string as jax_load
from tpuprt.tonemaps import tonemaps as jtm
from tpuprt.utils.stats import StatsRegistry as JaxStats
from tpuprt_torch import cli
from tpuprt_torch import render as torch_render
from tpuprt_torch.film import film as tfilm
from tpuprt_torch.io.exr import read_exr, write_exr
from tpuprt_torch.samplers import bc_gen as tbc
from tpuprt_torch.scene.parser import load_scene, load_scene_string
from tpuprt_torch.tonemaps import tonemaps as ttm
from tpuprt_torch.utils.progress import ProgressReporter
from tpuprt_torch.utils.stats import StatsRegistry, _suffixed

torch.set_num_threads(1)

SCENE = """
Film "image" "integer xresolution" [16] "integer yresolution" [12]
    "string filename" ["out.exr"]
Camera "perspective" "float fov" [60]
Sampler "lowdiscrepancy" "integer pixelsamples" [2]
PixelFilter "box"
SurfaceIntegrator "directlighting"
WorldBegin
LightSource "point" "point from" [0 2 0] "color I" [10 10 10]
Material "matte" "color Kd" [0.6 0.5 0.4]
AttributeBegin
  Translate 0 0 3
  Shape "sphere" "float radius" [1]
AttributeEnd
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-4 -1 0  4 -1 0  4 -1 8  -4 -1 8]
WorldEnd
"""
# The pool's lanes: fewer than the samples, so lanes regenerate.
POOL_LANES = 64
TIMINGS = {("Performance", "Wall-clock seconds"),
           ("Performance", "Samples per second")}


def test_stats_registry_format():
    s = StatsRegistry()
    s.add("Camera", "Rays traced", 1_500_000)
    s.add("Camera", "Rays traced", 500_000)
    s.add_ratio("Grid", "Tests per ray", 10, 4)
    assert s.get("Camera", "Rays traced") == 2_000_000
    tbl = s.format_table()
    assert "2.000M" in tbl and "Camera" in tbl and "2.50x" in tbl
    assert _suffixed(3_200_000_000) == "3.200B"
    assert _suffixed(999) == "999"
    s2 = StatsRegistry()
    s2.add("Camera", "Rays traced", 1)
    s2.merge(s)
    assert s2.get("Camera", "Rays traced") == 2_000_001


def test_progress_reporter():
    buf = io.StringIO()
    rep = ProgressReporter(4, "Rendering", out=buf)
    for _ in range(4):
        rep.update()
    rep.done()
    out = buf.getvalue()
    assert "Rendering" in out and "+" in out and out.endswith("\n")


def counters(stats):
    """Every counter and ratio of a registry but the two timings and the
    port's own stage spans (category "Spans", which tpuprt has not)."""
    return ({k: v for k, v in stats._counters.items()
             if k not in TIMINGS and k[0] != "Spans"},
            dict(stats._ratios))


def test_pool_counters_match_tpuprt():
    """The pool's passes, path segments, shadow rays, lane occupancy and
    samples taken equal tpuprt's; the progress bar reaches its end; the
    counters cost the default path nothing: the render without stats and
    progress converts no more tensors to host values than one a pass
    (the pool's own test of its live lanes), stats adds two after the
    loop."""
    jscene, jopts = jax_load(SCENE)
    jstats = JaxStats()
    jax_render.render(jscene, jopts._replace(chunk_size=POOL_LANES),
                      stats=jstats)
    scene, opts = load_scene_string(SCENE)
    opts = opts._replace(chunk_size=POOL_LANES)
    conversions = []
    real = torch.Tensor.__bool__, torch.Tensor.__float__

    def counting(i):
        def conv(t):
            conversions[-1] += 1
            return real[i](t)
        return conv
    stats, err = StatsRegistry(), io.StringIO()
    try:
        torch.Tensor.__bool__, torch.Tensor.__float__ = counting(0), \
            counting(1)
        for kw in ({}, {"stats": stats}):
            conversions.append(0)
            torch_render.render(scene, opts, device="cpu", **kw)
    finally:
        torch.Tensor.__bool__, torch.Tensor.__float__ = real
    with contextlib.redirect_stderr(err):
        torch_render.render(scene, opts, device="cpu", progress=True)
    passes = stats.get("Wavefront", "Passes")
    assert counters(stats) == counters(jstats)
    assert stats.get("Camera", "Samples taken") == 16 * 12 * 2
    assert passes >= 16 * 12 * 2 / POOL_LANES      # lanes regenerated
    assert conversions == [passes, passes + 2]
    assert "Rendering: [" + "+" * 48 + "]" in err.getvalue()


def test_chunked_counters_match_tpuprt():
    """The chunked driver's samples taken, rays generated and chunks equal
    tpuprt's (one chunk here: tpuprt counts a chunk's padding lanes too,
    the port the samples, which differ only when a fixed chunk does not
    divide the samples); the port adds its own Film/Chunk lanes and
    Performance/Preprocess seconds."""
    jscene, jopts = jax_load(SCENE)
    jstats = JaxStats()
    jax_render.render(jscene, jopts._replace(driver="scan"), stats=jstats)
    scene, opts = load_scene_string(SCENE)
    stats = StatsRegistry()
    torch_render.render(scene, opts._replace(driver="scan"), device="cpu",
                        stats=stats)
    ours, _ = counters(stats)
    extra = {("Film", "Chunk lanes"), ("Performance", "Preprocess seconds")}
    assert {k: v for k, v in ours.items() if k not in extra} == \
        counters(jstats)[0]
    assert set(ours) >= extra and stats.get("Film", "Chunk lanes") == 384
    assert {k for k, _ in jstats._counters.items()} >= TIMINGS
    assert {k for k, _ in stats._counters.items()} >= TIMINGS


def test_tonemaps_match_tpuprt():
    """Each tone map's scale and apply_imaging_pipeline against tpuprt's on
    a 24x40 image with a bright pixel. Within 1e-4 on the 0-255 scale
    where no image-wide log mean enters (no tone map, maxwhite,
    highcontrast), 2e-4 with bloom (tpuprt rounds its direct 17x17
    convolution's sums in f32, the port's FFT in float64 is exact to f32;
    1.07e-4 seen under gamma 2.2); contrast and nonlinear
    scale by exp(mean log y), whose f32 sum XLA orders its own way
    (1.2e-6 relative here), so their scales are held within rtol 3e-6 and
    their pipelines within 1e-3 of 255."""
    rng = np.random.default_rng(0)
    img = (rng.gamma(0.6, 1.0, (24, 40, 3)) * 0.5).astype(np.float32)
    img[3, 5] = 30.0
    y = img.mean(-1) * 683.0
    for name, fn in ttm.TONEMAPS.items():
        np.testing.assert_allclose(fn(torch.from_numpy(y)).numpy(),
                                   np.asarray(jtm.TONEMAPS[name](y)),
                                   rtol=3e-6, err_msg=name)
    for tm in (None, "maxwhite", "highcontrast", "contrast", "nonlinear"):
        for kw in ({}, {"bloom_radius": 0.2, "gamma": 2.2},
                   {"dither": 0.0, "max_display_y": 50.0}):
            got = ttm.apply_imaging_pipeline(img, tm, **kw).numpy()
            want = np.asarray(jtm.apply_imaging_pipeline(img, tm, **kw))
            tol = 1e-3 if tm in ("contrast", "nonlinear") else \
                2e-4 if kw.get("bloom_radius") else 1e-4
            assert np.abs(got - want).max() <= tol, (tm, kw)
            assert got.min() >= 0.0 and got.max() <= 255.0


def write_scene(tmp_path, text=SCENE):
    path = tmp_path / "scene.pbrt"
    path.write_text(text)
    return str(path)


def test_cli_matches_render(tmp_path, capsys):
    """main([scene, -o, out, --device cpu]): returns 0, writes the EXR of
    render(device="cpu") with half readback bit for bit, prints the stats
    table and "Wrote", and draws the progress bar on stderr."""
    path = write_scene(tmp_path)
    out = tmp_path / "cli.exr"
    assert cli.main([path, "-o", str(out), "--device", "cpu"]) == 0
    captured = capsys.readouterr()
    assert "Statistics:" in captured.out and "Samples taken" in captured.out
    assert f"Wrote {out}" in captured.out and "Rendering" in captured.err
    scene, opts = load_scene(path)
    rgb, alpha = torch_render.render(scene, opts._replace(
        half_readback=True), device="cpu")
    write_exr(str(tmp_path / "ref.exr"), rgb, alpha)
    assert out.read_bytes() == (tmp_path / "ref.exr").read_bytes()


def test_cli_spp_checkpoint_resume(tmp_path):
    """--spp 6 on a stratified sampler renders 2x3 strata, as pbrt.py
    factors it; --checkpoint renders through the chunked driver and leaves
    no checkpoint; --resume starts from <outfile>.ckpt.npz (here an empty
    film past the last chunk: a black image) and removes it."""
    path = write_scene(tmp_path, SCENE.replace(
        'Sampler "lowdiscrepancy" "integer pixelsamples" [2]',
        'Sampler "stratified" "integer xsamples" [1] '
        '"integer ysamples" [1]').replace(
        '"string filename" ["out.exr"]',
        '"string filename" ["out.exr"] "integer writefrequency" [64]'))
    out = str(tmp_path / "spp.exr")
    assert cli.main([path, "-o", out, "--spp", "6", "--quiet",
                     "--device", "cpu", "--checkpoint"]) == 0
    assert not os.path.exists(out + ".ckpt.npz")
    scene, opts = load_scene(path)
    opts = opts._replace(half_readback=True, filename=out, sampler=(
        opts.sampler._replace(xsamples=2, ysamples=3)))
    rgb, alpha = torch_render.render(
        scene, opts, device="cpu",
        checkpoint_path=str(tmp_path / "other.npz"))
    np.testing.assert_array_equal(read_exr(out)[0], rgb)
    assert rgb.max() > 0.1
    film = tfilm.make_film(opts.xres, opts.yres, opts.crop, "cpu")
    torch_render.save_checkpoint(out + ".ckpt.npz", film, 1 << 20, opts)
    assert cli.main([path, "-o", out, "--spp", "6", "--quiet",
                     "--device", "cpu", "--resume"]) == 0
    assert read_exr(out)[0].max() == 0.0
    assert not os.path.exists(out + ".ckpt.npz")


def test_cli_needs_the_card(tmp_path, monkeypatch):
    """Without a CUDA device and without --device cpu the CLI raises
    before it parses, as render() does; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "none.exr"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([str(tmp_path / "missing.pbrt"), "-o", str(out)])
    assert not out.exists()


def test_bc_gen_matches_tpuprt():
    """generate_table equal to tpuprt's at n=256, seed 0; load_table is
    the shipped table, the one the samplers read."""
    np.testing.assert_array_equal(tbc.generate_table(n=256, seed=0),
                                  jbc.generate_table(n=256, seed=0))
    shipped = np.load(os.path.join(os.path.dirname(tbc.__file__),
                                   "bc_table.npy"))
    np.testing.assert_array_equal(tbc.load_table(), shipped)
    assert shipped.shape == (tbc.TABLE_SIZE, 5)
