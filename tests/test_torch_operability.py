"""The port's parser held against tpuprt's on the CPU where pbrt-v1 files
outside the repo take it: Include (nested, relative to the including
file), SearchPath, Identity, CoordinateSystem/CoordSysTransform; the
warnings and fallbacks where tpuprt warns instead of raising (the warning
lines read from stderr, equal as lists); report_unused on a typo'd
parameter; the repo's small scenes. Tables are held bit-equal through
scene/bridge.py. Where tpuprt's render itself fails on what loads (an
empty main aggregate, directlighting's scan without lights, an unknown
pixel filter), the port raises there too and the case says so; tpuprt's
render is run up to its failure, which comes while it traces.
"""
import contextlib
import io
import os

import numpy as np
import pytest
import torch

from test_torch_bvh import assert_tables_equal, numpy_tables
from tpuprt import render as jax_render
from tpuprt.scene import build as jbuild
from tpuprt.scene import parser as jparser
from tpuprt.utils import errors as jerrors
from tpuprt_torch import render as torch_render
from tpuprt_torch.io.exr import write_exr
from tpuprt_torch.scene import build as tbuild
from tpuprt_torch.scene import parser as tparser
from tpuprt_torch.scene.bridge import from_numpy_tables
from tpuprt_torch.utils import errors as terrors

torch.set_num_threads(1)

MESH = ('Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]\n'
        '  "point P" [-1 0 -1  1 0 -1  1 0 1  -1 0 1]\n')
HEAD = """Film "image" "integer xresolution" [8] "integer yresolution" [6]
Sampler "lowdiscrepancy" "integer pixelsamples" [1]
PixelFilter "box"
LookAt 0 2 -3  0 0 0  0 1 0
Camera "perspective" "float fov" [50]
"""
LIGHT = 'LightSource "distant" "point from" [0 1 -1] "point to" [0 0 0]\n'


def loaded(load, *args):
    """(scene, opts, the Warning lines printed to stderr)."""
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        scene, opts = load(*args)
    return scene, opts, [ln for ln in buf.getvalue().splitlines()
                         if ln.startswith("Warning")]


def both(load_name, *args):
    """Load with tpuprt and with the port: (tpuprt's scene, the port's
    scene, the port's opts, the warnings), failing unless the tables are
    bit-equal and the warning lines equal as lists."""
    jscene, jopts, jwarn = loaded(getattr(jparser, load_name), *args)
    tscene, topts, twarn = loaded(getattr(tparser, load_name), *args)
    assert twarn == jwarn
    assert_tables_equal(tscene, from_numpy_tables(numpy_tables(jscene),
                                                  "cpu"))
    for f in ("integrator", "filter_kind", "filter_xwidth",
              "filter_ywidth", "xres", "yres", "filename", "sampler",
              "volume_integrator", "writefrequency", "max_depth"):
        assert getattr(topts, f) == getattr(jopts, f), f
    return jscene, jopts, tscene, topts, twarn


def test_statements_match_tpuprt(tmp_path):
    """SearchPath, Include two deep (world/world.pbrt includes
    "lights.pbrt" beside itself), Identity, CoordinateSystem and
    CoordSysTransform ("eye", "camera", "world", a pair whose net is the
    identity, an unknown name that leaves the CTM), and an imagemap named
    relative to the top file from an included file."""
    (tmp_path / "view").mkdir()
    (tmp_path / "world").mkdir()
    (tmp_path / "maps").mkdir()
    rng = np.random.default_rng(3)
    write_exr(str(tmp_path / "maps" / "tex.exr"),
              rng.uniform(0, 1, (4, 4, 3)).astype(np.float32),
              np.ones((4, 4), np.float32))
    (tmp_path / "view" / "camera.pbrt").write_text(
        'LookAt 0 2 -3  0 0 0  0 1 0\nCoordinateSystem "eye"\n'
        'Camera "perspective" "float fov" [50]\n')
    (tmp_path / "world" / "lights.pbrt").write_text(
        'LightSource "point" "point from" [0 2 0] "color I" [3 3 3]\n')
    (tmp_path / "world" / "world.pbrt").write_text(
        'Include "lights.pbrt"\n'
        'CoordinateSystem "w0"\nTranslate 0.5 0 0\nCoordSysTransform "w0"\n'
        'AttributeBegin\nCoordSysTransform "camera"\nTranslate 0 0 3\n'
        'Shape "sphere" "float radius" [0.3]\nAttributeEnd\n'
        'AttributeBegin\nCoordSysTransform "eye"\n'
        'Shape "disk" "float radius" [0.2]\nAttributeEnd\n'
        'Translate 0 0.1 0\nCoordSysTransform "nowhere"\n'
        'Texture "t" "color" "imagemap" "string filename" "maps/tex.exr"\n'
        'Material "matte" "texture Kd" "t"\n' + MESH +
        'CoordSysTransform "world"\nScale 0.5 0.5 0.5\n' + MESH)
    (tmp_path / "top.pbrt").write_text(
        HEAD.split("LookAt")[0] + 'SearchPath "plugins:more"\n'
        'Include "view/camera.pbrt"\nWorldBegin\nTranslate 1 1 1\n'
        'Identity\nInclude "world/world.pbrt"\nWorldEnd\n')
    _, _, tscene, _, warn = both("load_scene", str(tmp_path / "top.pbrt"))
    assert warn == []
    assert tscene.quadrics.count == 2 and tscene.triangles.count == 4
    assert tscene.lights.count == 1 and tscene.images is not None


# The cases where tpuprt warns or falls back instead of raising: (body of
# the world block, the render's failure in tpuprt and in the port or
# None). Each loads to tpuprt's tables with tpuprt's warning lines.
FALLBACKS = {
    "statements": (HEAD, LIGHT + 'MakeNamedMaterial "m" "string type" '
                   '["matte"]\nBogus "float x" [1]\n' + MESH, None),
    "material": (HEAD, LIGHT + 'Material "velvet" "color Kd" [1 0 0]\n' +
                 MESH, None),
    "area-quadrics": (HEAD, LIGHT + 'AttributeBegin\nAreaLightSource '
                      '"goniometric" "color L" [2 2 2]\nShape "cone"\n'
                      'Shape "paraboloid"\nShape "hyperboloid"\n'
                      'Shape "sphere" "float radius" [0.2]\nAttributeEnd\n' +
                      MESH, None),
    "kinds": (HEAD, LIGHT + 'LightSource "laser" "color I" [1 1 1]\n'
              'Material "plastic"\nShape "teapot" "float size" [2]\n'
              'Volume "fog" "color sigma_a" [1 1 1] "float density" [2]\n' +
              MESH, None),
    "camera-filter-integrator": (
        HEAD.replace('"perspective"', '"fisheye"').replace(
            '"box"', '"lanczos" "float tau" [3]') +
        'SurfaceIntegrator "ambientocclusion" "integer nsamples" [4]\n',
        LIGHT + MESH, (ValueError, "unknown filter lanczos")),
    "no-lights": (HEAD, MESH, (IndexError, None)),
    "empty-aggregate": (HEAD, LIGHT + 'AttributeBegin\nAreaLightSource '
                        '"area"\nObjectBegin "o"\n' + MESH + 'ObjectEnd\n'
                        'AttributeEnd\n', (IndexError, None)),
}


@pytest.mark.parametrize("name", list(FALLBACKS))
def test_fallbacks_match_tpuprt(name):
    """Each case loads with tpuprt's tables and warning lines (an unknown
    statement warned and skipped; an unknown material matte, which an
    unknown name also fails as in tpuprt's builder, KeyError; an area
    light of any name, on a cone, paraboloid or hyperboloid emitting
    nothing; an unknown light, shape and volume kind skipped, their
    parameters reported; an unknown camera environment, an unknown
    integrator directlighting, an unknown filter kept with widths (2, 2)).
    Where tpuprt's render then fails, the port raises: an unknown filter
    at its first splat (both ValueError); a scene without lights in
    directlighting's scan at its emission gather (tpuprt TypeError, the
    port IndexError), while the pool renders it black with alpha; an empty
    main aggregate in every driver (both IndexError)."""
    head, body, fails = FALLBACKS[name]
    text = head + "WorldBegin\n" + body + "WorldEnd\n"
    jscene, jopts, tscene, topts, warn = both("load_scene_string", text)
    before = terrors.counts["warning"]
    loaded(tparser.load_scene_string, text)
    assert terrors.counts["warning"] - before == len(warn)
    if name == "material":
        for builder in (jbuild.SceneBuilder(), tbuild.SceneBuilder()):
            with pytest.raises(KeyError):
                builder.add_material("velvet", [])
    if name == "camera-filter-integrator":
        assert topts.integrator == "directlighting"
        assert int(tscene.camera.kind) == 2          # environment
    if name == "area-quadrics":
        assert tscene.quadrics.count == 4 and tscene.lights.count == 2
    if fails is None:
        return
    opts = topts._replace(driver="scan")
    exc, match = fails
    if name == "no-lights":
        rgb, alpha = torch_render.render(tscene, topts, device="cpu")
        assert rgb.max() == 0.0 and alpha.max() == 1.0
        with pytest.raises(TypeError):
            jax_render.render(jscene, jopts._replace(driver="scan"))
    else:
        with pytest.raises(exc, match=match):
            jax_render.render(jscene, jopts._replace(driver="scan"))
    with pytest.raises(exc, match=match):
        torch_render.render(tscene, opts, device="cpu")


def test_report_unused_on_a_typo(capsys):
    """A typo'd parameter on a Shape, a LightSource, the Film and the
    Camera: tpuprt's four warning lines, "parameter ... not used" with the
    statement, counted in utils.errors."""
    text = (HEAD.replace('[50]', '[50] "float fvo" [40]').replace(
        '[1]\n', '[1] "string filname" ["x.exr"]\n', 1) + "WorldBegin\n" +
        LIGHT.replace("\n", ' "color Ll" [2 2 2]\n') +
        MESH.replace("\n", ' "float radus" [1]\n', 1) + "WorldEnd\n")
    before = jerrors.counts["warning"]
    *_, warn = both("load_scene_string", text)
    assert jerrors.counts["warning"] == before + 4
    assert len(warn) == 4 and all("not used" in w for w in warn)
    assert 'Warning (Shape "trianglemesh"): parameter "radus" not used' \
        in warn


def test_repo_scenes_warn_as_tpuprt():
    """The repo's small scenes (config1-3, bench3, bench6) parsed by both
    from their files: the same tables and the same (no) warnings."""
    for name in ("config1", "config2", "config3", "bench3", "bench6"):
        path = os.path.join(os.path.dirname(__file__), "..", "scenes",
                            f"{name}.pbrt")
        assert both("load_scene", path)[-1] == [], name
