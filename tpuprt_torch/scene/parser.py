"""pbrt scene-description parser + API state machine (port of
tpuprt/scene/parser.py).

Statements: Film, LookAt, Camera "perspective" (with a thin lens),
"orthographic" and "environment" with the shutter times, Sampler,
PixelFilter "box", "triangle", "gaussian", "mitchell" (pbrt-v1's default)
and "sinc" (their widths; the shape parameters keep tpuprt's defaults),
SurfaceIntegrator "directlighting", "path", "whitted", "debug",
"photonmap", "exphotonmap", "igi", "irradiancecache" and "bidirectional",
VolumeIntegrator "emission" and "single" (any other name reads as
"emission", as tpuprt reads it), Accelerator (with the kd-tree's SAH
knobs), WorldBegin/End, AttributeBegin/End, TransformBegin/End, Transform,
ConcatTransform, Translate/Rotate/Scale, ReverseOrientation, Texture of
every class tpuprt reads (constant, scale, mix, bilerp, uv, checkerboard in
2D and 3D, dots, fbm, wrinkled, windy, marble, imagemap; any other class a
constant 0.5 gray, as tpuprt's), Material of all fourteen kinds (matte,
plastic, glass, mirror, shinymetal, substrate, translucent, uber and the
six measured BRDFs) with a "bumpmap", LightSource "point", "spot",
"distant", "infinite" and "infinitesample" (with or without a "mapname"),
"projection" and "goniometric", AreaLightSource "area" on a sphere, disk,
cylinder or triangle mesh (a tessellated shape is one), Shape
"trianglemesh", "loopsubdiv", "nurbs", "heightfield" (tessellated at
load, scene/tessellate.py) and the six quadrics (sphere, cylinder, disk,
cone, paraboloid, hyperboloid), Volume "homogeneous", "exponential" and
"volumegrid", and ObjectBegin/ObjectEnd/ObjectInstance of any of those
shapes, emitters included, routed as tpuprt routes them
(tpuprt/scene/parser.py:378-437): a mesh-kind shape becomes a shared
prototype placed by ray-transform instancing, an emissive one only under
a similarity transform (each placement its own light); every other shape
is folded into a row of its own table under the instance's transform.
Also Include (nested; a file named relative to the including file's
directory), SearchPath (its values consumed), Identity, and
CoordinateSystem/CoordSysTransform with the named transforms "camera" (the
inverse of the CTM at Camera) and "world" (the identity at WorldBegin);
an unknown name leaves the CTM as it is. Image files (an imagemap's
"filename", a light's "mapname") are read relative to the top file's
directory, as tpuprt reads them.

Where tpuprt warns or falls back, so does the port, with tpuprt's warning
lines on stderr (utils/errors.py): an unknown statement is warned about
and its parameters skipped; every parameter a Texture, LightSource,
top-level Shape, Volume, Camera, Sampler, Film, PixelFilter,
SurfaceIntegrator or Accelerator statement did not read is warned about
(ParamSet.report_unused); an unknown Material is matte; an unknown Shape
makes its material and no shape, an unknown LightSource or Volume kind
nothing; any AreaLightSource name reads as "area", which only a sphere,
disk, cylinder or mesh takes (a cone, paraboloid or hyperboloid under it
emits nothing); an unknown Camera is "environment", an unknown
SurfaceIntegrator "directlighting"; an unknown PixelFilter keeps its name
with widths (2, 2) and fails where the render evaluates it
(filters.evaluate, ValueError), as tpuprt's. A scene without lights, or
whose main aggregate is empty, loads; what tpuprt's render fails on there
raises in the port too (render.on_device, lights.area_emission).

Bracketed number lists are converted with numpy in one call per list, not
per token, so a multi-megabyte mesh parses in seconds. Values go through
float64 to float32 exactly as the reference's per-token Python floats do.
"""
from __future__ import annotations

import math
import os
import re
from typing import Dict, List, Tuple

import numpy as np

from ..cameras import cameras as cam
from ..core import transform as tfm
from ..filters.filters import DEFAULT_WIDTHS
from ..integrators.exphotonmap import ExPhotonParams
from ..integrators.igi import IgiParams
from ..integrators.irradiancecache import IrradParams
from ..integrators.photonmap import PhotonParams
from ..io.exr import read_exr
from ..io.mipmap_build import build_pyramid
from ..materials.factory import MATERIAL_KINDS
from ..samplers.samplers import SamplerConfig
from ..textures.graph import TexNodeMeta
from ..utils import errors
from . import data as D
from .build import SceneBuilder, is_similarity
from .tessellate import tessellate

_TOKEN_RE = re.compile(r'"([^"]*)"|\[|\]|([^\s"\[\]]+)')
# The shapes that become triangle meshes, and so may be a prototype.
MESH_KINDS = ("trianglemesh", "loopsubdiv", "nurbs", "heightfield")
QUADRIC_KINDS = ("sphere", "cylinder", "disk", "cone", "paraboloid",
                 "hyperboloid")


def tokenize(text: str, basedir: str = "."):
    """Tokens as (kind, value): ("str", s), ("id", s), or ("nums", f64
    array) for a bracketed list of numbers; ("list", [...]) for a bracketed
    list holding strings. # comments run to the end of the line. An
    Include statement is replaced by its file's tokens, the file named
    relative to `basedir` and its own Includes relative to its directory,
    as tpuprt's tokenizer reads them (tpuprt/scene/parser.py:57-62)."""
    text = "\n".join(line.split("#", 1)[0] for line in text.splitlines())
    pos, n = 0, len(text)
    toks = []
    while True:
        m = _TOKEN_RE.search(text, pos)
        if m is None:
            break
        pos = m.end()
        if m.group(1) is not None:
            toks.append(("str", m.group(1)))
        elif m.group(0) == "[":
            end = text.find("]", pos)
            if end < 0:
                end = n
            body = text[pos:end]
            pos = end + 1
            if '"' in body:
                toks.append(("list", re.findall(r'"([^"]*)"', body)))
            else:
                toks.append(("nums", np.array(body.split(), np.float64)))
        elif m.group(0) == "]":
            raise ValueError("unbalanced ']' in scene text")
        elif m.group(2) == "Include":
            m = _TOKEN_RE.search(text, pos)
            pos = m.end()
            path = os.path.join(basedir, m.group(1) or m.group(2))
            with open(path) as f:
                toks.extend(tokenize(f.read(), os.path.dirname(path)))
        else:
            toks.append(("id", m.group(2)))
    return toks


def _value_list(kind, value):
    if kind == "nums":
        return value
    if kind == "list":
        return list(value)
    if kind == "str":
        return [value]
    return np.array([float(value)], np.float64)


class ParamSet:
    """Typed lookup with defaults (core/paramset.h FindOne* semantics).
    Every name looked up is recorded, so report_unused can warn of the
    parameters nothing read (core/paramset.cpp:242 ReportUnused)."""

    def __init__(self, raw: Dict[str, Tuple[str, object]]):
        self.raw = raw
        self._looked = set()

    def report_unused(self, where: str):
        """Warn of every parameter not looked up, in the file's order
        (tpuprt/scene/parser.py:139-143)."""
        for name in self.raw:
            if name not in self._looked:
                errors.warning(f'parameter "{name}" not used', where)

    def find_one(self, name, default):
        self._looked.add(name)
        if name not in self.raw:
            return default
        vals = self.raw[name][1]
        v = vals[0] if len(vals) else default
        if isinstance(default, bool):
            return v == "true" if isinstance(v, str) else bool(v)
        if isinstance(default, float):
            return float(v)
        if isinstance(default, int):
            return int(v)
        return v

    def find_spectrum(self, name, default):
        self._looked.add(name)
        if name not in self.raw:
            return np.asarray(default, np.float32)
        vals = np.asarray(self.raw[name][1], np.float64)
        if len(vals) == 1:
            return np.full(3, vals[0], np.float32)
        return vals[:3].astype(np.float32)

    def find_point(self, name, default):
        self._looked.add(name)
        if name not in self.raw:
            return np.asarray(default, np.float32)
        return np.asarray(self.raw[name][1][:3], np.float64).astype(
            np.float32)

    def find_floats(self, name):
        self._looked.add(name)
        if name not in self.raw:
            return None
        return np.asarray(self.raw[name][1], np.float64).astype(np.float32)

    def find_ints(self, name):
        self._looked.add(name)
        if name not in self.raw:
            return None
        return np.asarray(self.raw[name][1], np.float64).astype(np.int32)

    def is_texture(self, name):
        self._looked.add(name)
        return name in self.raw and self.raw[name][0] == "texture"

    def texture_name(self, name):
        self._looked.add(name)
        return self.raw[name][1][0]


class _Stream:
    def __init__(self, toks):
        self.toks = toks
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def numbers(self, count):
        """`count` numbers, bare or bracketed (LookAt, Translate, ...)."""
        out = []
        while len(out) < count:
            kind, v = self.next()
            out.extend(v.tolist() if kind == "nums" else [float(v)])
        return out

    def params(self):
        """'"type name" values' pairs until the next statement; a value is
        a bracketed list or one bare token (_parse_value_list)."""
        params = {}
        while self.peek() is not None and self.peek()[0] == "str":
            decl = self.next()[1].split()
            if len(decl) != 2:
                continue          # not a declaration: its values stay
            if self.peek() is None:
                break
            params[decl[1]] = (decl[0], _value_list(*self.next()))
        return ParamSet(params)


class PbrtParser:
    """The API state machine (core/api.cpp) driving a SceneBuilder."""

    def __init__(self, basedir="."):
        self.basedir = basedir
        self._image_cache: Dict[str, int] = {}
        self.builder = SceneBuilder()
        self.ctm = np.eye(4, dtype=np.float32)
        self.ctm_stack: List[np.ndarray] = []
        self.material = ("matte", ParamSet({}))
        self.material_id = None
        self.area_light = None            # the AreaLightSource's params
        self.reverse_orientation = False
        self.gs_stack: List[tuple] = []
        self.named_textures: Dict[str, int] = {}
        self.camera_name = "perspective"
        self.camera_params = ParamSet({})
        self.camera_w2c = np.eye(4, dtype=np.float32)
        self.sampler_name = "bestcandidate"
        self.sampler_params = ParamSet({})
        self.film_params = ParamSet({})
        self.filter_name = "mitchell"
        self.filter_params = ParamSet({})
        self.integrator_name = "directlighting"
        self.integrator_params = ParamSet({})
        self.volume_integrator_name = "emission"
        self.accel_name = "kdtree"
        self.accel_params = ParamSet({})
        # Named coordinate systems (CoordinateSystem, and "camera" and
        # "world" as tpuprt records them).
        self.coord_systems: Dict[str, np.ndarray] = {}
        # Object name -> its recorded shapes (kind, params, ctm, graphics
        # state ([material, material id], area light, reverse
        # orientation)); (object, shape index) -> prototype id, so the
        # instances of one object share one prototype BLAS.
        self.objects: Dict[str, list] = {}
        self.current_object = None
        self._proto_cache: Dict[Tuple[str, int], int] = {}

    def parse_string(self, text: str):
        ts = _Stream(tokenize(text, self.basedir))
        while ts.peek() is not None:
            kind, tok = ts.next()
            if kind == "id":
                self._directive(tok, ts)

    def _directive(self, name: str, ts: _Stream):
        if name == "LookAt":
            v = ts.numbers(9)
            w2c = np.linalg.inv(np.asarray(
                tfm.look_at(v[0:3], v[3:6], v[6:9]), np.float32))
            self.ctm = self.ctm @ w2c
        elif name == "Translate":
            self.ctm = self.ctm @ tfm.translate(ts.numbers(3))
        elif name == "Scale":
            self.ctm = self.ctm @ tfm.scale(*ts.numbers(3))
        elif name == "Rotate":
            v = ts.numbers(4)
            self.ctm = self.ctm @ tfm.rotate(v[0], v[1:4])
        elif name in ("Transform", "ConcatTransform"):
            m = np.asarray(ts.numbers(16), np.float32).reshape(4, 4).T
            self.ctm = m if name == "Transform" else self.ctm @ m
        elif name == "Identity":
            self.ctm = np.eye(4, dtype=np.float32)
        elif name == "CoordinateSystem":
            self.coord_systems[ts.next()[1]] = self.ctm.copy()
        elif name == "CoordSysTransform":
            # An unknown name leaves the CTM as it is (tpuprt/scene/
            # parser.py:283-286).
            cs = self.coord_systems.get(ts.next()[1])
            if cs is not None:
                self.ctm = cs.copy()
        elif name == "SearchPath":
            ts.next()             # plugin directories mean nothing here
        elif name == "AttributeBegin":
            self.gs_stack.append((self.material, self.material_id,
                                  self.area_light, self.reverse_orientation))
            self.ctm_stack.append(self.ctm.copy())
        elif name == "AttributeEnd":
            (self.material, self.material_id, self.area_light,
             self.reverse_orientation) = self.gs_stack.pop()
            self.ctm = self.ctm_stack.pop()
        elif name == "ReverseOrientation":
            self.reverse_orientation = not self.reverse_orientation
        elif name == "TransformBegin":
            self.ctm_stack.append(self.ctm.copy())
        elif name == "TransformEnd":
            self.ctm = self.ctm_stack.pop()
        elif name == "WorldBegin":
            self.coord_systems["world"] = np.eye(4, dtype=np.float32)
            self.ctm = np.eye(4, dtype=np.float32)
        elif name == "WorldEnd":
            pass
        elif name == "Camera":
            self.camera_name = ts.next()[1]
            self.camera_params = ts.params()
            self.camera_w2c = self.ctm.copy()
            self.coord_systems["camera"] = np.linalg.inv(self.ctm)
        elif name == "Sampler":
            self.sampler_name = ts.next()[1]
            self.sampler_params = ts.params()
        elif name == "Film":
            ts.next()  # "image"
            self.film_params = ts.params()
        elif name == "PixelFilter":
            self.filter_name = ts.next()[1]
            self.filter_params = ts.params()
        elif name == "SurfaceIntegrator":
            self.integrator_name = ts.next()[1]
            self.integrator_params = ts.params()
        elif name == "VolumeIntegrator":
            self.volume_integrator_name = ts.next()[1]
            ts.params()
        elif name == "Volume":
            kind, params = ts.next()[1], ts.params()
            self._make_volume(kind, params)
            params.report_unused(f'Volume "{kind}"')
        elif name == "Accelerator":
            self.accel_name = self.builder.accel_kind = ts.next()[1]
            self.accel_params = params = ts.params()
            # kd-tree SAH knobs (accelerators/kdtree.cpp:489-498).
            for src, dst in (("intersectcost", "isect_cost"),
                             ("traversalcost", "trav_cost"),
                             ("emptybonus", "empty_bonus"),
                             ("maxprims", "max_prims"),
                             ("maxdepth", "max_depth")):
                v = params.find_one(src, None)
                if v is not None:
                    self.builder.accel_params[dst] = (
                        int(v) if dst in ("max_prims", "max_depth")
                        else float(v))
        elif name == "Material":
            self.material = (ts.next()[1], ts.params())
            self.material_id = None
        elif name == "Texture":
            tex_name = ts.next()[1]
            tex_type = ts.next()[1]   # "float" | "color"
            tex_class = ts.next()[1]
            params = ts.params()
            self.named_textures[tex_name] = self._make_texture(
                tex_class, tex_type, params)
            params.report_unused(f'Texture "{tex_name}" ({tex_class})')
        elif name == "LightSource":
            kind, params = ts.next()[1], ts.params()
            self._make_light(kind, params)
            params.report_unused(f'LightSource "{kind}"')
        elif name == "AreaLightSource":
            # Any name reads as "area" (tpuprt/scene/parser.py:359-361).
            ts.next()
            self.area_light = ts.params()
        elif name == "Shape":
            kind, params = ts.next()[1], ts.params()
            if self.current_object is None:
                self._make_shape(kind, params, self.ctm, self._gs())
                params.report_unused(f'Shape "{kind}"')
            else:
                self.objects[self.current_object].append(
                    (kind, params, self.ctm.copy(),
                     ([self.material, self.material_id], self.area_light,
                      self.reverse_orientation)))
        elif name == "ObjectBegin":
            self.current_object = ts.next()[1]
            self.objects[self.current_object] = []
            self.ctm_stack.append(self.ctm.copy())
        elif name == "ObjectEnd":
            self.current_object = None
            self.ctm = self.ctm_stack.pop()
        elif name == "ObjectInstance":
            self._instance(ts.next()[1])
        else:
            # tpuprt warns and skips the statement's parameters (tpuprt/
            # scene/parser.py:443-448); pbrt-v1's parser stops on it.
            errors.warning(f'unknown directive "{name}" ignored')
            ts.params()

    def _child(self, params, name, default, is_float=False) -> int:
        """TextureParams::Get*Texture (core/paramset.h:162-215)."""
        if params.is_texture(name):
            return self.named_textures[params.texture_name(name)]
        if is_float:
            return self.builder.constant_texture(
                params.find_one(name, float(default)))
        return self.builder.constant_texture(
            params.find_spectrum(name, default))

    def _make_material(self, material) -> int:
        kind, params = material
        # Every material takes an optional float "bumpmap" displacement
        # (core/material.cpp:29-71).
        bump = (self.named_textures[params.texture_name("bumpmap")]
                if params.is_texture("bumpmap") else -1)
        if kind == "matte":
            return self.builder.add_material("matte", [
                self._child(params, "Kd", (0.5,) * 3),
                self._child(params, "sigma", 0.0, True)], bump=bump)
        if kind == "plastic":
            return self.builder.add_material("plastic", [
                self._child(params, "Kd", (0.25,) * 3),
                self._child(params, "Ks", (0.25,) * 3),
                self._child(params, "roughness", 0.1, True)], bump=bump)
        if kind == "glass":
            return self.builder.add_material("glass", [
                self._child(params, "Kr", (1.0,) * 3),
                self._child(params, "Kt", (1.0,) * 3),
                self._child(params, "index", 1.5, True)], bump=bump)
        if kind == "mirror":
            return self.builder.add_material("mirror", [
                self._child(params, "Kr", (0.9,) * 3)], bump=bump)
        if kind == "shinymetal":
            return self.builder.add_material("shinymetal", [
                self._child(params, "Ks", (1.0,) * 3),
                self._child(params, "Kr", (1.0,) * 3),
                self._child(params, "roughness", 0.1, True)], bump=bump)
        if kind == "substrate":
            return self.builder.add_material("substrate", [
                self._child(params, "Kd", (0.5,) * 3),
                self._child(params, "Ks", (0.5,) * 3),
                self._child(params, "uroughness", 0.1, True),
                self._child(params, "vroughness", 0.1, True)], bump=bump)
        if kind == "translucent":
            return self.builder.add_material("translucent", [
                self._child(params, "Kd", (0.25,) * 3),
                self._child(params, "Ks", (0.25,) * 3),
                self._child(params, "roughness", 0.1, True),
                self._child(params, "reflect", (0.5,) * 3),
                self._child(params, "transmit", (0.5,) * 3)], bump=bump)
        if kind == "uber":
            return self.builder.add_material("uber", [
                self._child(params, "Kd", (0.25,) * 3),
                self._child(params, "Ks", (0.25,) * 3),
                self._child(params, "Kr", (0.0,) * 3),
                self._child(params, "roughness", 0.1, True),
                self._child(params, "opacity", (1.0,) * 3)], bump=bump)
        if kind in MATERIAL_KINDS:     # the six measured materials
            return self.builder.add_material(kind, [], bump=bump)
        # Any other name is matte, as tpuprt makes it (tpuprt/scene/
        # parser.py:515-517).
        return self.builder.matte()

    def _gs(self):
        """The current graphics state as a shape is made with it: (None
        for the current material, area light params or None, reverse
        orientation). An object records [material, material id] in the
        first place instead."""
        return (None, self.area_light, self.reverse_orientation)

    def _gs_material(self, mat) -> int:
        """The material id of a recorded [material, id] pair, or of the
        current state for None, made at the first shape that needs it."""
        if mat is None:
            if self.material_id is None:
                self.material_id = self._make_material(self.material)
            return self.material_id
        if mat[1] is None:
            mat[1] = self._make_material(mat[0])
        return mat[1]

    def _instance(self, name: str):
        """ObjectInstance (tpuprt/scene/parser.py:378-437): a mesh-kind
        shape without an area light, or with one under a similarity
        transform, becomes a shared prototype (made at its first instance,
        with the material state recorded beside it) and an instance under
        the current CTM; every other shape, quadrics and emitters under a
        non-similarity transform included, is made anew under ctm @ its
        own transform, as tpuprt folds and duplicates them."""
        for i, (kind, params, sctm, gs) in enumerate(
                self.objects.get(name, [])):
            mat, al, ro = gs
            emissive_ok = al is not None and kind in MESH_KINDS and \
                is_similarity(self.ctm[:3, :3])
            if kind not in MESH_KINDS or not (al is None or emissive_ok):
                self._make_shape(kind, params, self.ctm @ sctm, gs)
                continue
            pid = self._proto_cache.get((name, i))
            if pid is None:
                mid = self._gs_material(mat)
                P, idx, N, uv = _mesh_arrays(kind, params)
                pid = self.builder.add_prototype(
                    idx, P, N=N, uv=uv, material=mid,
                    reverse_orientation=ro, o2w=sctm,
                    area_light_L=(al.find_spectrum("L", (1.0,) * 3)
                                  if al is not None else None),
                    area_nsamples=(int(al.find_one("nsamples", 1))
                                   if al is not None else 1))
                self._proto_cache[(name, i)] = pid
            self.builder.add_instance(pid, self.ctm)

    def _make_volume(self, kind: str, params: ParamSet):
        """Volume (tpuprt/scene/parser.py:765-789): a region under the
        current transform; another kind reads the common parameters and is
        skipped, as tpuprt skips it."""
        common = dict(
            v2w=self.ctm, p0=params.find_point("p0", (0, 0, 0)),
            p1=params.find_point("p1", (1, 1, 1)),
            sigma_a=params.find_spectrum("sigma_a", (1.0,) * 3),
            sigma_s=params.find_spectrum("sigma_s", (1.0,) * 3),
            le=params.find_spectrum("Le", (0.0,) * 3),
            g=params.find_one("g", 0.0))
        if kind == "exponential":
            common.update(a=params.find_one("a", 1.0),
                          b=params.find_one("b", 1.0),
                          updir=params.find_point("updir", (0, 1, 0)))
        elif kind == "volumegrid":
            common.update(density=params.find_floats("density"),
                          density_shape=(params.find_one("nx", 1),
                                         params.find_one("ny", 1),
                                         params.find_one("nz", 1)))
        elif kind != "homogeneous":
            return
        self.builder.add_volume(kind, **common)

    def _make_texture(self, tex_class, tex_type, params) -> int:
        """Texture (tpuprt/scene/parser.py:526-619)."""
        b = self.builder
        is_float = tex_type == "float"
        # 2D mapping parameters (core/texture.cpp:63-82 defaults).
        mapping = params.find_one("mapping", "uv")
        fp = np.zeros(16, np.float32)
        fp[8] = params.find_one("uscale", 1.0)
        fp[9] = params.find_one("vscale", 1.0)
        fp[10] = params.find_one("udelta", 0.0)
        fp[11] = params.find_one("vdelta", 0.0)
        if mapping == "planar":
            fp[0:3] = params.find_point("v1", (1, 0, 0))
            fp[3:6] = params.find_point("v2", (0, 1, 0))
            fp[6] = params.find_one("udelta", 0.0)
            fp[7] = params.find_one("vdelta", 0.0)
        w2t = np.linalg.inv(self.ctm).astype(np.float32)

        def child(name, default):
            if params.is_texture(name):
                return self.named_textures[params.texture_name(name)]
            if is_float:
                # A float texture's constant child; tpuprt's float() of a
                # colour default raises here (tpuprt/scene/parser.py:548).
                return b.constant_texture(params.find_one(
                    name, float(np.ravel(default)[0])))
            return b.constant_texture(params.find_spectrum(name, default))

        if tex_class == "constant":
            return b.constant_texture(params.find_spectrum("value",
                                                           (1.0,) * 3))
        if tex_class == "scale":
            return b.add_texture(TexNodeMeta("scale", children=(
                child("tex1", (1,) * 3), child("tex2", (1,) * 3))))
        if tex_class == "mix":
            return b.add_texture(TexNodeMeta("mix", children=(
                child("tex1", (0,) * 3), child("tex2", (1,) * 3),
                child("amount", 0.5))))
        if tex_class == "bilerp":
            v = np.zeros(16, np.float32)
            v[0:3] = params.find_spectrum("v00", (0.0,) * 3)
            v[3:6] = params.find_spectrum("v01", (1.0,) * 3)
            v[6:9] = params.find_spectrum("v10", (0.0,) * 3)
            v[9:12] = params.find_spectrum("v11", (1.0,) * 3)
            return b.add_texture(TexNodeMeta("bilerp", mapping=mapping),
                                 fparams=v)
        if tex_class == "uv":
            return b.add_texture(TexNodeMeta("uv", mapping=mapping),
                                 fparams=fp)
        if tex_class == "checkerboard":
            children = (child("tex1", (1,) * 3), child("tex2", (0,) * 3))
            if params.find_one("dimension", 2) == 3:
                return b.add_texture(TexNodeMeta(
                    "checkerboard3d", children=children), w2t=w2t)
            return b.add_texture(TexNodeMeta(
                "checkerboard2d", mapping=mapping, children=children,
                aamode=params.find_one("aamode", "closedform")), fparams=fp)
        if tex_class == "dots":
            return b.add_texture(TexNodeMeta(
                "dots", mapping=mapping, children=(
                    child("inside", (1,) * 3), child("outside", (0,) * 3))),
                fparams=fp)
        if tex_class in ("fbm", "wrinkled"):
            v = np.zeros(16, np.float32)
            v[0] = params.find_one("octaves", 8)
            v[1] = params.find_one("roughness", 0.5)
            return b.add_texture(TexNodeMeta(tex_class, mapping="3d"),
                                 fparams=v, w2t=w2t)
        if tex_class == "windy":
            return b.add_texture(TexNodeMeta("windy", mapping="3d"), w2t=w2t)
        if tex_class == "marble":
            v = np.zeros(16, np.float32)
            v[0] = params.find_one("octaves", 8)
            v[1] = params.find_one("roughness", 0.5)
            v[2] = params.find_one("scale", 1.0)
            v[3] = params.find_one("variation", 0.2)
            return b.add_texture(TexNodeMeta("marble", mapping="3d"),
                                 fparams=v, w2t=w2t)
        if tex_class == "imagemap":
            wrap = {"repeat": 0, "black": 1, "clamp": 2}.get(
                params.find_one("wrap", "repeat"), 0)
            img = self._load_image(params.find_one("filename", ""), wrap)
            return b.add_texture(TexNodeMeta(
                "imagemap", image=img, mapping=mapping, float_from_y=is_float,
                trilinear=bool(params.find_one("trilinear", False))),
                fparams=fp)
        # Any other class: a constant gray, as tpuprt reads it.
        return b.constant_texture((0.5,) * 3)

    def _load_image(self, fname: str, wrap: int = 0) -> int:
        """An EXR named relative to the scene file's directory, as a MIP
        pyramid; one per (file name, wrap)."""
        key = f"{fname}|{wrap}"
        if key not in self._image_cache:
            rgb, _ = read_exr(os.path.join(self.basedir, fname))
            self._image_cache[key] = self.builder.add_image(
                build_pyramid(rgb), wrap)
        return self._image_cache[key]

    def _make_light(self, kind: str, params: ParamSet):
        """LightSource (tpuprt/scene/parser.py:635-682)."""
        b = self.builder
        l2w = self.ctm
        if kind == "point":
            b.add_point_light(
                l2w @ np.asarray(tfm.translate(
                    params.find_point("from", (0, 0, 0))), np.float32),
                params.find_spectrum("I", (1.0,) * 3))
        elif kind == "spot":
            frm = params.find_point("from", (0, 0, 0))
            dir_ = params.find_point("to", (0, 0, 1)) - frm
            dir_ = dir_ / max(np.linalg.norm(dir_), 1e-12)
            _, du, dv = self._coord_sys(dir_)
            m = np.eye(4, dtype=np.float32)
            m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = du, dv, dir_, frm
            b.add_spot_light(l2w @ m, params.find_spectrum("I", (1.0,) * 3),
                             params.find_one("coneangle", 30.0),
                             params.find_one("conedeltaangle", 5.0))
        elif kind == "distant":
            b.add_distant_light(
                l2w, params.find_spectrum("L", (1.0,) * 3),
                params.find_point("from", (0, 0, 0)),
                params.find_point("to", (0, 0, 1)))
        elif kind in ("infinite", "infinitesample"):
            fname = params.find_one("mapname", "")
            b.add_infinite_light(
                l2w, params.find_spectrum("L", (1.0,) * 3),
                self._load_image(fname) if fname else -1,
                params.find_one("nsamples", 1),
                importance=kind == "infinitesample")
        elif kind == "projection":
            fname = params.find_one("mapname", "")
            img = self._load_image(fname) if fname else -1
            aspect = 1.0
            if img >= 0:
                lv = b.images[img][0][0]
                aspect = lv.shape[1] / lv.shape[0]
            b.add_projection_light(l2w, params.find_spectrum("I", (1.0,) * 3),
                                   params.find_one("fov", 45.0), img, aspect)
        elif kind == "goniometric":
            fname = params.find_one("mapname", "")
            b.add_goniometric_light(
                l2w, params.find_spectrum("I", (1.0,) * 3),
                self._load_image(fname) if fname else -1)
        # Another kind makes no light (tpuprt/scene/parser.py:635-682).

    @staticmethod
    def _coord_sys(v):
        """tpuprt's CoordinateSystem on the host (tpuprt/scene/parser.py:
        684-694)."""
        if abs(v[0]) > abs(v[1]):
            inv = 1.0 / math.sqrt(v[0] ** 2 + v[2] ** 2)
            u = np.array([-v[2] * inv, 0, v[0] * inv])
        else:
            inv = 1.0 / math.sqrt(v[1] ** 2 + v[2] ** 2)
            u = np.array([0, v[2] * inv, -v[1] * inv])
        return v, u, np.cross(v, u)

    def _make_shape(self, kind: str, params: ParamSet, ctm, gs):
        """Shape (tpuprt/scene/parser.py:696-763) under `ctm` with the
        graphics state `gs` (_gs): the material is made first, then the
        shape (a tessellated one as a triangle mesh), then its area
        light."""
        b = self.builder
        mat_ref, al, ro = gs
        mat = self._gs_material(mat_ref)
        if kind not in MESH_KINDS + QUADRIC_KINDS:
            return                # tpuprt makes the material, no shape
        one = params.find_one
        if kind in MESH_KINDS:
            P, idx, N, uv = _mesh_arrays(kind, params)
            S = params.find_floats("S") if kind == "trianglemesh" else None
            mid = b.add_trianglemesh(ctm, idx, P, N, uv, S, mat,
                                     reverse_orientation=ro)
            if al is not None:
                b.add_area_light_mesh(mid, al.find_spectrum("L", (1.0,) * 3),
                                      al.find_one("nsamples", 1))
            return
        if kind == "sphere":
            r = one("radius", 1.0)
            qid = b.add_sphere(ctm, r, one("zmin", -r), one("zmax", r),
                               one("phimax", 360.0), mat, -1, ro)
        elif kind == "cylinder":
            qid = b.add_cylinder(ctm, one("radius", 1.0), one("zmin", -1.0),
                                 one("zmax", 1.0), one("phimax", 360.0), mat,
                                 -1, ro)
        elif kind == "disk":
            qid = b.add_disk(ctm, one("height", 0.0), one("radius", 1.0),
                             one("innerradius", 0.0), one("phimax", 360.0),
                             mat, -1, ro)
        elif kind == "cone":
            qid = b.add_cone(ctm, one("radius", 1.0), one("height", 1.0),
                             one("phimax", 360.0), mat, -1, ro)
        elif kind == "paraboloid":
            r = one("radius", 1.0)
            qid = b.add_paraboloid(ctm, r, one("zmin", 0.0),
                                   one("zmax", 1.0), one("phimax", 360.0),
                                   mat, -1, ro)
        else:
            qid = b.add_hyperboloid(ctm, params.find_point("p1", (0, 0, 0)),
                                    params.find_point("p2", (1, 1, 1)),
                                    one("phimax", 360.0), mat, -1, ro)
        # tpuprt attaches an area light to these three only (tpuprt/scene/
        # parser.py:702-733): a cone, paraboloid or hyperboloid under an
        # AreaLightSource emits nothing.
        if al is not None and kind in ("sphere", "cylinder", "disk"):
            b.add_area_light_sphere(qid, al.find_spectrum("L", (1.0,) * 3),
                                    al.find_one("nsamples", 1))

    def finish(self):
        """MakeScene (api.cpp:484-529): camera + scene + options."""
        from ..render import RenderOptions
        fp = self.film_params
        xres = fp.find_one("xresolution", 640)
        yres = fp.find_one("yresolution", 480)
        crop = fp.find_floats("cropwindow")
        crop = tuple(float(c) for c in crop) if crop is not None \
            else (0.0, 1.0, 0.0, 1.0)
        c2w = np.linalg.inv(self.camera_w2c).astype(np.float32)
        p = self.camera_params
        hither = max(1e-4, p.find_one("hither", 1e-3))
        yon = min(p.find_one("yon", 1e30), 1e30)
        sopen = p.find_one("shutteropen", 0.0)
        sclose = p.find_one("shutterclose", 1.0)
        lensr = p.find_one("lensradius", 0.0)
        focal = p.find_one("focaldistance", 1e30)
        frameaspect = p.find_one("frameaspectratio",
                                 float(xres) / float(yres))
        screen = p.find_floats("screenwindow")
        if screen is None:
            screen = cam.default_screen_window(xres, yres, frameaspect)
        if self.camera_name not in ("perspective", "orthographic"):
            # "environment", and any other name as tpuprt reads it
            # (tpuprt/scene/parser.py:830-832).
            camera = cam.build_environment(c2w, hither, yon, sopen, sclose)
        else:
            kind, proj = (
                (D.CAMERA_PERSPECTIVE, tfm.perspective(p.find_one(
                    "fov", 90.0), hither, yon))
                if self.camera_name == "perspective" else
                (D.CAMERA_ORTHOGRAPHIC, tfm.orthographic(hither, yon)))
            camera = cam.build_projective(
                kind, c2w, np.asarray(proj), screen, xres, yres, hither,
                yon, sopen, sclose, lensr, focal)
        self.builder.set_camera(camera)
        # tpuprt's mapping (tpuprt/scene/parser.py:834-847): "stratified"
        # and "random" are themselves; "lowdiscrepancy", pbrt-v1's default
        # "bestcandidate" and any other name take the (0,2)-sequences.
        sp = self.sampler_params
        if self.sampler_name == "stratified":
            scfg = SamplerConfig(kind="stratified",
                                 xsamples=sp.find_one("xsamples", 2),
                                 ysamples=sp.find_one("ysamples", 2),
                                 jitter=sp.find_one("jitter", True))
        elif self.sampler_name == "random":
            scfg = SamplerConfig(kind="random",
                                 pixelsamples=sp.find_one("pixelsamples", 4))
        else:
            scfg = SamplerConfig(kind="lowdiscrepancy",
                                 pixelsamples=sp.find_one("pixelsamples", 4))
        # The filter's widths, as tpuprt reads them: its "B"/"C",
        # "alpha" and "tau" keep their defaults (tpuprt/render.py:158-160).
        # Another name keeps widths (2, 2) and fails where the render
        # evaluates it, as tpuprt's (filters.evaluate).
        fw = DEFAULT_WIDTHS.get(self.filter_name, (2.0, 2.0))
        # Another integrator name is directlighting (tpuprt/scene/
        # parser.py:909).
        integrator = self.integrator_name if self.integrator_name in (
            "directlighting", "path", "whitted", "debug", "photonmap",
            "exphotonmap", "igi", "irradiancecache", "bidirectional") \
            else "directlighting"
        # CreateSurfaceIntegrator's parameters, read as tpuprt reads them
        # (tpuprt/scene/parser.py:850-914): finalgather defaults to true.
        ip = self.integrator_params
        photon = igi_p = irrad = ()
        if self.integrator_name == "photonmap":
            # photonmap.cpp:511-524.
            photon = PhotonParams(
                caustic=ip.find_one("causticphotons", 20000),
                direct=ip.find_one("directphotons", 100000),
                indirect=ip.find_one("indirectphotons", 100000),
                max_dist=ip.find_one("maxdist", 0.1),
                final_gather=bool(ip.find_one("finalgather", True)),
                gather_samples=ip.find_one("finalgathersamples", 32),
                direct_with_photons=bool(ip.find_one("directwithphotons",
                                                     False)))
        elif self.integrator_name == "exphotonmap":
            # exphotonmap.cpp:709-727.
            photon = ExPhotonParams(
                caustic=ip.find_one("causticphotons", 20000),
                indirect=ip.find_one("indirectphotons", 100000),
                direct=ip.find_one("directphotons", 100000),
                max_dist=ip.find_one("maxdist", 0.1),
                final_gather=bool(ip.find_one("finalgather", True)),
                gather_samples=ip.find_one("finalgathersamples", 32),
                gather_angle=ip.find_one("gatherangle", 10.0),
                max_specular_depth=ip.find_one("maxspeculardepth", 5))
        elif self.integrator_name == "igi":
            # igi.cpp:288-295.
            igi_p = IgiParams(
                nlights=ip.find_one("nlights", 64),
                nsets=ip.find_one("nsets", 4),
                mindist=ip.find_one("mindist", 0.1),
                rrthreshold=ip.find_one("rrthreshold", 0.05),
                indirectscale=ip.find_one("indirectscale", 1.0))
        elif self.integrator_name == "irradiancecache":
            # irradiancecache.cpp:363-370.
            irrad = IrradParams(
                maxerror=ip.find_one("maxerror", 0.2),
                maxspeculardepth=ip.find_one("maxspeculardepth", 5),
                maxindirectdepth=ip.find_one("maxindirectdepth", 3),
                nsamples=ip.find_one("nsamples", 4096))
        opts = RenderOptions(
            xres=xres, yres=yres, sampler=scfg, filter_kind=self.filter_name,
            filter_xwidth=self.filter_params.find_one("xwidth", fw[0]),
            filter_ywidth=self.filter_params.find_one("ywidth", fw[1]),
            integrator=integrator,
            volume_integrator=("single" if self.volume_integrator_name ==
                               "single" else "emission"),
            max_depth=self.integrator_params.find_one("maxdepth", 5),
            filename=fp.find_one("filename", "pbrt.exr"), crop=crop,
            writefrequency=fp.find_one("writefrequency", -1),
            photon=photon, igi=igi_p, irrad=irrad)
        # Read and unused, as tpuprt reads it: the EXR is always linear.
        fp.find_one("premultiplyalpha", True)
        for ps, where in (
                (self.camera_params, f'Camera "{self.camera_name}"'),
                (self.sampler_params, f'Sampler "{self.sampler_name}"'),
                (fp, 'Film "image"'),
                (self.filter_params, f'PixelFilter "{self.filter_name}"'),
                (ip, f'SurfaceIntegrator "{self.integrator_name}"'),
                (self.accel_params, f'Accelerator "{self.accel_name}"')):
            ps.report_unused(where)
        return self.builder.build(), opts


def _mesh_arrays(kind: str, params: ParamSet):
    """(P, indices, N, uv) of a mesh-kind shape: a trianglemesh's own ("uv"
    or else "st"), or the tessellation of the others."""
    if kind != "trianglemesh":
        return tessellate(kind, params)
    uv = params.find_floats("uv")
    if uv is None:
        uv = params.find_floats("st")
    return (params.find_floats("P"), params.find_ints("indices"),
            params.find_floats("N"), uv)


def load_scene(path: str):
    """Parse a pbrt file: returns (SceneData on the CPU, RenderOptions).
    Image files are named relative to the file's directory."""
    with open(path) as f:
        return load_scene_string(f.read(), os.path.dirname(path) or ".")


def load_scene_string(text: str, basedir: str = "."):
    """Parse scene text; image files are named relative to `basedir`."""
    p = PbrtParser(basedir)
    p.parse_string(text)
    return p.finish()
