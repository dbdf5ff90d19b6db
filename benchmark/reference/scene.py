"""The reference's own reading of a pbrt-v1 scene file: the statements and
parameters the benchmark's scenes use, and nothing more. Anything else
raises, so a configuration the reference cannot check never passes
silently.

Returns a plain `Scene`: film and sampler sizes, the camera's matrices,
world-space triangles (with uv), quadrics (sphere, disk) with their
object transforms, materials and lights, all as numpy float64 on the host.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass, field

import numpy as np

_TOKEN = re.compile(r'"[^"]*"|\[|\]|[^\s\[\]"]+')


@dataclass
class Scene:
    xres: int = 640
    yres: int = 480
    spp: int = 4
    integrator: str = "directlighting"
    max_depth: int = 5
    strategy: str = "all"
    fov: float = 90.0
    cam2world: np.ndarray = None
    hither: float = 1e-3
    yon: float = 1e30
    # World-space triangles: verts [V,3], idx [T,3], uv [V,2], material [T]
    verts: np.ndarray = None
    idx: np.ndarray = None
    uv: np.ndarray = None
    tri_material: np.ndarray = None
    # Quadrics: dicts of kind ("sphere" | "disk"), o2w, radius, height,
    # material, area light id.
    quadrics: list = field(default_factory=list)
    # Materials: dicts of kind ("matte" | "glass" | "mirror") and their
    # values; a Kd is ("const", rgb) or ("checker", dict).
    materials: list = field(default_factory=list)
    # Lights in declaration order: dicts of kind ("infinite" | "distant" |
    # "area") and their values.
    lights: list = field(default_factory=list)


def _look_at(pos, look, up):
    pos, look, up = (np.asarray(v, np.float64) for v in (pos, look, up))
    d = look - pos
    d /= np.linalg.norm(d)
    right = np.cross(d, up)
    right /= np.linalg.norm(right)
    new_up = np.cross(right, d)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, new_up, d, pos
    return m


def _rotate(deg, axis):
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    s, c = math.sin(math.radians(deg)), math.cos(math.radians(deg))
    x, y, z = a
    m = np.eye(4)
    m[:3, :3] = [[x * x + (1 - x * x) * c, x * y * (1 - c) - z * s,
                  x * z * (1 - c) + y * s],
                 [x * y * (1 - c) + z * s, y * y + (1 - y * y) * c,
                  y * z * (1 - c) - x * s],
                 [x * z * (1 - c) - y * s, y * z * (1 - c) + x * s,
                  z * z + (1 - z * z) * c]]
    return m


def _translate(v):
    m = np.eye(4)
    m[:3, 3] = v
    return m


class _Tokens:
    def __init__(self, text):
        text = re.sub(r"#[^\n]*", "", text)
        self.toks = _TOKEN.findall(text)
        self.i = 0

    def more(self):
        return self.i < len(self.toks)

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def peek(self):
        return self.toks[self.i] if self.more() else None

    def numbers(self, n):
        out = [float(self.next()) for _ in range(n)]
        return out

    def params(self):
        """The parameter list after a statement's name: {name: (type,
        values)}; values a list of strings or a float64 array."""
        out = {}
        while self.more() and self.peek().startswith('"'):
            decl = self.next().strip('"').split()
            if self.peek() == "[":
                self.next()
                j = self.toks.index("]", self.i)
                vals = self.toks[self.i:j]
                self.i = j + 1
            else:
                vals = [self.next()]
            typ, name = decl[0], decl[1]
            if typ in ("string", "texture", "bool"):
                out[name] = (typ, [v.strip('"') for v in vals])
            else:
                out[name] = (typ, np.asarray(vals, np.float64))
        return out


def _one(params, name, default):
    if name not in params:
        return default
    v = params[name][1]
    return v[0] if isinstance(v, list) else float(v[0])


def _rgb(params, name, default):
    if name not in params:
        return np.asarray(default, np.float64)
    return np.asarray(params[name][1], np.float64)[:3]


def _check(params, allowed, what):
    extra = set(params) - set(allowed)
    if extra:
        raise NotImplementedError(f"{what}: parameters {sorted(extra)}")


def load(path: str) -> Scene:
    with open(path) as f:
        return parse(f.read())


def parse(text: str) -> Scene:
    sc = Scene()
    ts = _Tokens(text)
    ctm = np.eye(4)
    stack = []
    textures = {}
    material = {"kind": "matte", "Kd": ("const", np.full(3, 0.5))}
    area = None
    mats_seen = {}

    def mat_id(m):
        key = repr(m)
        if key not in mats_seen:
            mats_seen[key] = len(sc.materials)
            sc.materials.append(m)
        return mats_seen[key]

    tris_v, tris_i, tris_uv, tris_m = [], [], [], []
    nverts = 0
    while ts.more():
        st = ts.next()
        if st == "LookAt":
            ctm = ctm @ np.linalg.inv(_look_at(*np.reshape(ts.numbers(9),
                                                           (3, 3))))
        elif st == "Translate":
            ctm = ctm @ _translate(ts.numbers(3))
        elif st == "Rotate":
            v = ts.numbers(4)
            ctm = ctm @ _rotate(v[0], v[1:])
        elif st in ("AttributeBegin", "TransformBegin"):
            stack.append((ctm, material, area))
        elif st in ("AttributeEnd", "TransformEnd"):
            ctm, m, a = stack.pop()
            if st == "AttributeEnd":
                material, area = m, a
        elif st == "WorldBegin":
            ctm = np.eye(4)
        elif st == "WorldEnd":
            pass
        else:
            kind = ts.next().strip('"')
            cls = None
            if st == "Texture":         # Texture "name" "type" "class"
                ts.next()
                cls = ts.next().strip('"')
            p = ts.params()
            if st == "Film":
                _check(p, ("xresolution", "yresolution", "filename"), st)
                sc.xres = int(_one(p, "xresolution", 640))
                sc.yres = int(_one(p, "yresolution", 480))
            elif st == "Camera":
                if kind != "perspective":
                    raise NotImplementedError(f"camera {kind}")
                _check(p, ("fov",), st)
                sc.fov = _one(p, "fov", 90.0)
                sc.cam2world = np.linalg.inv(ctm)
            elif st == "Sampler":
                if kind != "lowdiscrepancy":
                    raise NotImplementedError(f"sampler {kind}")
                n = int(_one(p, "pixelsamples", 4))
                sc.spp = 1 << max(0, (n - 1).bit_length())
            elif st == "PixelFilter":
                if kind != "box" or _one(p, "xwidth", 0.5) > 0.5 or \
                        _one(p, "ywidth", 0.5) > 0.5:
                    raise NotImplementedError("a filter wider than a pixel")
            elif st == "SurfaceIntegrator":
                if kind not in ("directlighting", "path"):
                    raise NotImplementedError(f"integrator {kind}")
                _check(p, ("maxdepth", "strategy"), st)
                sc.integrator = kind
                sc.max_depth = int(_one(p, "maxdepth", 5))
                sc.strategy = _one(p, "strategy", "all")
                if sc.strategy != "all":
                    raise NotImplementedError(f"strategy {sc.strategy}")
            elif st == "Texture":
                if cls != "checkerboard":
                    raise NotImplementedError(f"texture {cls}")
                _check(p, ("uscale", "vscale", "udelta", "vdelta", "tex1",
                           "tex2", "dimension", "aamode", "mapping"), st)
                if _one(p, "dimension", 2) != 2 or \
                        _one(p, "mapping", "uv") != "uv" or \
                        _one(p, "aamode", "closedform") != "closedform":
                    raise NotImplementedError("checkerboard variant")
                textures[kind] = dict(
                    su=_one(p, "uscale", 1.0), sv=_one(p, "vscale", 1.0),
                    du=_one(p, "udelta", 0.0), dv=_one(p, "vdelta", 0.0),
                    tex1=_rgb(p, "tex1", (1, 1, 1)),
                    tex2=_rgb(p, "tex2", (0, 0, 0)))
            elif st == "Material":
                if kind == "matte":
                    _check(p, ("Kd", "sigma"), st)
                    if _one(p, "sigma", 0.0) != 0.0:
                        raise NotImplementedError("Oren-Nayar sigma")
                    if "Kd" in p and p["Kd"][0] == "texture":
                        kd = ("checker", textures[p["Kd"][1][0]])
                    else:
                        kd = ("const", _rgb(p, "Kd", (0.5,) * 3))
                    material = {"kind": "matte", "Kd": kd}
                elif kind == "glass":
                    _check(p, ("Kr", "Kt", "index"), st)
                    material = {"kind": "glass",
                                "Kr": _rgb(p, "Kr", (1, 1, 1)),
                                "Kt": _rgb(p, "Kt", (1, 1, 1)),
                                "index": _one(p, "index", 1.5)}
                elif kind == "mirror":
                    _check(p, ("Kr",), st)
                    material = {"kind": "mirror",
                                "Kr": _rgb(p, "Kr", (0.9,) * 3)}
                else:
                    raise NotImplementedError(f"material {kind}")
            elif st == "LightSource":
                if kind == "infinite":
                    _check(p, ("L",), st)
                    sc.lights.append({"kind": "infinite",
                                      "L": _rgb(p, "L", (1, 1, 1))})
                elif kind == "distant":
                    _check(p, ("L", "from", "to"), st)
                    d = _rgb(p, "from", (0, 0, 0)) - _rgb(p, "to", (0, 0, 1))
                    d = ctm[:3, :3] @ d
                    sc.lights.append({"kind": "distant",
                                      "L": _rgb(p, "L", (1, 1, 1)),
                                      "dir": d / np.linalg.norm(d),
                                      "origin": ctm[:3, 3].copy()})
                else:
                    raise NotImplementedError(f"light {kind}")
            elif st == "AreaLightSource":
                _check(p, ("L",), st)
                area = _rgb(p, "L", (1, 1, 1))
            elif st == "Shape":
                if np.linalg.det(ctm[:3, :3]) < 0:
                    raise NotImplementedError("a mirrored transform")
                mid = mat_id(material)
                if kind == "trianglemesh":
                    _check(p, ("indices", "P", "uv"), st)
                    if area is not None:
                        raise NotImplementedError("an emissive mesh")
                    P = p["P"][1].reshape(-1, 3)
                    P = P @ ctm[:3, :3].T + ctm[:3, 3]
                    idx = p["indices"][1].astype(np.int64).reshape(-1, 3)
                    uv = p["uv"][1].reshape(-1, 2) if "uv" in p else \
                        np.zeros((len(P), 2))
                    tris_v.append(P)
                    tris_i.append(idx + nverts)
                    tris_uv.append(uv)
                    tris_m.append(np.full(len(idx), mid))
                    nverts += len(P)
                elif kind in ("sphere", "disk"):
                    _check(p, ("radius", "height"), st)
                    q = {"kind": kind, "o2w": ctm.copy(),
                         "radius": _one(p, "radius", 1.0),
                         "height": _one(p, "height", 0.0),
                         "material": mid, "light": -1}
                    if area is not None:
                        if kind != "disk":
                            raise NotImplementedError("an emissive sphere")
                        q["light"] = len(sc.lights)
                        r = q["radius"]
                        sc.lights.append({"kind": "area", "L": area,
                                          "quadric": len(sc.quadrics),
                                          "area": math.pi * r * r})
                    sc.quadrics.append(q)
                else:
                    raise NotImplementedError(f"shape {kind}")
            else:
                raise NotImplementedError(f"statement {st}")
    sc.verts = np.concatenate(tris_v) if tris_v else np.zeros((0, 3))
    sc.idx = np.concatenate(tris_i) if tris_i else np.zeros((0, 3), np.int64)
    sc.uv = np.concatenate(tris_uv) if tris_uv else np.zeros((0, 2))
    sc.tri_material = np.concatenate(tris_m) if tris_m else \
        np.zeros(0, np.int64)
    return sc
