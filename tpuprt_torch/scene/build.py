"""Host-side scene compilation: builder calls -> SceneData (port of
tpuprt/scene/build.py: quadrics, triangle meshes and their ObjectInstance
prototypes, emissive ones included, every material with its bump texture,
the texture graph and its MIP pyramids, every light kind (point, spot,
distant, projection, goniometric, infinite with or without a map and its
importance tables, area lights on a quadric, a triangle mesh or an
instanced prototype), the volume regions, and the accelerator policy: the
BVH, the uniform grid, the kd-tree, or none).

All assembly is host numpy with the reference's exact operations, so the
finished tables equal the JAX package's bit for bit; `build()` wraps them
as CPU tensors (render() moves them to its device).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..accel.bvh_build import build_bvh
from ..accel.grid_build import build_grid
from ..accel.instances import build_instances
from ..accel.kdtree_build import build_kdtree
from ..core import transform as tf
from ..materials.factory import MATERIAL_KINDS, build_templates
from ..textures.graph import TexGraph, TexNodeMeta, check_node
from ..utils import errors
from . import data as D


@dataclass
class _Quadric:
    kind: int
    o2w: np.ndarray
    params: np.ndarray
    material: int
    area_light: int
    flip: float


@dataclass
class _Mesh:
    verts: np.ndarray          # world space [V,3]
    idx: np.ndarray            # [T,3]
    normals: Optional[np.ndarray]
    uv: Optional[np.ndarray]
    tangents: Optional[np.ndarray]
    material: int
    flip: float
    area_light: int = -1


@dataclass
class _Light:
    kind: int
    l2w: np.ndarray
    spectrum: np.ndarray
    params: np.ndarray = field(default_factory=lambda: np.zeros(
        8, np.float32))
    nsamples: int = 1
    image: int = -1
    importance: bool = False
    area_geom_kind: int = D.AREA_GEOM_QUADRIC
    area_first: int = 0
    area_count: int = 1
    area_total: float = 0.0
    tri_areas: Optional[np.ndarray] = None


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


_TWO_PI = 2.0 * math.pi - 1e-6


def _quadric_static_row(kind: int, params) -> Tuple[int, bool, bool]:
    """QuadricTable.static_rows' facts of one quadric (tpuprt/scene/
    build.py:27-47): (kind, phi_full, z_full). Only a sphere's z range can
    clip nothing, being bounded by +-radius; a disk has no z window."""
    p = np.asarray(params, np.float64)
    phimax = {D.QUADRIC_CONE: p[2], D.QUADRIC_HYPERBOLOID: p[6]}.get(kind,
                                                                      p[3])
    z_full = kind == D.QUADRIC_DISK
    if kind == D.QUADRIC_SPHERE:
        z_full = p[1] <= -p[0] * (1.0 - 1e-5) and p[2] >= p[0] * (1.0 - 1e-5)
    return (kind, bool(phimax >= _TWO_PI), bool(z_full))


class SceneBuilder:
    def __init__(self):
        self.quadrics: List[_Quadric] = []
        self.meshes: List[_Mesh] = []
        self.materials: List[Tuple[int, List[int], int]] = []
        self.tex_nodes: List[TexNodeMeta] = []
        self.tex_fparams: List[np.ndarray] = []
        self.tex_w2t: List[np.ndarray] = []
        self.images: List[Tuple[Tuple[np.ndarray, ...], int]] = []
        self.lights: List[_Light] = []
        self.protos: List[dict] = []
        self.instances: List[Tuple[int, np.ndarray]] = []
        self.instance_area_light: List[int] = []
        self.volumes: List[dict] = []
        self.camera: Optional[D.CameraData] = None
        self.accel_kind: str = "auto"
        # kd-tree SAH knobs from the Accelerator statement (isect_cost,
        # trav_cost, empty_bonus, max_prims, max_depth).
        self.accel_params: Dict[str, float] = {}
        self._const_cache: Dict[Tuple[float, float, float], int] = {}

    # ---- textures -------------------------------------------------------
    def add_texture(self, meta: TexNodeMeta, fparams=None, w2t=None) -> int:
        check_node(meta)
        fp = np.zeros(16, np.float32)
        if fparams is not None:
            fp[: len(fparams)] = np.asarray(fparams, np.float32)
        self.tex_nodes.append(meta)
        self.tex_fparams.append(fp)
        self.tex_w2t.append(np.eye(4, dtype=np.float32) if w2t is None
                            else np.asarray(w2t, np.float32))
        return len(self.tex_nodes) - 1

    def constant_texture(self, value) -> int:
        v = np.asarray(value, np.float32)
        if v.ndim == 0:
            v = np.repeat(v[None], 3)
        key = tuple(np.round(v, 7).tolist())
        if key in self._const_cache:
            return self._const_cache[key]
        tid = self.add_texture(TexNodeMeta(kind="constant"), fparams=v)
        self._const_cache[key] = tid
        return tid

    def add_image(self, levels: Tuple[np.ndarray, ...], wrap: int = 0) -> int:
        """A MIP pyramid (io/mipmap_build.build_pyramid) and its wrap mode
        (0 repeat, 1 black, 2 clamp)."""
        self.images.append((levels, wrap))
        return len(self.images) - 1

    # ---- materials ------------------------------------------------------
    def add_material(self, kind: str, tex_slots: List[int],
                     bump: int = -1) -> int:
        """`bump`: the displacement texture's node id, -1 for none. Another
        kind raises KeyError, as tpuprt's builder (the parser makes an
        unknown material matte before it gets here)."""
        slots = list(tex_slots) + [-1] * (8 - len(tex_slots))
        self.materials.append((MATERIAL_KINDS[kind], slots[:8], bump))
        return len(self.materials) - 1

    def matte(self, kd=(0.5, 0.5, 0.5), sigma=0.0):
        return self.add_material("matte", [self.constant_texture(kd),
                                           self.constant_texture(sigma)])

    # ---- shapes ---------------------------------------------------------
    def _add_quadric(self, kind, o2w, params, material, area_light,
                     reverse_orientation):
        o2w = np.asarray(o2w, np.float32)
        flip = -1.0 if (reverse_orientation ^ tf.swaps_handedness(o2w)) \
            else 1.0
        self.quadrics.append(_Quadric(kind, o2w,
                                      np.asarray(params, np.float32),
                                      material, area_light, flip))
        return len(self.quadrics) - 1

    def add_sphere(self, o2w, radius=1.0, zmin=None, zmax=None, phimax=360.0,
                   material=0, area_light=-1, reverse_orientation=False):
        zmin = -radius if zmin is None else max(zmin, -radius)
        zmax = radius if zmax is None else min(zmax, radius)
        # thetamin = acos(zmin) > thetamax = acos(zmax), stored as the
        # reference does (sphere.cpp:93-98).
        thetamin = math.acos(np.clip(zmin / radius, -1, 1))
        thetamax = math.acos(np.clip(zmax / radius, -1, 1))
        return self._add_quadric(
            D.QUADRIC_SPHERE, o2w, [radius, zmin, zmax, math.radians(phimax),
                                    thetamin, thetamax, 0, 0],
            material, area_light, reverse_orientation)

    def add_cylinder(self, o2w, radius=1.0, zmin=-1.0, zmax=1.0, phimax=360.0,
                     material=0, area_light=-1, reverse_orientation=False):
        return self._add_quadric(
            D.QUADRIC_CYLINDER, o2w,
            [radius, zmin, zmax, math.radians(phimax), 0, 0, 0, 0],
            material, area_light, reverse_orientation)

    def add_disk(self, o2w, height=0.0, radius=1.0, inner_radius=0.0,
                 phimax=360.0, material=0, area_light=-1,
                 reverse_orientation=False):
        return self._add_quadric(
            D.QUADRIC_DISK, o2w,
            [height, radius, inner_radius, math.radians(phimax), 0, 0, 0, 0],
            material, area_light, reverse_orientation)

    def add_cone(self, o2w, radius=1.0, height=1.0, phimax=360.0, material=0,
                 area_light=-1, reverse_orientation=False):
        return self._add_quadric(
            D.QUADRIC_CONE, o2w,
            [radius, height, math.radians(phimax), 0, 0, 0, 0, 0],
            material, area_light, reverse_orientation)

    def add_paraboloid(self, o2w, radius=1.0, zmin=0.0, zmax=1.0,
                       phimax=360.0, material=0, area_light=-1,
                       reverse_orientation=False):
        return self._add_quadric(
            D.QUADRIC_PARABOLOID, o2w,
            [radius, zmin, zmax, math.radians(phimax), 0, 0, 0, 0],
            material, area_light, reverse_orientation)

    def add_hyperboloid(self, o2w, p1=(0, 0, 0), p2=(1, 1, 1), phimax=360.0,
                        material=0, area_light=-1, reverse_orientation=False):
        """The implicit coefficients a, c of a(x^2 + y^2) - c z^2 = 1
        through p1 and p2, solved as tpuprt's builder solves them
        (scene/build.py:217-250; hyperboloid.cpp:38-70)."""
        p1 = np.asarray(p1, np.float64)
        p2 = np.asarray(p2, np.float64)
        if p2[2] == 0:
            p1, p2 = p2, p1
        pp = p1.copy()
        a = c = 0.0
        for _ in range(1000):
            pp = pp + 2.0 * (p2 - pp)
            xy1 = pp[0] ** 2 + pp[1] ** 2
            xy2 = p2[0] ** 2 + p2[1] ** 2
            denom = xy1 * p2[2] ** 2 - xy2 * pp[2] ** 2
            if abs(denom) > 1e-12:
                a = 1.0 * (pp[2] ** 2) - 1.0 * (p2[2] ** 2)
                m = np.array([[xy1, -pp[2] ** 2], [xy2, -p2[2] ** 2]])
                try:
                    a, c = np.linalg.solve(m, np.ones(2))
                    if not (math.isinf(a) or math.isnan(a)):
                        break
                except np.linalg.LinAlgError:
                    continue
        return self._add_quadric(
            D.QUADRIC_HYPERBOLOID, o2w,
            [a, c, p1[2], p1[0], p1[1], p2[2], math.radians(phimax), 0],
            material, area_light, reverse_orientation)

    def add_trianglemesh(self, o2w, indices, P, N=None, uv=None, S=None,
                         material=0, reverse_orientation=False):
        """World-space mesh like the reference TriangleMesh ctor
        (shapes/trianglemesh.cpp:38-64 transforms verts to world)."""
        o2w = np.asarray(o2w, np.float32)
        P = np.asarray(P, np.float32).reshape(-1, 3)
        idx = np.asarray(indices, np.int32).reshape(-1, 3)
        vw = (P @ o2w[:3, :3].T) + o2w[:3, 3]
        nw = None
        if N is not None:
            n = np.asarray(N, np.float32).reshape(-1, 3)
            inv = np.linalg.inv(o2w)
            nw = n @ inv[:3, :3]  # inverse-transpose
            nw /= np.maximum(np.linalg.norm(nw, axis=-1, keepdims=True), 1e-12)
        sw = None
        if S is not None:
            s = np.asarray(S, np.float32).reshape(-1, 3)
            sw = s @ o2w[:3, :3].T
        uvw = np.asarray(uv, np.float32).reshape(-1, 2) \
            if uv is not None else None
        flip = -1.0 if (reverse_orientation ^ tf.swaps_handedness(o2w)) \
            else 1.0
        self.meshes.append(_Mesh(vw, idx, nw, uvw, sw, material, flip))
        return len(self.meshes) - 1

    def add_prototype(self, indices, P, N=None, uv=None, material=0,
                      reverse_orientation=False, o2w=None,
                      area_light_L=None, area_nsamples=1) -> int:
        """Object-space prototype mesh for ray-transform instancing
        (ObjectBegin geometry; o2w = the definition-time CTM, baked into
        the prototype's object space like api.cpp's shape transform).
        area_light_L: the radiance of an emissive prototype, each of whose
        instances becomes an area light (add_instance)."""
        P = np.asarray(P, np.float32).reshape(-1, 3)
        idx = np.asarray(indices, np.int32).reshape(-1, 3)
        nrm = None
        flip_swap = False
        if o2w is not None:
            o2w = np.asarray(o2w, np.float32)
            P = (P @ o2w[:3, :3].T) + o2w[:3, 3]
            flip_swap = tf.swaps_handedness(o2w)
            if N is not None:
                n = np.asarray(N, np.float32).reshape(-1, 3)
                inv = np.linalg.inv(o2w)
                nrm = n @ inv[:3, :3]
                nrm /= np.maximum(
                    np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
        elif N is not None:
            nrm = np.asarray(N, np.float32).reshape(-1, 3)
        uvw = np.asarray(uv, np.float32).reshape(-1, 2) \
            if uv is not None else None
        flip = -1.0 if (bool(reverse_orientation) ^ flip_swap) else 1.0
        self.protos.append(dict(
            verts=P, idx=idx, uv=uvw, normals=nrm, material=material,
            flip=flip, area_L=(np.asarray(area_light_L, np.float32)
                               if area_light_L is not None else None),
            area_nsamples=area_nsamples))
        return len(self.protos) - 1

    def add_instance(self, proto_id: int, o2w) -> int:
        """Place an instance of a prototype under transform o2w
        (ObjectInstance; pbrt-v1 core/primitive.cpp:66-85). An instance of
        an emissive prototype is its own area light (AREA_GEOM_INST): one
        LightTable row and one CDF segment over the shared object-space
        triangles, which needs a similarity transform (the relative areas
        must survive it), tested as tpuprt/scene/build.py:310-349 tests
        it."""
        o2w = np.asarray(o2w, np.float32)
        self.instances.append((proto_id, o2w))
        pr = self.protos[proto_id]
        lid = -1
        if pr["area_L"] is not None:
            A = o2w[:3, :3]
            det = float(np.linalg.det(A))
            s_lin = abs(det) ** (1.0 / 3.0)
            if not is_similarity(A):
                raise ValueError(
                    "instanced area emitters need a similarity transform "
                    "(rotation + uniform scale + translation)")
            v, idx = pr["verts"], pr["idx"]
            p0, p1, p2 = v[idx[:, 0]], v[idx[:, 1]], v[idx[:, 2]]
            areas = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0),
                                         axis=-1)
            params = np.zeros(8, np.float32)
            params[5] = 1.0 if det >= 0 else -1.0
            lid = len(self.lights)
            self.lights.append(_Light(
                D.LIGHT_AREA, o2w, pr["area_L"], params=params,
                nsamples=pr["area_nsamples"],
                area_geom_kind=D.AREA_GEOM_INST, area_first=proto_id,
                area_count=len(areas),
                area_total=float(areas.sum()) * s_lin * s_lin,
                tri_areas=areas))
        self.instance_area_light.append(lid)
        return len(self.instances) - 1

    # ---- lights ---------------------------------------------------------
    def add_point_light(self, l2w, intensity=(1.0,) * 3):
        """A point light at l2w's origin (lights/point.cpp)."""
        self.lights.append(_Light(D.LIGHT_POINT, np.asarray(l2w, np.float32),
                                  np.asarray(intensity, np.float32)))
        return len(self.lights) - 1

    def add_distant_light(self, l2w, L=(1.0,) * 3, frm=(0, 0, 0),
                          to=(0, 0, 1)):
        l2w = np.asarray(l2w, np.float32)
        d = np.asarray(frm, np.float64) - np.asarray(to, np.float64)
        dw = l2w[:3, :3] @ d
        dw /= np.linalg.norm(dw)
        params = np.zeros(8, np.float32)
        params[0:3] = dw
        self.lights.append(_Light(D.LIGHT_DISTANT, l2w,
                                  np.asarray(L, np.float32), params))
        return len(self.lights) - 1

    def add_spot_light(self, l2w, intensity=(1.0,) * 3, coneangle=30.0,
                       conedeltaangle=5.0):
        """A spot light at l2w's origin down its +z (lights/spot.cpp):
        params [cos total width, cos falloff start]."""
        params = np.zeros(8, np.float32)
        params[0] = math.cos(math.radians(coneangle))
        params[1] = math.cos(math.radians(coneangle - conedeltaangle))
        self.lights.append(_Light(D.LIGHT_SPOT, np.asarray(l2w, np.float32),
                                  np.asarray(intensity, np.float32), params))
        return len(self.lights) - 1

    def add_infinite_light(self, l2w, L=(1.0,) * 3, image=-1, nsamples=1,
                           importance=False):
        """importance: infinitesample (lights/infinitesample.cpp), whose
        luminance x sin(theta) tables are built over the map at build()."""
        self.lights.append(_Light(D.LIGHT_INFINITE,
                                  np.asarray(l2w, np.float32),
                                  np.asarray(L, np.float32),
                                  nsamples=nsamples, image=image,
                                  importance=importance and image >= 0))
        return len(self.lights) - 1

    def add_projection_light(self, l2w, intensity=(1.0,) * 3, fov=45.0,
                             image=-1, aspect=1.0):
        """lights/projection.cpp: params [1/tan(fov/2) twice, 0, 0, the
        screen window x0, x1, y0, y1 by the map's aspect]."""
        params = np.zeros(8, np.float32)
        inv_tan = 1.0 / math.tan(math.radians(fov) / 2.0)
        params[0] = inv_tan
        params[1] = inv_tan
        if aspect > 1.0:
            params[4:8] = [-aspect, aspect, -1.0, 1.0]
        else:
            params[4:8] = [-1.0, 1.0, -1.0 / aspect, 1.0 / aspect]
        self.lights.append(_Light(
            D.LIGHT_PROJECTION, np.asarray(l2w, np.float32),
            np.asarray(intensity, np.float32), params, image=image))
        return len(self.lights) - 1

    def add_goniometric_light(self, l2w, intensity=(1.0,) * 3, image=-1):
        self.lights.append(_Light(
            D.LIGHT_GONIOMETRIC, np.asarray(l2w, np.float32),
            np.asarray(intensity, np.float32), image=image))
        return len(self.lights) - 1

    def add_area_light_sphere(self, quadric_id: int, L=(1.0,) * 3,
                              nsamples=1):
        """Area light on a quadric: a sphere, disk or cylinder, the shapes
        pbrt-v1 implements Sample and Area for (sphere.cpp:45-86,
        disk.cpp:36-44,127-130, cylinder.cpp)."""
        q = self.quadrics[quadric_id]
        p = [float(x) for x in q.params]
        if q.kind == D.QUADRIC_SPHERE:
            area = p[3] * p[0] * (p[2] - p[1])      # phiMax r (zmax - zmin)
        elif q.kind == D.QUADRIC_DISK:
            area = 0.5 * p[3] * (p[1] * p[1] - p[2] * p[2])
        elif q.kind == D.QUADRIC_CYLINDER:
            area = (p[2] - p[1]) * p[0] * p[3]
        else:
            # tpuprt's builder warns and takes the sphere's formula
            # (tpuprt/scene/build.py:426-431); its parser never asks.
            errors.warning("area light on unsupported quadric kind "
                           f"{q.kind}; the reference Severe()s here "
                           "(core/shape.h:85-91). Using sphere formula.")
            area = p[3] * p[0] * abs(p[2] - p[1])
        self.lights.append(_Light(D.LIGHT_AREA, q.o2w,
                                  np.asarray(L, np.float32),
                                  nsamples=nsamples, area_first=quadric_id,
                                  area_total=area))
        q.area_light = len(self.lights) - 1
        return q.area_light

    def add_area_light_mesh(self, mesh_id: int, L=(1.0,) * 3, nsamples=1):
        """An area light on a triangle mesh (ShapeSet, core/shape.h:
        112-171): its triangles' areas make the pick CDF; the triangle
        range is resolved at build()."""
        m = self.meshes[mesh_id]
        v = m.verts
        p0, p1, p2 = v[m.idx[:, 0]], v[m.idx[:, 1]], v[m.idx[:, 2]]
        areas = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=-1)
        self.lights.append(_Light(
            D.LIGHT_AREA, np.eye(4, dtype=np.float32),
            np.asarray(L, np.float32), nsamples=nsamples,
            area_geom_kind=D.AREA_GEOM_TRIS, area_first=mesh_id,
            area_count=len(areas), area_total=float(areas.sum()),
            tri_areas=areas))
        m.area_light = len(self.lights) - 1
        return m.area_light

    # ---- volumes --------------------------------------------------------
    def add_volume(self, kind: str, v2w, p0=(0, 0, 0), p1=(1, 1, 1),
                   sigma_a=(1.0,) * 3, sigma_s=(1.0,) * 3, le=(0.0,) * 3,
                   g=0.0, a=1.0, b=1.0, updir=(0, 1, 0), density=None,
                   density_shape=None):
        """A "homogeneous", "exponential" or "volumegrid" region
        (volumes/*.cpp; tpuprt/scene/build.py:457-493): p0, p1 its
        object-space box, v2w the volume-to-world transform, density the
        grid's nx*ny*nz values (x fastest) of shape (nx, ny, nz)."""
        kinds = {"homogeneous": D.VOL_HOMOGENEOUS,
                 "exponential": D.VOL_EXPONENTIAL,
                 "volumegrid": D.VOL_GRID}
        v2w = np.asarray(v2w, np.float32)
        p0 = np.asarray(p0, np.float64)
        p1 = np.asarray(p1, np.float64)
        corners = np.array([[p0[0] if i & 1 else p1[0],
                             p0[1] if i & 2 else p1[1],
                             p0[2] if i & 4 else p1[2]] for i in range(8)])
        wc = corners @ v2w[:3, :3].T + v2w[:3, 3]
        # w2v maps world to the unit box over [p0, p1].
        span = np.where(np.abs(p1 - p0) < 1e-12, 1.0, p1 - p0)
        to_unit = np.eye(4)
        to_unit[:3, :3] = np.diag(1.0 / span)
        to_unit[:3, 3] = -p0 / span
        w2v = (to_unit @ np.linalg.inv(v2w)).astype(np.float32)
        dens = None
        if density is not None:
            nx, ny, nz = density_shape
            dens = np.asarray(density, np.float32).reshape(nz, ny, nx)
        self.volumes.append(dict(
            kind=kinds[kind], w2v=w2v,
            v2w=np.linalg.inv(w2v).astype(np.float32),
            lo=wc.min(0).astype(np.float32), hi=wc.max(0).astype(np.float32),
            sigma_a=np.asarray(sigma_a, np.float32),
            sigma_s=np.asarray(sigma_s, np.float32),
            le=np.asarray(le, np.float32), g=float(g),
            params=np.asarray([a, b, 0, 0], np.float32),
            # f64 for a tuple's norm; the table is f32, as tpuprt's
            # device_put makes it.
            updir=(np.asarray(updir, np.float32) /
                   max(np.linalg.norm(updir), 1e-12)).astype(np.float32),
            density=dens))
        return len(self.volumes) - 1

    # ---- camera ---------------------------------------------------------
    def set_camera(self, cam: D.CameraData):
        self.camera = cam

    # ---- build ----------------------------------------------------------
    def build(self) -> D.SceneData:
        qs = self.quadrics
        if qs:
            quad = D.QuadricTable(
                kind=_t(np.asarray([q.kind for q in qs], np.int32)),
                o2w=_t(np.stack([q.o2w for q in qs])),
                w2o=_t(np.stack([np.linalg.inv(q.o2w).astype(np.float32)
                                 for q in qs])),
                params=_t(np.stack([q.params for q in qs])),
                material=_t(np.asarray([q.material for q in qs], np.int32)),
                area_light=_t(np.asarray([q.area_light for q in qs],
                                         np.int32)),
                flip_normal=_t(np.asarray([q.flip for q in qs], np.float32)),
                count=len(qs),
                kinds_present=tuple(sorted({q.kind for q in qs})),
                static_rows=tuple(_quadric_static_row(q.kind, q.params)
                                  for q in qs))
        else:
            z, f32, i32 = np.zeros, np.float32, np.int32
            quad = D.QuadricTable(
                kind=_t(z(0, i32)), o2w=_t(z((0, 4, 4), f32)),
                w2o=_t(z((0, 4, 4), f32)), params=_t(z((0, 8), f32)),
                material=_t(z(0, i32)), area_light=_t(z(0, i32)),
                flip_normal=_t(z(0, f32)), static_rows=())

        verts_l, idx_l, n_l, uv_l, tan_l = [], [], [], [], []
        hasn_l, hast_l, mat_l, al_l, flip_l = [], [], [], [], []
        mesh_tri_offset = []
        voff = toff = 0
        for m in self.meshes:
            nt, nv = len(m.idx), len(m.verts)
            mesh_tri_offset.append(toff)
            toff += nt
            verts_l.append(m.verts)
            idx_l.append(m.idx + voff)
            n_l.append(m.normals if m.normals is not None
                       else np.zeros((nv, 3), np.float32))
            uv_l.append(m.uv if m.uv is not None
                        else np.zeros((nv, 2), np.float32))
            tan_l.append(m.tangents if m.tangents is not None
                         else np.zeros((nv, 3), np.float32))
            hasn_l.append(np.full(nt, m.normals is not None))
            hast_l.append(np.full(nt, m.tangents is not None))
            mat_l.append(np.full(nt, m.material, np.int32))
            al_l.append(np.full(nt, m.area_light, np.int32))
            flip_l.append(np.full(nt, m.flip, np.float32))
            voff += nv
        nt_total = sum(len(m.idx) for m in self.meshes)
        if nt_total:
            tri = D.TriangleTable(
                verts=_t(np.concatenate(verts_l)),
                idx=_t(np.concatenate(idx_l)),
                normals=_t(np.concatenate(n_l)),
                uv=_t(np.concatenate(uv_l)),
                tangents=_t(np.concatenate(tan_l)),
                has_normals=_t(np.concatenate(hasn_l)),
                has_tangents=_t(np.concatenate(hast_l)),
                material=_t(np.concatenate(mat_l)),
                area_light=_t(np.concatenate(al_l)),
                flip_normal=_t(np.concatenate(flip_l)), count=nt_total)
        else:
            # tpuprt's empty table (one dummy vertex).
            z = np.zeros
            tri = D.TriangleTable(
                verts=_t(z((1, 3), np.float32)),
                idx=_t(z((0, 3), np.int32)),
                normals=_t(z((1, 3), np.float32)),
                uv=_t(z((1, 2), np.float32)),
                tangents=_t(z((1, 3), np.float32)),
                has_normals=_t(z((0,), bool)), has_tangents=_t(z((0,), bool)),
                material=_t(z((0,), np.int32)),
                area_light=_t(z((0,), np.int32)),
                flip_normal=_t(z((0,), np.float32)), count=0)

        if not self.materials:
            self.matte()
        mats = self.materials
        tmpl = build_templates(mats)
        materials = D.MaterialTable(
            kind=_t(np.asarray([m[0] for m in mats], np.int32)),
            tex=_t(np.asarray([m[1] for m in mats], np.int32)),
            bump=_t(np.asarray([m[2] for m in mats], np.int32)),
            count=len(mats), has_bump=any(m[2] >= 0 for m in mats),
            lobe_kinds=tmpl.pop("lobe_kinds"),
            dist_kinds=tmpl.pop("dist_kinds"),
            **{k: _t(v) for k, v in tmpl.items()})

        textures = TexGraph(fparams=_t(np.stack(self.tex_fparams)),
                            w2t=_t(np.stack(self.tex_w2t)),
                            nodes=tuple(self.tex_nodes))

        nl = len(self.lights)
        ls = self.lights
        # A mesh emitter's first triangle, and every light's segment of the
        # packed area CDF (tpuprt/scene/build.py:603-628): a mesh emitter's
        # normalized cumulative triangle areas, [0, 1] for the others.
        proto_tri_offset = np.concatenate(
            [[0], np.cumsum([len(p["idx"]) for p in self.protos])]).astype(
                np.int64)
        cdf_flat: List[float] = []
        cdf_off, first = [], []
        max_cnt = 1
        for l in ls:
            cdf_off.append(len(cdf_flat))
            if l.kind == D.LIGHT_AREA and l.area_geom_kind in (
                    D.AREA_GEOM_TRIS, D.AREA_GEOM_INST):
                # A mesh's first global triangle; an instanced emitter's
                # first global prototype triangle (build_instances'
                # concatenation order).
                first.append(mesh_tri_offset[l.area_first]
                             if l.area_geom_kind == D.AREA_GEOM_TRIS
                             else proto_tri_offset[l.area_first])
                c = np.concatenate([[0.0], np.cumsum(l.tri_areas)])
                c /= max(c[-1], 1e-12)
                cdf_flat.extend(c.tolist())
                max_cnt = max(max_cnt, l.area_count)
            else:
                first.append(l.area_first)
                cdf_flat.extend([0.0, 1.0])
        # Importance tables: an infinite light's third meta element indexes
        # env_importance, -1 for cosine sampling.
        env_dists, inf_meta = [], []
        for i, l in enumerate(ls):
            if l.kind != D.LIGHT_INFINITE:
                continue
            imp = -1
            if l.importance:
                imp = len(env_dists)
                env_dists.append(_build_env_dist(self.images[l.image][0][0]))
            inf_meta.append((i, l.image, imp))
        i32 = lambda v: _t(np.asarray(v, np.int32))
        # A scene without lights gets tpuprt's empty table (tpuprt/scene/
        # build.py:665-674): its one CDF entry is 0.
        rows = lambda f, shape: _t(np.stack([f(l) for l in ls]) if ls else
                                   np.zeros((0,) + shape, np.float32))
        lt_tab = D.LightTable(
            kind=i32([l.kind for l in ls]),
            l2w=rows(lambda l: l.l2w, (4, 4)),
            w2l=rows(lambda l: np.linalg.inv(l.l2w).astype(np.float32),
                     (4, 4)),
            spectrum=rows(lambda l: l.spectrum, (3,)),
            params=rows(lambda l: l.params, (8,)),
            nsamples=i32([l.nsamples for l in ls]),
            image=i32([l.image for l in ls]),
            area_geom_kind=i32([l.area_geom_kind for l in ls]),
            area_first=i32(first),
            area_count=i32([l.area_count for l in ls]),
            area_total_area=_t(np.asarray([l.area_total for l in ls],
                                          np.float32)),
            cdf_offset=i32(cdf_off),
            area_cdf=_t(np.asarray(cdf_flat or [0.0], np.float32)),
            count=nl,
            kinds_present=tuple(sorted({l.kind for l in ls})),
            area_geoms_present=tuple(sorted({
                l.area_geom_kind for l in ls if l.kind == D.LIGHT_AREA})),
            kinds_list=tuple(int(l.kind) for l in ls),
            infinite_meta=tuple(inf_meta),
            dir_map_meta=tuple(
                (i, l.image) for i, l in enumerate(ls)
                if l.kind in (D.LIGHT_PROJECTION, D.LIGHT_GONIOMETRIC)
                and l.image >= 0),
            max_area_count=max_cnt)

        # World bound: each quadric's box of half-width max |params[0:3]|
        # (tpuprt/scene/build.py:685-702), each mesh's vertices.
        los, his = [], []
        for q in qs:
            r = float(np.abs(q.params[:3]).max()) + 1e-3
            corners = np.array([[sx, sy, sz] for sx in (-r, r)
                                for sy in (-r, r) for sz in (-r, r)])
            wc = corners @ q.o2w[:3, :3].T + q.o2w[:3, 3]
            los.append(wc.min(0))
            his.append(wc.max(0))
        for m in self.meshes:
            los.append(m.verts.min(0))
            his.append(m.verts.max(0))
        if los:
            wlo = np.minimum.reduce(los).astype(np.float32)
            whi = np.maximum.reduce(his).astype(np.float32)
        else:
            wlo = np.full(3, -1.0, np.float32)
            whi = np.full(3, 1.0, np.float32)

        # The volume regions; the world bound covers them
        # (tpuprt/scene/build.py:704-727).
        vols = None
        if self.volumes:
            vols = volume_table(self.volumes)
            for v in self.volumes:
                wlo = np.minimum(wlo, v["lo"])
                whi = np.maximum(whi, v["hi"])

        # Ray-transform instances (accel/instances.py): prototype BLAS
        # tables + per-instance transforms, each emissive prototype's
        # triangles and each instance's light; the world bound covers
        # them.
        inst_tab = None
        if self.instances:
            inst_tab = build_instances(self.protos, self.instances)
            inst_tab.tri_emissive = _t(np.concatenate(
                [np.full(len(p["idx"]), p["area_L"] is not None)
                 for p in self.protos]))
            inst_tab.inst_area_light = _t(np.asarray(
                self.instance_area_light, np.int32))
            wlo = np.minimum(wlo, inst_tab.bounds_lo.numpy())
            whi = np.maximum(whi, inst_tab.bounds_hi.numpy())

        # Accelerator (tpuprt/scene/build.py:755-779): "kdtree" builds the
        # kd-tree with the statement's SAH knobs; "bvh", or "auto" above
        # 4096 prims, the BVH; "grid", or "auto" between 65 and 4096 prims,
        # the grid; "auto" at 64 prims or fewer, "none" and any other name
        # leave none (brute force), as does an empty main aggregate.
        nprims = len(qs) + nt_total
        kind = self.accel_kind
        accel = None
        if nprims == 0:
            pass
        elif kind == "kdtree":
            kw = {k: v for k, v in self.accel_params.items()
                  if k in ("isect_cost", "trav_cost", "empty_bonus",
                           "max_prims", "max_depth")}
            accel = build_kdtree(quad, tri, **kw)
        elif kind == "bvh" or (kind == "auto" and nprims > 4096):
            accel = build_bvh(tri, quad)
        elif kind == "grid" or (kind == "auto" and nprims > 64):
            accel = build_grid(quad, tri)
        return D.SceneData(
            triangles=tri, materials=materials, textures=textures,
            lights=lt_tab, camera=self.camera, accel=accel,
            instances=inst_tab, quadrics=quad,
            images=pack_images(self.images) if self.images else None,
            env_importance=tuple(env_dists), volumes=vols,
            world_bound_lo=_t(wlo.astype(np.float32)),
            world_bound_hi=_t(whi.astype(np.float32)))


def is_similarity(A) -> bool:
    """Whether the 3x3 A is a rotation times a uniform scale, within
    tpuprt's tolerance 1e-4 max(s^2, 1) of A A^T = s^2 I, s = |det|^(1/3)
    (tpuprt/scene/build.py:324-328, parser.py:402-406)."""
    A = np.asarray(A, np.float32)
    s_lin = abs(float(np.linalg.det(A))) ** (1.0 / 3.0)
    return bool(np.allclose(A @ A.T, (s_lin * s_lin) * np.eye(3),
                            atol=1e-4 * max(s_lin * s_lin, 1.0)))


def volume_table(vv) -> D.VolumeTable:
    """The regions' rows, their density grids packed in one column."""
    cols, off, dims, grids, n = [], [], [], [], 0
    for r, v in enumerate(vv):
        g = v["density"]
        if g is None:
            off.append(-1)
            dims.append((0, 0, 0))
            continue
        off.append(n)
        dims.append(g.shape)
        grids.append((r, n) + tuple(int(x) for x in g.shape))
        cols.append(g.reshape(-1))
        n += g.size
    st = lambda k: _t(np.stack([v[k] for v in vv]))
    return D.VolumeTable(
        kind=_t(np.asarray([v["kind"] for v in vv], np.int32)),
        w2v=st("w2v"), v2w=st("v2w"), bound_lo=st("lo"), bound_hi=st("hi"),
        sigma_a=st("sigma_a"), sigma_s=st("sigma_s"), le=st("le"),
        g=_t(np.asarray([v["g"] for v in vv], np.float32)),
        params=st("params"), updir=st("updir"),
        density=_t(np.concatenate(cols) if cols
                   else np.zeros(1, np.float32)),
        grid_off=_t(np.asarray(off, np.int64)),
        grid_dims=_t(np.asarray(dims, np.int32)),
        grids=tuple(grids), count=len(vv))


def pack_images(images) -> D.ImageTable:
    """[(levels, wrap)] -> the packed ImageTable: every level's texels in
    one f32 column, level by level, image by image."""
    shape = (len(images), max(len(lv) for lv, _ in images))
    off = np.zeros(shape, np.int64)
    hh, ww = np.zeros(shape, np.int32), np.zeros(shape, np.int32)
    cols, n = [], 0
    for i, (levels, _) in enumerate(images):
        for li, lv in enumerate(levels):
            off[i, li], hh[i, li], ww[i, li] = n, lv.shape[0], lv.shape[1]
            cols.append(np.asarray(lv, np.float32).reshape(-1, 3))
            n += lv.shape[0] * lv.shape[1]
    return D.ImageTable(
        texels=_t(np.concatenate(cols)), level_off=_t(off),
        level_h=_t(hh), level_w=_t(ww),
        nlevels=tuple(len(lv) for lv, _ in images),
        wrap=tuple(int(w) for _, w in images), count=len(images))


def _build_env_dist(finest: np.ndarray) -> D.EnvDist:
    """infinitesample's importance tables from a map's finest level
    (tpuprt/scene/build.py:793-830; lights/infinitesample.cpp:102-133):
    the luminance blurred by a wrapping separable [1/4 1/2 1/4] (the
    radiance lookup interpolates neighbouring texels, so the importance
    must cover them), weighted by sin(theta) of each row's centre and
    floored at 1e-9, then each column's step CDF over rows and the
    marginal's over columns (ComputeStep1dCDF, core/mc.cpp:31-53)."""
    img = np.asarray(finest, np.float32)
    nv, nu = img.shape[0], img.shape[1]          # rows theta, columns phi
    yw = np.asarray([0.212671, 0.715160, 0.072169], np.float32)
    lum = img @ yw                               # [nv, nu]
    for ax in (0, 1):
        lum = 0.5 * lum + 0.25 * (np.roll(lum, 1, ax) + np.roll(lum, -1, ax))
    sin_t = np.sin(np.pi * (np.arange(nv) + 0.5) / nv).astype(np.float32)
    func_v = np.maximum((lum * sin_t[:, None]).T.astype(np.float32), 1e-9)

    def step_cdf(f):
        n = f.shape[-1]
        cdf = np.concatenate([np.zeros(f.shape[:-1] + (1,), np.float32),
                              np.cumsum(f / n, axis=-1)], -1)
        func_int = cdf[..., -1].copy()
        cdf /= np.maximum(func_int[..., None], 1e-20)
        return cdf.astype(np.float32), func_int.astype(np.float32)

    cdf_v, int_v = step_cdf(func_v)
    func_u = int_v.copy()                        # the columns' integrals
    cdf_u, int_u = step_cdf(func_u)
    return D.EnvDist(func_u=_t(func_u), cdf_u=_t(cdf_u),
                     int_u=_t(np.asarray(int_u, np.float32)),
                     func_v=_t(func_v), cdf_v=_t(cdf_v), int_v=_t(int_v),
                     nu=int(nu), nv=int(nv))
