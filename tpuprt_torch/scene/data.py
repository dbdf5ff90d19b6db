"""The compiled scene as dataclasses of tensors (port of tpuprt/scene/data.py,
the tables the port renders).

Fields keep the reference's names and layouts; counts and other structure
the reference marks static stay plain Python values. `-1` is the universal
"no reference" id. A primitive id is, as in the reference, a quadric id q
in [0, NQ), a triangle id t as NQ + t, or past both an instanced prototype
triangle's (accel/instances.py).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Tuple

import torch

QUADRIC_SPHERE = 0
QUADRIC_CYLINDER = 1
QUADRIC_DISK = 2
QUADRIC_CONE = 3
QUADRIC_PARABOLOID = 4
QUADRIC_HYPERBOLOID = 5

LIGHT_POINT = 0
LIGHT_SPOT = 1
LIGHT_DISTANT = 2
LIGHT_AREA = 3
LIGHT_INFINITE = 4
LIGHT_PROJECTION = 5
LIGHT_GONIOMETRIC = 6

# Area-light geometry kinds: a quadric, a triangle set, or an instanced
# prototype's emissive triangles under one instance's transform.
AREA_GEOM_QUADRIC = 0
AREA_GEOM_TRIS = 1
AREA_GEOM_INST = 2

CAMERA_PERSPECTIVE = 0
CAMERA_ORTHOGRAPHIC = 1
CAMERA_ENVIRONMENT = 2

VOL_HOMOGENEOUS = 0
VOL_EXPONENTIAL = 1
VOL_GRID = 2


@dataclass
class QuadricTable:
    """All quadric shapes (pbrt-v1 shapes/{sphere,cylinder,disk,cone,
    paraboloid,hyperboloid}.cpp), in object space with both transforms.
    ``params`` per kind:
      sphere:      [radius, zmin, zmax, phimax, thetamin, thetamax, 0, 0]
      cylinder:    [radius, zmin, zmax, phimax, 0...]
      disk:        [height, radius, inner_radius, phimax, 0...]
      cone:        [radius, height, phimax, 0...]
      paraboloid:  [radius, zmin, zmax, phimax, 0...]
      hyperboloid: [a, c, p1z, p1x, p1y, p2z, phimax, 0]
    (angles in radians)."""
    kind: torch.Tensor         # i32[Q]
    o2w: torch.Tensor          # f32[Q,4,4]
    w2o: torch.Tensor          # f32[Q,4,4]
    params: torch.Tensor       # f32[Q,8]
    material: torch.Tensor     # i32[Q]
    area_light: torch.Tensor   # i32[Q], -1 if not emissive
    flip_normal: torch.Tensor  # f32[Q]: reverseOrientation ^ swapsHandedness
    # Per-row build-time facts (kind, phi_full, z_full), host-side so a
    # selection by them costs no device sync (tpuprt/scene/data.py:77-83):
    # phi_full, phimax covers the whole circle; z_full, no z window clips
    # the surface (a sphere's whole range, or a disk).
    static_rows: Tuple
    count: int = 0
    kinds_present: Tuple = ()


@dataclass
class TriangleTable:
    verts: torch.Tensor        # f32[V,3] world space
    idx: torch.Tensor          # i32[T,3]
    normals: torch.Tensor      # f32[V,3] shading normals (zeros if none)
    uv: torch.Tensor           # f32[V,2]
    tangents: torch.Tensor     # f32[V,3] shading tangents (zeros if none)
    has_normals: torch.Tensor  # bool[T]
    has_tangents: torch.Tensor  # bool[T]
    material: torch.Tensor     # i32[T]
    area_light: torch.Tensor   # i32[T]
    flip_normal: torch.Tensor  # f32[T]
    count: int = 0


@dataclass
class MaterialTable:
    """Kind tag + texture slots + the build-time lobe templates
    (materials/factory.py)."""
    kind: torch.Tensor         # i32[M]
    tex: torch.Tensor          # i32[M, 8]
    bump: torch.Tensor         # i32[M]
    t_kind: torch.Tensor = None
    t_flags: torch.Tensor = None
    t_flip: torch.Tensor = None
    t_aux0: torch.Tensor = None
    t_aux1: torch.Tensor = None
    t_rop: torch.Tensor = None
    t_ra: torch.Tensor = None
    t_rb: torch.Tensor = None
    t_eop: torch.Tensor = None
    t_ea: torch.Tensor = None
    t_pop: torch.Tensor = None
    t_pa: torch.Tensor = None
    t_pb: torch.Tensor = None
    count: int = 0
    lobe_kinds: Tuple = ()
    dist_kinds: Tuple = ()
    has_bump: bool = False


@dataclass
class ImageTable:
    """Every MIP pyramid of the scene (MIPMap<Spectrum>, core/mipmap.h) in
    one packed texel column: level l of image i is the h x w row-major
    block at ``level_off[i, l]`` of ``texels``, with h = ``level_h[i, l]``
    and w = ``level_w[i, l]``, for l below ``nlevels[i]``. ``wrap[i]``: 0
    repeat, 1 black, 2 clamp."""
    texels: torch.Tensor       # f32[sum of h*w, 3]
    level_off: torch.Tensor    # i64[I, Lmax]
    level_h: torch.Tensor      # i32[I, Lmax]
    level_w: torch.Tensor      # i32[I, Lmax]
    nlevels: Tuple = ()
    wrap: Tuple = ()
    count: int = 0


@dataclass
class EnvDist:
    """Importance tables of one infinitesample light (lights/
    infinitesample.cpp:32-138): the marginal over map columns (u, the phi
    axis) and each column's conditional over rows (v, the theta axis) of
    luminance x sin(theta), in ComputeStep1dCDF's form (steps func[i] /
    (n funcInt); a sample's pdf func[offset] / funcInt)."""
    func_u: torch.Tensor       # f32[nu]
    cdf_u: torch.Tensor        # f32[nu+1]
    int_u: torch.Tensor        # f32[]
    func_v: torch.Tensor       # f32[nu, nv]
    cdf_v: torch.Tensor        # f32[nu, nv+1]
    int_v: torch.Tensor        # f32[nu]
    nu: int = 1
    nv: int = 1


@dataclass
class LightTable:
    """Every light of the scene. ``params`` per kind: a spot light's
    [cos total width, cos falloff start]; a distant light's world
    direction in [0:3]; a projection light's [p00, p11, 0, 0, screen x0,
    x1, y0, y1]. ``image``: the map of an infinite, projection or
    goniometric light, -1 for none. An area light's geometry is the
    quadric ``area_first`` (AREA_GEOM_QUADRIC), the ``area_count``
    triangles from ``area_first`` (AREA_GEOM_TRIS, picked by the area CDF
    at ``area_cdf[cdf_offset:]``), or the ``area_count`` prototype
    triangles from ``area_first`` of the instance table under ``l2w``, the
    instance's transform (AREA_GEOM_INST; ``params[5]`` the sign of its
    determinant), of total area ``area_total_area``."""
    kind: torch.Tensor         # i32[L]
    l2w: torch.Tensor          # f32[L,4,4]
    w2l: torch.Tensor          # f32[L,4,4]
    spectrum: torch.Tensor     # f32[L,3]
    params: torch.Tensor       # f32[L,8]
    nsamples: torch.Tensor     # i32[L]
    image: torch.Tensor        # i32[L]
    area_geom_kind: torch.Tensor
    area_first: torch.Tensor
    area_count: torch.Tensor
    area_total_area: torch.Tensor
    cdf_offset: torch.Tensor
    area_cdf: torch.Tensor
    count: int = 0
    kinds_present: Tuple = ()
    area_geoms_present: Tuple = ()   # the area lights' AREA_GEOM_* kinds
    kinds_list: Tuple = ()
    infinite_meta: Tuple = ()   # (light id, image id, importance id)
    dir_map_meta: Tuple = ()    # (light id, image id) of mapped projection
                                # and goniometric lights
    max_area_count: int = 1


@dataclass
class VolumeTable:
    """Volume regions (pbrt-v1 volumes/{homogeneous,exponential,
    volumegrid}.cpp; tpuprt/scene/data.py:225-240): kind VOL_*, the world
    -> unit-box transform ``w2v`` over the region's [p0, p1] and its
    inverse, the world AABB, sigma_a, sigma_s and Le (scaled by the
    density), the HG asymmetry g, ``params`` [a, b, 0, 0] of the
    exponential density a exp(-b h) along ``updir``. The density grids
    are packed in one column: region r's nz x ny x nx grid (z-major) is
    ``density[grid_off[r]:]``, its dimensions ``grid_dims[r]``; the host
    tuple ``grids`` lists (r, offset, nz, ny, nx) of each region with
    one."""
    kind: torch.Tensor         # i32[R]
    w2v: torch.Tensor          # f32[R,4,4]
    v2w: torch.Tensor          # f32[R,4,4]
    bound_lo: torch.Tensor     # f32[R,3] world AABB
    bound_hi: torch.Tensor     # f32[R,3]
    sigma_a: torch.Tensor      # f32[R,3]
    sigma_s: torch.Tensor      # f32[R,3]
    le: torch.Tensor           # f32[R,3]
    g: torch.Tensor            # f32[R]
    params: torch.Tensor       # f32[R,4]
    updir: torch.Tensor        # f32[R,3]
    density: torch.Tensor      # f32[sum of nz*ny*nx] (f32[1] when none)
    grid_off: torch.Tensor     # i64[R], -1 without a grid
    grid_dims: torch.Tensor    # i32[R,3] (nz, ny, nx)
    grids: Tuple = ()
    count: int = 0


@dataclass
class CameraData:
    kind: int = CAMERA_PERSPECTIVE
    cam2world: torch.Tensor = None    # f32[4,4]
    world2cam: torch.Tensor = None
    raster2cam: torch.Tensor = None
    cam2screen: torch.Tensor = None
    lens_radius: torch.Tensor = None  # f32[]
    focal_distance: torch.Tensor = None
    shutter_open: torch.Tensor = None
    shutter_close: torch.Tensor = None
    cliphither: float = 1e-3
    clipyon: float = 1e30
    thin_lens: bool = False           # built with a lens radius above 0


@dataclass
class GridAccel:
    """Uniform-grid accelerator (accel/grid_build.py, the reference's
    resolution heuristic, grid.cpp:146-151): per-voxel prim lists in CSR
    form. Prim ids: quadric q -> q, triangle t -> NQ + t."""
    nvoxels: Tuple[int, int, int] = (1, 1, 1)
    bounds_lo: torch.Tensor = None   # f32[3]
    bounds_hi: torch.Tensor = None   # f32[3]
    width: torch.Tensor = None       # f32[3] voxel width
    inv_width: torch.Tensor = None   # f32[3]
    cell_start: torch.Tensor = None  # i32[nx*ny*nz+1] offsets into prim_ids
    prim_ids: torch.Tensor = None    # i32[P] the voxels' prim lists
    max_per_voxel: int = 0


@dataclass
class KdTreeAccel:
    """SAH kd-tree as flat node columns (accel/kdtree_build.py, the native
    builder csrc/kdtree_build.cpp), walked by kd-restart
    (accel/kdtree.py). Prim ids as in GridAccel."""
    bounds_lo: torch.Tensor = None    # f32[3]
    bounds_hi: torch.Tensor = None    # f32[3]
    node_flags: torch.Tensor = None   # i32[NN]: 0/1/2 split axis, 3 leaf
    node_split: torch.Tensor = None   # f32[NN]
    node_above: torch.Tensor = None   # i32[NN]: above child | leaf offset
    node_nprims: torch.Tensor = None  # i32[NN]: leaf prim count
    prim_ids: torch.Tensor = None     # i32[P]
    max_depth: int = 1                # deepest node + 1 (descent steps)
    max_leaf_prims: int = 1           # widest leaf


@dataclass
class BvhAccel:
    """The 8-wide skip-link BVH (accel/bvh_build.py) in two formats.

    ``nodes``: the builder's preorder rows, padded to 128 columns: [lo(3),
    hi(3), skip, nprims, interior: the children's ids by slot (cols
    8..15, -1 = empty), leaf: 8 x 9 inlined triangle vertices (cols
    8..79) + 8 prim ids (cols 80..87)]; the row walk (ops/csrc/bvh_rows.cu)
    reads them. ``nodesT``: the tile format (accel/bvh_build.build_tiles),
    rows param-major, lanes [8k, 8k+8) = param k of the node's 8 payload
    slots (interior: child boxes lo/hi; leaf: triangle p0/e1/e2/pid), with
    ``nodemeta`` packing depth | rank<<5 | nprims<<8; None when the tree is
    too deep for the tile walk. ``child``: the child-id table the tile walk
    descends by (accel/bvh_build.child_table: [n, r] = n's child of rank
    r, -1 where there is none). ``max_depth``: the tree's depth, which
    sizes the row walk's stack (None: not recorded, and the row walk
    refuses the tree). The front end walks the tiles when there are any,
    else the rows; render() copies only what that walk reads to the
    card. A tree over quadrics too (``n_quadrics`` > 0, prim ids as in
    GridAccel; a quadric's leaf slot inlines no vertices) has no tiles and
    takes the plain skip-link walk (accel/bvh.walk_skip_links)."""
    bounds_lo: torch.Tensor = None   # f32[3]
    bounds_hi: torch.Tensor = None   # f32[3]
    nodes: torch.Tensor = None       # f32[NN, 128]
    tri9: torch.Tensor = None        # f32[T, 9] packed world-space vertices
    nodesT: torch.Tensor = None      # f32[NN, 128] or None
    nodeskip: torch.Tensor = None    # i32[NN]
    nodemeta: torch.Tensor = None    # i32[NN]
    child: torch.Tensor = None       # i32[NN, 8]
    max_depth: int = None
    n_nodes: int = 1
    leaf_k: int = 8
    n_quadrics: int = 0


@dataclass
class InstanceTable:
    """Ray-transform instancing (pbrt-v1's InstancePrimitive,
    core/primitive.cpp:66-85): prototype triangle meshes stored once in
    object space, each with its own BLAS (rows as in BvhAccel.nodes, leaf
    prim ids global prototype-triangle ids), one transform per instance,
    and a top-level BVH over the traversal entries. Built by
    accel/instances.build_instances. Instanced area emitters: the
    prototype triangles of an emissive prototype are ``tri_emissive``,
    and each instance's light row is ``inst_area_light`` (-1: none)."""
    verts: torch.Tensor        # f32[V,3] object space, all prototypes
    idx: torch.Tensor          # i32[T,3]
    uv: torch.Tensor           # f32[V,2]
    normals: torch.Tensor      # f32[V,3] (zeros if none)
    has_normals: torch.Tensor  # bool[T]
    material: torch.Tensor     # i32[T]
    flip_normal: torch.Tensor  # f32[T]
    nodes: torch.Tensor        # f32[blocks * block_cap, 128]
    inst_o2w: torch.Tensor     # f32[I,4,4]
    inst_w2o: torch.Tensor     # f32[I,4,4]
    # Traversal entries: one per (instance, prototype node block).
    entry_block: torch.Tensor  # i32[E] node block (rows / block_cap)
    entry_inst: torch.Tensor   # i32[E]
    entry_start: torch.Tensor  # i32[E] first proto-local node id of block
    entry_stop: torch.Tensor   # i32[E] one past the block's last node id
    entry_bbox: torch.Tensor   # f32[E,8] world bbox (lo3, hi3, pad2)
    # Top-level BVH over the entry boxes (accel/instances.build_top):
    # skip-link rows [lo3, hi3, skip, nprims, 8 entry ids].
    top_nodes: torch.Tensor = None   # f32[NN_top, 16]
    bounds_lo: torch.Tensor = None   # f32[3] world bounds over instances
    bounds_hi: torch.Tensor = None
    inst_sign: torch.Tensor = None   # f32[I]: -1 where o2w is a mirror
    tri_emissive: torch.Tensor = None     # bool[T]
    inst_area_light: torch.Tensor = None  # i32[I]
    count: int = 0             # instances
    n_tris: int = 0            # total prototype triangles
    n_entries: int = 0
    block_cap: int = 2048
    leaf_k: int = 8


@dataclass
class SceneData:
    triangles: TriangleTable = None
    materials: MaterialTable = None
    textures: Any = None             # textures.graph.TexGraph
    lights: LightTable = None
    camera: CameraData = None
    # BvhAccel, GridAccel or KdTreeAccel; None: brute force
    # (accel/intersect.py).
    accel: Any = None
    instances: InstanceTable = None  # ray-transform instancing, or None
    quadrics: QuadricTable = None
    # The brute-force kernel's packed triangles f32[9,T] (ops/mt_cuda.
    # pack_tris), made once per render by render() when accel is None.
    tris_packed: torch.Tensor = None
    images: ImageTable = None        # the MIP pyramids, or None
    env_importance: Tuple = ()       # EnvDist per infinitesample light
    volumes: VolumeTable = None      # the volume regions, or None
    world_bound_lo: torch.Tensor = None  # f32[3]
    world_bound_hi: torch.Tensor = None


def to_device(obj, device):
    """Copy every tensor of a (nested) table dataclass, or of a plain tuple
    of tensors, to `device`."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if type(obj) is tuple:
        return tuple(to_device(x, device) for x in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)})
    return obj
