"""Tables carried across from the JAX package: a tpuprt SceneData, given as
nested dicts of numpy arrays, becomes a port SceneData.

`tables` mirrors tpuprt's dataclasses: a dataclass becomes a dict of its
fields (arrays as numpy, static fields as they are), a NamedTuple (texture
node metadata) becomes a dict of its fields. tpuprt's tuple of image
pyramids becomes the port's packed ImageTable (scene/build.pack_images),
its importance tables EnvDists, its tuple of density grids the packed
column of the port's VolumeTable (scene/build.volume_table). Fields the
port's tables do not have must be empty; the accelerator is a BVH, a
uniform grid, a kd-tree or none (brute force).
Anything else raises NotImplementedError. The BVH's rows are padded to 128 columns, as the port
stores them, and get the port's child-id table and depth
(accel/bvh_build.child_table); an instance table gets the port's top-level
BVH over its entries (accel/instances.build_top); a camera gets its
thin_lens flag from its lens radius. tpuprt carries none of these.
photon_maps_from_numpy does the same for a tpuprt PhotonMaps, and
virtual_lights_from_numpy, point_grid_from_numpy and
exphoton_aux_from_numpy for the preprocess state of igi, the irradiance
cache and exphotonmap, so each Li can be held from the state tpuprt's
reads.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..accel.bvh_build import child_table, pad_rows, tree_links
from ..accel.instances import build_top
from ..textures.graph import TexGraph, TexNodeMeta
from . import data as D
from .build import pack_images, volume_table
from .data import to_device

_NESTED = {"triangles": D.TriangleTable, "materials": D.MaterialTable,
           "textures": TexGraph, "lights": D.LightTable,
           "camera": D.CameraData, "accel": D.BvhAccel,
           "instances": D.InstanceTable, "quadrics": D.QuadricTable,
           "volumes": D.VolumeTable}
# Fields that feed only tpuprt's TPU paths, which the port's kernels never
# read: the BVH's leaf prim-id table and per-node boxes (its jnp and chunked
# walks).
_TPU_ONLY = {D.BvhAccel: ("prim_ids", "selfbb")}
# tpuprt's trace-time flags the port reads from its tables instead: the
# light table's instanced emitters (LightTable.area_geoms_present).
_DERIVED = {D.LightTable: ("inst_area",)}


def _empty(v) -> bool:
    if v is None or v is False or (isinstance(v, (tuple, list)) and not v):
        return True
    if isinstance(v, dict):
        return v.get("count", 0) == 0
    return isinstance(v, np.ndarray) and v.size == 0


def _build(cls, d: dict, device, where: str):
    names = {f.name for f in dataclasses.fields(cls)}
    extra = [k for k, v in d.items() if k not in names and not _empty(v)]
    extra = [k for k in extra if k not in _TPU_ONLY.get(cls, ()) +
             _DERIVED.get(cls, ())]
    if cls is D.VolumeTable:
        vol = volume_table([dict(
            kind=d["kind"][r], w2v=d["w2v"][r], v2w=d["v2w"][r],
            lo=d["bound_lo"][r], hi=d["bound_hi"][r],
            sigma_a=d["sigma_a"][r], sigma_s=d["sigma_s"][r], le=d["le"][r],
            g=d["g"][r], params=d["params"][r], updir=d["updir"][r],
            density=(d["density"] or (None,) * d["count"])[r])
            for r in range(d["count"])])
        return to_device(vol, device)
    if cls is D.BvhAccel:
        depth, rank, parent = tree_links(d["nodes"], d["n_nodes"])
        d = dict(d, nodes=pad_rows(d["nodes"]),
                 child=child_table(rank, parent),
                 max_depth=int(depth.max(initial=0)))
    if cls is D.InstanceTable:
        d = dict(d, top_nodes=build_top(d["entry_bbox"]))
    if cls is D.CameraData:
        d = dict(d, thin_lens=bool(np.asarray(d["lens_radius"]) > 0.0))
    if cls is D.LightTable:
        area = np.asarray(d["kind"]) == D.LIGHT_AREA
        d = dict(d, area_geoms_present=tuple(sorted(
            int(g) for g in set(np.asarray(d["area_geom_kind"])[area]))))
    if extra:
        raise NotImplementedError(f"{where}: {sorted(extra)} not ported")
    kw = {}
    for k in names & d.keys():
        v = d[k]
        if isinstance(v, np.ndarray):
            v = torch.tensor(v, device=device)
        elif k == "nodes" and cls is TexGraph:
            v = tuple(TexNodeMeta(**n) for n in v)
        kw[k] = v
    return cls(**kw)


# An accelerator's class by a field only it has.
_ACCELS = (("nodes", D.BvhAccel), ("cell_start", D.GridAccel),
           ("node_flags", D.KdTreeAccel))


def from_numpy_tables(tables: dict, device) -> D.SceneData:
    """Port SceneData from the numpy tables of a tpuprt SceneData (with a
    BVH, a grid, a kd-tree, or no accelerator: accel None)."""
    nested = dict(_NESTED)
    accel = tables.get("accel")
    if accel is not None:
        nested["accel"] = next(
            (cls for key, cls in _ACCELS if key in accel), None)
        if nested["accel"] is None:
            raise NotImplementedError(f"accelerator {sorted(accel)} is not "
                                      "ported")
    top = {k: v for k, v in tables.items() if k not in nested}
    images = top.pop("images", ())
    env = top.pop("env_importance", None) or ()
    scene = _build(D.SceneData, top, device, "SceneData")
    scene = dataclasses.replace(
        scene, images=to_device(pack_images(
            [(im["levels"], im["wrap"]) for im in images]), device)
        if images else None,
        env_importance=tuple(D.EnvDist(**{
            k: torch.tensor(v, device=device) if isinstance(v, np.ndarray)
            else v for k, v in e.items()}) for e in env))
    return dataclasses.replace(scene, **{
        k: None if tables.get(k) is None else
        _build(cls, tables[k], device, k) for k, cls in nested.items()})


def photon_maps_from_numpy(tables: dict, device):
    """Port PhotonMaps from the numpy tables of a tpuprt PhotonMaps (each
    map's fields as a dict; its p, wi and alpha columns, which `packed`
    repeats, are dropped)."""
    from ..accel.photon_grid import PhotonGrid
    from ..integrators.photonmap import PhotonMaps

    def grid(d):
        return PhotonGrid(
            packed=torch.tensor(d["packed"], device=device),
            start=torch.tensor(d["start"], device=device),
            n_paths=torch.tensor(d["n_paths"], dtype=torch.float32,
                                 device=device),
            radius=float(d["radius"]), n_buckets=int(d["n_buckets"]),
            bucket_cap=int(d["bucket_cap"]), count=int(d["count"]))
    return PhotonMaps(**{k: grid(tables[k]) for k in
                         ("caustic", "direct", "indirect")})


def virtual_lights_from_numpy(tables: dict, device):
    """Port VirtualLights from the numpy tables of a tpuprt VirtualLights."""
    from ..integrators.igi import VirtualLights
    return VirtualLights(
        **{k: torch.tensor(tables[k], device=device)
           for k in ("p", "n", "Le", "valid")},
        n_paths=torch.tensor(tables["n_paths"], dtype=torch.float32,
                             device=device),
        nsets=int(tables["nsets"]), max_vl=int(tables["max_vl"]))


def point_grid_from_numpy(tables: dict, device):
    """Port PointGrid from the numpy tables of a tpuprt PointGrid."""
    from ..accel.photon_grid import PointGrid
    return PointGrid(
        p=torch.tensor(tables["p"], device=device),
        payload=tuple(torch.tensor(x, device=device)
                      for x in tables["payload"]),
        start=torch.tensor(tables["start"], device=device),
        radius=float(tables["radius"]), n_buckets=int(tables["n_buckets"]),
        bucket_cap=int(tables["bucket_cap"]), count=int(tables["count"]))


def exphoton_aux_from_numpy(tables: dict, device):
    """Port ExPhotonAux from the numpy tables of a tpuprt ExPhotonAux: its
    maps, its radiance photons' grid and cos(gatherangle)."""
    from ..integrators.exphotonmap import ExPhotonAux
    return ExPhotonAux(
        maps=photon_maps_from_numpy(tables["maps"], device),
        radiance=point_grid_from_numpy(tables["radiance"], device),
        cos_gather=torch.tensor(tables["cos_gather"], dtype=torch.float32,
                                device=device))
