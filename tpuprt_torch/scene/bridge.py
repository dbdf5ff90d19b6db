"""Tables carried across from the JAX package: a tpuprt SceneData, given as
nested dicts of numpy arrays, becomes a port SceneData.

`tables` mirrors tpuprt's dataclasses: a dataclass becomes a dict of its
fields (arrays as numpy, static fields as they are), a NamedTuple (texture
node metadata) becomes a dict of its fields. Fields the port's tables do
not have must be empty (no quadrics, volumes, instances, images or
environment maps), and the accelerator must be a tile-format BVH; anything
else raises NotImplementedError.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..textures.graph import TexGraph, TexNodeMeta
from . import data as D

_NESTED = {"triangles": D.TriangleTable, "materials": D.MaterialTable,
           "textures": TexGraph, "lights": D.LightTable,
           "camera": D.CameraData, "accel": D.BvhAccel}


def _empty(v) -> bool:
    if v is None or v is False or (isinstance(v, (tuple, list)) and not v):
        return True
    if isinstance(v, dict):
        return v.get("count", 0) == 0
    return isinstance(v, np.ndarray) and v.size == 0


def _build(cls, d: dict, device, where: str):
    names = {f.name for f in dataclasses.fields(cls)}
    extra = [k for k, v in d.items() if k not in names and not _empty(v)]
    # The BVH's row-format tables (nodes, prim_ids, selfbb) feed kernels
    # the port replaces with the tile walk; they are dropped, not ported.
    if cls is D.BvhAccel:
        extra = [k for k in extra if k not in ("nodes", "prim_ids",
                                                "selfbb")]
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


def from_numpy_tables(tables: dict, device) -> D.SceneData:
    """Port SceneData from the numpy tables of a tpuprt SceneData."""
    if tables.get("accel") is None or \
            tables["accel"].get("nodesT") is None:
        raise NotImplementedError("only tile-format BVH scenes are ported")
    top = {k: v for k, v in tables.items() if k not in _NESTED}
    scene = _build(D.SceneData, top, device, "SceneData")
    return dataclasses.replace(scene, **{
        k: _build(cls, tables[k], device, k) for k, cls in _NESTED.items()})
