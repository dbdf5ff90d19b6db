"""Texture graphs (port of tpuprt/textures/graph.py: the constant node and
the 2D checkerboard with uv mapping and closed-form antialiasing).

The graph is a topologically ordered node list: node structure is static
metadata, node parameters (colors, mapping scales) are tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch

KINDS = ("constant", "checkerboard2d")


class TexNodeMeta(NamedTuple):
    kind: str                     # node type
    children: Tuple[int, ...] = ()
    image: int = -1
    mapping: str = "uv"
    float_from_y: bool = False
    aamode: str = "closedform"
    trilinear: bool = False


@dataclass
class TexGraph:
    fparams: torch.Tensor         # f32[N,16]
    w2t: torch.Tensor             # f32[N,4,4]
    nodes: Tuple[TexNodeMeta, ...] = ()


def check_node(meta: TexNodeMeta):
    """Raise for the node kinds and options the port does not have yet."""
    if meta.kind not in KINDS:
        raise NotImplementedError(f'texture "{meta.kind}" is not ported')
    if meta.kind == "checkerboard2d" and (meta.mapping != "uv" or
                                          meta.aamode != "closedform"):
        raise NotImplementedError(
            f'checkerboard mapping "{meta.mapping}" / aamode '
            f'"{meta.aamode}" is not ported (uv + closedform only)')


def _map_uv(fp, dg):
    """uv mapping with screen-space derivatives (core/texture.cpp:63-82).
    Returns (s, t, dsdx, dtdx, dsdy, dtdy)."""
    su, sv, du, dv = fp[8], fp[9], fp[10], fp[11]
    s = su * dg["u"] + du
    t = sv * dg["v"] + dv
    return (s, t, su * dg["dudx"], sv * dg["dvdx"],
            su * dg["dudy"], sv * dg["dvdy"])


def _checker_closedform(s, t, dsdx, dtdx, dsdy, dtdy, tex1, tex2):
    """Box-filtered checkerboard (textures/checkerboard.cpp:69-107)."""
    ds = torch.maximum(torch.abs(dsdx), torch.abs(dsdy))
    dt = torch.maximum(torch.abs(dtdx), torch.abs(dtdy))
    s0, s1 = s - ds, s + ds
    t0, t1 = t - dt, t + dt
    same_s = torch.floor(s0) == torch.floor(s1)
    same_t = torch.floor(t0) == torch.floor(t1)
    point = ((torch.floor(s).to(torch.int32) +
              torch.floor(t).to(torch.int32)) % 2) == 0

    def bump(x):
        return torch.floor(x / 2) + 2.0 * torch.clamp(
            x / 2 - torch.floor(x / 2) - 0.5, min=0.0)

    sint = (bump(s1) - bump(s0)) / (2.0 * torch.clamp(ds, min=1e-12))
    tint = (bump(t1) - bump(t0)) / (2.0 * torch.clamp(dt, min=1e-12))
    area = sint + tint - 2.0 * sint * tint
    half = torch.full_like(area, 0.5)
    area = torch.where(ds > 1.0, half, area)
    area = torch.where(dt > 1.0, half, area)
    frac2 = torch.where(same_s & same_t,
                        torch.where(point, 0.0, 1.0), area)[..., None]
    return (1.0 - frac2) * tex1 + frac2 * tex2


def eval_graph(graph: TexGraph, dg):
    """Evaluate every node for a shading wavefront.

    dg: dict with u, v f32[B] and the dudx..dvdy derivatives.
    Returns f32[N_nodes, B, 3] (float textures replicate into rgb).
    """
    vals = []
    B = dg["u"].shape[0]
    for ni, meta in enumerate(graph.nodes):
        check_node(meta)
        fp = graph.fparams[ni]
        if meta.kind == "constant":
            v = fp[0:3].expand(B, 3)
        else:
            v = _checker_closedform(*_map_uv(fp, dg),
                                    vals[meta.children[0]],
                                    vals[meta.children[1]])
        vals.append(v)
    if not vals:
        return torch.zeros((0, B, 3), dtype=torch.float32,
                           device=dg["u"].device)
    return torch.stack(vals, 0)
