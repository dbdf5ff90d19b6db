"""Volume regions: homogeneous, exponential and density grid (port of
tpuprt/volumes/regions.py; pbrt-v1 volumes/*.cpp and the VolumeRegion
interface, core/volume.h:43-108).

Every region lives in one table (scene/data.VolumeTable). A query is
evaluated for every region, masked by the point being inside its world
box, and summed over the regions: pbrt-v1's AggregateVolume
(core/volume.h:91-108). The optical depth is marched in _MARCH_STEPS
fixed steps with a jittered midpoint over the ray's clip to the regions'
union box, for every kind (tpuprt's form of core/volume.cpp's Tau).
"""
from __future__ import annotations

import torch

from ..core import transform as tf, vecmath as vm
from ..scene.data import VOL_EXPONENTIAL, VOL_GRID, VolumeTable

_MARCH_STEPS = 32


def present(vol: VolumeTable) -> bool:
    """Whether the scene has a volume region (the table, or None)."""
    return vol is not None and vol.count > 0


def _inside(vol: VolumeTable, p):
    """bool[N, R]: p inside region r's world box."""
    pp = p[:, None, :]
    return torch.all((pp >= vol.bound_lo[None]) & (pp <= vol.bound_hi[None]),
                     dim=-1)


def _grid_lookup(vol: VolumeTable, off: int, nz: int, ny: int, nx: int,
                 ri: int, p):
    """Region ri's density grid at world points p f32[N, 3]: trilinear in
    volume space, the cell corners clamped to the grid and the weights to
    [0, 1] (volumes/volumegrid.cpp; tpuprt/volumes/regions.py:44-70)."""
    pv = tf.apply_point(vol.w2v[ri], p)
    gx = pv[:, 0] * nx - 0.5
    gy = pv[:, 1] * ny - 0.5
    gz = pv[:, 2] * nz - 0.5
    x0 = torch.clamp(torch.floor(gx).to(torch.int32), 0, nx - 1)
    y0 = torch.clamp(torch.floor(gy).to(torch.int32), 0, ny - 1)
    z0 = torch.clamp(torch.floor(gz).to(torch.int32), 0, nz - 1)
    x1 = torch.clamp(x0 + 1, 0, nx - 1)
    y1 = torch.clamp(y0 + 1, 0, ny - 1)
    z1 = torch.clamp(z0 + 1, 0, nz - 1)
    fx = torch.clamp(gx - x0, 0, 1)[:, None]
    fy = torch.clamp(gy - y0, 0, 1)[:, None]
    fz = torch.clamp(gz - z0, 0, 1)[:, None]
    grid = vol.density[off:]

    def c(zz, yy, xx):
        return grid[((zz.long() * ny + yy) * nx + xx)][:, None]

    return ((1 - fx) * (1 - fy) * (1 - fz) * c(z0, y0, x0) +
            fx * (1 - fy) * (1 - fz) * c(z0, y0, x1) +
            (1 - fx) * fy * (1 - fz) * c(z0, y1, x0) +
            fx * fy * (1 - fz) * c(z0, y1, x1) +
            (1 - fx) * (1 - fy) * fz * c(z1, y0, x0) +
            fx * (1 - fy) * fz * c(z1, y0, x1) +
            (1 - fx) * fy * fz * c(z1, y1, x0) +
            fx * fy * fz * c(z1, y1, x1))[:, 0]


def density(vol: VolumeTable, p):
    """f32[N, R]: each region's density at p, 0 outside its box: 1 for a
    homogeneous region, a exp(-b h) for an exponential one with h the
    height of p above the box's low corner along updir
    (volumes/exponential.cpp:27-53), the grid's trilinear value."""
    pp = p[:, None, :]
    h = vm.dot(pp - vol.bound_lo[None], vol.updir[None])
    d_exp = vol.params[None, :, 0] * torch.exp(-vol.params[None, :, 1] * h)
    d = torch.where(vol.kind[None] == VOL_EXPONENTIAL, d_exp,
                    torch.ones_like(d_exp))
    if vol.grids:
        cols = list(d.unbind(1))
        for (ri, off, nz, ny, nx) in vol.grids:
            cols[ri] = torch.where(vol.kind[ri] == VOL_GRID,
                                   _grid_lookup(vol, off, nz, ny, nx, ri, p),
                                   cols[ri])
        d = torch.stack(cols, 1)
    return torch.where(_inside(vol, p), d, 0.0)


def sigma_a(vol: VolumeTable, p):
    return torch.sum(density(vol, p)[..., None] * vol.sigma_a[None], dim=1)


def sigma_s(vol: VolumeTable, p):
    return torch.sum(density(vol, p)[..., None] * vol.sigma_s[None], dim=1)


def sigma_t(vol: VolumeTable, p):
    d = density(vol, p)[..., None]
    return torch.sum(d * (vol.sigma_a + vol.sigma_s)[None], dim=1)


def lve(vol: VolumeTable, p):
    """The emitted radiance Lve at p."""
    return torch.sum(density(vol, p)[..., None] * vol.le[None], dim=1)


def mean_g(vol: VolumeTable, p):
    """The density-weighted phase asymmetry at p (0 where no region
    is)."""
    d = density(vol, p)
    w = torch.sum(d, dim=1)
    g = torch.sum(d * vol.g[None], dim=1)
    return torch.where(w > 0, g / torch.clamp(w, min=1e-9), 0.0)


def segment(vol: VolumeTable, o, d, mint, maxt):
    """The ray's [mint, maxt] clipped to the union of the regions' boxes:
    (t0, t1, any), 0 where it misses."""
    hit, t0, t1 = vm.bbox_intersect_p(vol.bound_lo.amin(0),
                                      vol.bound_hi.amax(0), o, d, mint, maxt)
    return torch.where(hit, t0, 0.0), torch.where(hit, t1, 0.0), hit


def march(t0, t1, u):
    """The marching steps over [t0, t1]: (dt, the midpoints' t of step i
    for i in 0 .. _MARCH_STEPS - 1), jittered by u."""
    dt = torch.clamp(t1 - t0, min=0.0) / _MARCH_STEPS
    return dt, [t0 + (i + u) * dt for i in range(_MARCH_STEPS)]


def tau(vol: VolumeTable, o, d, mint, maxt, step_jitter):
    """Optical depth f32[N, 3] along [mint, maxt] (core/volume.cpp Tau):
    the fixed-step jittered midpoint march."""
    if not present(vol):
        return torch.zeros(o.shape[:-1] + (3,), dtype=torch.float32,
                           device=o.device)
    t0, t1, any_hit = segment(vol, o, d, mint, maxt)
    dt, tmids = march(t0, t1, step_jitter)
    acc = torch.zeros(o.shape[:-1] + (3,), dtype=torch.float32,
                      device=o.device)
    for tmid in tmids:
        acc = acc + sigma_t(vol, o + tmid[..., None] * d) * dt[..., None]
    return torch.where(any_hit[..., None], acc, 0.0)


def transmittance(vol: VolumeTable, o, d, mint, maxt, u):
    """exp(-Tau) (integrators/emission.cpp:47-59); 1 without volumes."""
    if not present(vol):
        return torch.ones(o.shape[:-1] + (3,), dtype=torch.float32,
                          device=o.device)
    return torch.exp(-tau(vol, o, d, mint, maxt, u))
