"""Grid-hash photon storage and the fixed-radius lookup (port of
tpuprt/accel/photon_grid.py: PhotonGrid, build_photon_grid, gather_photons,
and the generic point cache PointGrid, build_point_grid, gather_points).

Photons are bucketed by a hash of their grid cell (cell size = the lookup
radius) and sorted by bucket on the host, so a lookup reads, for each of
the 27 cells around a query point, up to `bucket_cap` photons of one
bucket, as the reference's kd-tree lookup (core/kdtree.h:48-171) finds the
photons within maxDist. Like tpuprt, this is fixed-radius density
estimation: every photon within the radius counts, with no shrinking
k-nearest radius; buckets over the cap keep a random subset with their
power scaled up (unbiased).

The cell hash multiplies the cell coordinates by primes and keeps the low
bits; the port computes it in int64 on both sides, the build (numpy) and
the lookup (torch), which keeps the low bits of tpuprt's wrapping int32
products. A cell is floor(p / radius) with a true f32 division on both
sides.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

_HX, _HY, _HZ = 73856093, 19349663, 83492791
# The 27 cells around a query point's, in tpuprt's order (photon_grid.py:
# 102-103).
_NBR = np.stack(np.meshgrid([-1, 0, 1], [-1, 0, 1], [-1, 0, 1],
                            indexing="ij"), -1).reshape(27, 3)
# The bytes one query point's lookup step holds on the device: the 27
# gathered 12-float rows, a few [27, 3] temporaries and the cells' starts,
# counts and indices: block_rows' default row.
_STEP_BYTES = 27 * (12 + 6 * 3) * 4 + 27 * 3 * 8
# The share of the device's free memory one block of work may take, and a
# lookup's block on the CPU.
_FREE_SHARE = 8
_CPU_BLOCK = 1 << 14


@dataclass
class PhotonGrid:
    """One photon map: `packed` rows [p, wi, alpha, pad] f32[N, 12] sorted
    by bucket, `start` i32[M+1] the bucket offsets, `n_paths` f32[] the
    paths shot to fill the map (the estimate's normalizer)."""
    packed: torch.Tensor = None
    start: torch.Tensor = None
    n_paths: torch.Tensor = None
    radius: float = 0.1
    n_buckets: int = 1          # M, a power of two
    bucket_cap: int = 0         # photons read per bucket
    count: int = 0


def _cell_hash(ix, iy, iz, m: int):
    """The bucket of cell (ix, iy, iz) among m (a power of two), on int64
    numpy arrays or tensors."""
    return ((ix * _HX) ^ (iy * _HY) ^ (iz * _HZ)) & (m - 1)


def build_photon_grid(p: np.ndarray, wi: np.ndarray, alpha: np.ndarray,
                      radius: float, n_paths: float,
                      max_bucket_cap: int = 32) -> PhotonGrid:
    """Host build (photon_grid.py:51-109): hash to 2N or more buckets (a
    power of two), stable-sort by bucket, record the starts. A bucket over
    `max_bucket_cap` keeps a random subset of that many, its power scaled
    by count / cap: one permutation per over-full bucket, in bucket order,
    from np.random.default_rng(0x9e3779b9). Returns CPU tensors."""
    n = p.shape[0]
    if n == 0:
        return PhotonGrid(packed=torch.zeros((1, 12)),
                          start=torch.zeros((2,), dtype=torch.int32),
                          n_paths=torch.tensor(max(n_paths, 1.0),
                                               dtype=torch.float32),
                          radius=float(radius))
    m = 1
    while m < 2 * n:
        m *= 2
    cells = np.floor(p / np.float32(radius)).astype(np.int64)
    h = _cell_hash(cells[:, 0], cells[:, 1], cells[:, 2], m)
    order = np.argsort(h, kind="stable")
    p, wi, alpha, hs = p[order], wi[order], alpha[order], h[order]
    start = np.searchsorted(hs, np.arange(m + 1))
    counts = np.diff(start)
    over = np.nonzero(counts > max_bucket_cap)[0]
    if len(over):
        rng_ = np.random.default_rng(0x9e3779b9)
        alpha = alpha.copy()
        keep = np.ones(len(p), bool)
        for b in over:
            s, c = start[b], counts[b]
            sel = rng_.permutation(c)[:max_bucket_cap] + s
            keep[s:s + c] = False
            keep[sel] = True
            alpha[sel] *= c / max_bucket_cap
        p, wi, alpha, hs = p[keep], wi[keep], alpha[keep], hs[keep]
        start = np.searchsorted(hs, np.arange(m + 1))
        counts = np.diff(start)
        n = len(p)
    packed = np.concatenate([p, wi, alpha, np.zeros((n, 3), np.float32)],
                            axis=1).astype(np.float32)
    return PhotonGrid(
        packed=torch.from_numpy(packed),
        start=torch.from_numpy(start.astype(np.int32)),
        n_paths=torch.tensor(max(n_paths, 1.0), dtype=torch.float32),
        radius=float(radius), n_buckets=m,
        bucket_cap=int(min(max(counts.max(), 1), max_bucket_cap)), count=n)


def block_rows(device, row_bytes: int = _STEP_BYTES,
               cpu_rows: int = _CPU_BLOCK) -> int:
    """Rows a block of work takes (by default query points of a lookup,
    one step's rows and temporaries each): on the card, what a share of
    its free memory holds at `row_bytes` a row; on the CPU `cpu_rows`. A
    block's size changes no result."""
    device = torch.device(device)
    if device.type != "cuda":
        return cpu_rows
    free, _ = torch.cuda.mem_get_info(device)
    return max(1024, free // _FREE_SHARE // row_bytes)


def _cells(start, n_buckets: int, radius: float, q):
    """The first index and count i64[B, 27] of the bucket of each of the 27
    cells around each query point q f32[B, 3]. A cell is floor(q / radius)
    by a true f32 division: the radius is a tensor on q's device."""
    rad = torch.tensor(radius, dtype=torch.float32, device=q.device)
    # A missed lane's far-off point keeps its hash products inside int64
    # (its result is masked); a real point is far inside the clamp.
    base = torch.floor(torch.clamp(torch.nan_to_num(q / rad), -2.0 ** 30,
                                   2.0 ** 30)).to(torch.int64)
    cells = base[:, None, :] + torch.from_numpy(_NBR).to(q.device)
    b = _cell_hash(cells[..., 0], cells[..., 1], cells[..., 2], n_buckets)
    s_all = start[b].to(torch.int64)
    return s_all, start[b + 1].to(torch.int64) - s_all


def gather_photons(grid: PhotonGrid, q, accum, init, with_d2=False):
    """Scan the photons within `radius` of each query point q f32[B, 3]
    (photon_grid.py:130-178): for slot j < bucket_cap, one [B, 27] step,
    accum(carry, wi f32[B,27,3], alpha f32[B,27,3], w bool[B,27]) with w
    True for the photons in range, and with_d2 their squared distances
    f32[B,27] as a fifth argument (the kernel estimators'). Returns the
    final carry. All 27 cells go in one step (tpuprt blocks them to bound
    the TPU's gather width; the caller blocks the points instead)."""
    if grid.count == 0 or grid.bucket_cap == 0:
        return init
    r2 = float(np.float32(grid.radius * grid.radius))
    s_all, cnt_all = _cells(grid.start, grid.n_buckets, grid.radius, q)
    # The photons' p, wi and alpha as nine contiguous columns: on the card
    # a 1-D take per column makes the lookup about 3x faster than a
    # gather of whole 12-float rows (chip_smoke.py --profile, phase
    # "lookup").
    cols = grid.packed[:, :9].T.contiguous()
    carry = init
    for j in range(grid.bucket_cap):
        idx = torch.clamp(s_all + j, max=grid.count - 1)
        g = [c.take(idx) for c in cols]
        dx, dy, dz = (g[k] - q[:, None, k] for k in range(3))
        d2 = dx * dx + dy * dy + dz * dz
        w = (cnt_all > j) & (d2 < r2)
        args = (torch.stack(g[3:6], -1), torch.stack(g[6:9], -1), w)
        carry = accum(carry, *args, d2) if with_d2 else accum(carry, *args)
    return carry


@dataclass
class PointGrid:
    """Generic hashed point cache (photon_grid.py:181-195; the reference's
    Octree, core/octree.h:42-147): points `p` f32[N, 3] and `payload`
    columns, each f32[N, ...], sorted by the bucket of their cell of size
    `radius`; `start` i32[M+1] the bucket offsets. The irradiance cache
    and exphotonmap's radiance photons keep theirs in one."""
    p: torch.Tensor = None
    payload: tuple = ()
    start: torch.Tensor = None
    radius: float = 0.1
    n_buckets: int = 1
    bucket_cap: int = 0
    count: int = 0


def build_point_grid(p: np.ndarray, payload, radius: float,
                     max_bucket_cap: int = 64) -> PointGrid:
    """Host build (photon_grid.py:198-219): hash to 2N or more buckets,
    stable-sort by bucket, record the starts; no thinning, a lookup reads at
    most `max_bucket_cap` points a bucket. Returns CPU tensors."""
    n = p.shape[0]
    if n == 0:
        return PointGrid(p=torch.zeros((1, 3)),
                         payload=tuple(torch.from_numpy(np.asarray(x))
                                       for x in payload),
                         start=torch.zeros((2,), dtype=torch.int32),
                         radius=float(radius))
    m = 1
    while m < 2 * n:
        m *= 2
    cells = np.floor(p / np.float32(radius)).astype(np.int64)
    h = _cell_hash(cells[:, 0], cells[:, 1], cells[:, 2], m)
    order = np.argsort(h, kind="stable")
    start = np.searchsorted(h[order], np.arange(m + 1))
    return PointGrid(
        p=torch.from_numpy(np.ascontiguousarray(p[order], np.float32)),
        payload=tuple(torch.from_numpy(np.ascontiguousarray(
            np.asarray(x)[order])) for x in payload),
        start=torch.from_numpy(start.astype(np.int32)),
        radius=float(radius), n_buckets=m,
        bucket_cap=int(min(max(np.diff(start).max(), 1), max_bucket_cap)),
        count=n)


def gather_points(grid: PointGrid, q, accum, init):
    """gather_points (photon_grid.py:222-251) with all 27 cells a step: for
    slot j < bucket_cap, accum(carry, p f32[B,27,3], payload tuple of
    [B,27,...] gathers, in_bucket bool[B,27]); accum applies its own range
    and validity tests. Returns the final carry."""
    if grid.count == 0 or grid.bucket_cap == 0:
        return init
    s_all, cnt_all = _cells(grid.start, grid.n_buckets, grid.radius, q)
    carry = init
    for j in range(grid.bucket_cap):
        idx = torch.clamp(s_all + j, max=grid.count - 1)
        carry = accum(carry, grid.p[idx], tuple(x[idx] for x in grid.payload),
                      cnt_all > j)
    return carry
