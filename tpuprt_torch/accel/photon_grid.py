"""Grid-hash photon storage and the fixed-radius lookup (port of
tpuprt/accel/photon_grid.py: PhotonGrid, build_photon_grid and
gather_photons).

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
# counts and indices. lookup_block sizes the point blocks by it.
_STEP_BYTES = 27 * (12 + 6 * 3) * 4 + 27 * 3 * 8
# The share of the device's free memory one lookup block may take, and the
# block on the CPU.
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


def lookup_block(device) -> int:
    """Query points per lookup block: on the card, what a share of its free
    memory holds (one step's rows and temporaries); on the CPU a fixed
    block."""
    device = torch.device(device)
    if device.type != "cuda":
        return _CPU_BLOCK
    free, _ = torch.cuda.mem_get_info(device)
    return max(1024, free // _FREE_SHARE // _STEP_BYTES)


def gather_photons(grid: PhotonGrid, q, accum, init):
    """Scan the photons within `radius` of each query point q f32[B, 3]
    (photon_grid.py:130-178): for slot j < bucket_cap, one [B, 27] step,
    accum(carry, wi f32[B,27,3], alpha f32[B,27,3], w bool[B,27]) with w
    True for the photons in range. Returns the final carry. All 27 cells
    go in one step (tpuprt blocks them to bound the TPU's gather width;
    the caller blocks the points instead)."""
    if grid.count == 0 or grid.bucket_cap == 0:
        return init
    r2 = float(np.float32(grid.radius * grid.radius))
    rad = torch.tensor(grid.radius, dtype=torch.float32, device=q.device)
    # A missed lane's far-off point keeps its hash products inside int64
    # (its result is masked); a real point is far inside the clamp.
    base = torch.floor(torch.clamp(torch.nan_to_num(q / rad), -2.0 ** 30,
                                   2.0 ** 30)).to(torch.int64)
    cells = base[:, None, :] + torch.from_numpy(_NBR).to(q.device)
    b = _cell_hash(cells[..., 0], cells[..., 1], cells[..., 2],
                   grid.n_buckets)                            # [B, 27]
    s_all = grid.start[b].to(torch.int64)
    cnt_all = grid.start[b + 1].to(torch.int64) - s_all
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
        carry = accum(carry, torch.stack(g[3:6], -1),
                      torch.stack(g[6:9], -1), w)
    return carry
