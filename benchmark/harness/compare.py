"""The numbers that decide `correct`, each held to its limit.

Frames: the renderer's image (read back as f16, the product's choice)
against the reference's f32 image of the same frame seed, every pixel:
- off_share: the share of pixels where a channel differs by more than
  1e-3 of the reference's value plus 1e-4 (one f16 step is 2^-11 = 4.9e-4
  of a value; the rounding is at most half of that), or alpha differs by
  more than 1e-3;
- mean_gap: the sum of absolute differences over the sum of the
  reference's values.
Gradient steps: the first three steps' losses, the first gradient as the
optimizer got it, and the parameters' change over the three steps, each
leaf's norm against the reference's, by the worst leaf (a leaf's gap over
the larger of its reference norm and the median leaf's); leaves whose
reference gradient is under a thousandth of the median leaf's are left
out. The target image the renderer made in set-up is held like a frame.
"""
from __future__ import annotations

import statistics

import numpy as np

REL, ABS, ALPHA = 1e-3, 1e-4, 1e-3


def frame_numbers(rgb, alpha, ref_rgb, ref_alpha):
    rgb, ref = np.asarray(rgb, np.float64), np.asarray(ref_rgb, np.float64)
    over = np.abs(rgb - ref) > REL * np.abs(ref) + ABS
    off = over.any(-1) | (np.abs(np.asarray(alpha, np.float64) -
                                 np.asarray(ref_alpha, np.float64)) > ALPHA)
    return {"off_share": float(off.mean()),
            "mean_gap": float(np.abs(rgb - ref).sum() /
                              max(np.abs(ref).sum(), 1e-30))}


def worst(rows: list) -> dict:
    """The worst value of each number over several frames."""
    return {k: max(r[k] for r in rows) for k in rows[0]}


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """max over leaves of |norm(prog) - norm(ref)| / max(norm(ref),
    median of the reference's norms), over the leaves `keep`."""
    keep = list(keep if keep is not None else ref)
    rn = {k: float(np.linalg.norm(ref[k])) for k in keep}
    med = statistics.median(rn.values())
    return max(abs(float(np.linalg.norm(prog[k])) - rn[k]) /
               max(rn[k], med, 1e-30) for k in keep)


def moving_leaves(g1_ref: dict) -> list:
    """Leaves whose first reference gradient is at least a thousandth of
    the median leaf's: the others move by round-off alone."""
    n = {k: float(np.linalg.norm(v)) for k, v in g1_ref.items()}
    med = statistics.median(n.values())
    return [k for k, v in n.items() if v >= 1e-3 * med]


def grad_numbers(prog: dict, ref: dict) -> dict:
    """prog, ref: dict(losses [3], g1 {leaf: array}, change {leaf:
    array})."""
    keep = moving_leaves(ref["g1"])
    return {"loss_gap": max(abs(a - b) / max(abs(b), 1e-30)
                            for a, b in zip(prog["losses"], ref["losses"])),
            "grad_gap": leaf_gap(prog["g1"], ref["g1"], keep),
            "change_gap": leaf_gap(prog["change"], ref["change"], keep)}


def judge(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]): every number at or under its
    limit; a number with no limit or a missing number fails."""
    rows = [(k, numbers.get(k), limits[k]) for k in limits]
    ok = all(v is not None and np.isfinite(v) and v <= lim
             for _, v, lim in rows)
    return ok, rows
