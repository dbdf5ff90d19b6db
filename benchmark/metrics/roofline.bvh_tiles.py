"""roofline.bvh_tiles: the tile walk's share of its least time over the
traced frames, in percent (harness/roofline.py)."""
from harness import roofline

KERNELS = ("bvh_tiles_kernel",)


def read(run):
    return roofline.share(run, KERNELS)
