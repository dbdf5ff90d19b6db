"""roofline.mt_best: the brute force's kernel (mt_best: every triangle
against every ray) as a share of its least time over the traced frames,
in percent (harness/roofline.py)."""
from harness import roofline

KERNELS = ("mt_best_kernel",)


def read(run):
    return roofline.share(run, KERNELS)
