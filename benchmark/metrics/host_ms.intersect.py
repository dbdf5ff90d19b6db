"""host_ms.intersect: the renderer's "intersect" span a frame, in host
milliseconds of self time (StatsRegistry "Spans / intersect ms" over the
traced frames): nearest-hit walks: accel/intersect.intersect_ids, the
kernels' front ends and launches."""
from harness import spans


def read(run):
    return spans.per_frame(run, "intersect ms")
