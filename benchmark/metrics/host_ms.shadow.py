"""host_ms.shadow: the renderer's "shadow" span a frame, in host milliseconds
of self time (StatsRegistry "Spans / shadow ms" over the traced frames):
any-hit walks: accel/intersect.occluded, mt_best's ray sort, launch and
unsort."""
from harness import spans


def read(run):
    return spans.per_frame(run, "shadow ms")
