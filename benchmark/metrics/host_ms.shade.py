"""host_ms.shade: the renderer's "shade" span a frame, in host milliseconds of
self time (StatsRegistry "Spans / shade ms" over the traced frames): shading
outside the light and the walks: hit geometry, differentials, BSDFs,
emission, continuation, roulette, compaction."""
from harness import spans


def read(run):
    return spans.per_frame(run, "shade ms")
