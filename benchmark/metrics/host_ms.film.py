"""host_ms.film: the renderer's "film" span a frame, in host milliseconds of
self time (StatsRegistry "Spans / film ms" over the traced frames): the
radiance guards, the splat, develop and the f16 conversion."""
from harness import spans


def read(run):
    return spans.per_frame(run, "film ms")
