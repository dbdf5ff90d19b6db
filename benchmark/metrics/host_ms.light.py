"""host_ms.light: the renderer's "light" span a frame, in host milliseconds of
self time (StatsRegistry "Spans / light ms" over the traced frames): direct
lighting: common.direct_ld, whitted_ld, photon_radiance, the scan's shade
terms (their walks excluded)."""
from harness import spans


def read(run):
    return spans.per_frame(run, "light ms")
