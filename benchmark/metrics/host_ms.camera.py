"""host_ms.camera: the renderer's "camera" span a frame, in host milliseconds
of self time (StatsRegistry "Spans / camera ms" over the traced frames):
camera rays and the pool's refills: camera samples, generate_rays, the
refill's cumsum and selects, the chunk's ids."""
from harness import spans


def read(run):
    return spans.per_frame(run, "camera ms")
