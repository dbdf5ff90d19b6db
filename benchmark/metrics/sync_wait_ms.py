"""sync_wait_ms: host milliseconds a frame spent waiting for the device in
the renderer's "sync" spans (StatsRegistry "Spans / sync ms" over the
traced frames): the reads of live-lane counts, nonzero's compactions, the
image's readback."""
from harness import spans


def read(run):
    return spans.per_frame(run, "sync ms")
