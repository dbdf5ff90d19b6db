"""host_syncs.render: the renderer's host syncs a frame, each a "sync" span
(StatsRegistry "Spans / syncs" over the traced frames)."""
from harness import spans


def read(run):
    return spans.per_frame(run, "syncs")
