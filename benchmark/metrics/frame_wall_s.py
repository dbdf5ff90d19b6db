"""frame_wall_s: the traced window's wall seconds over the whole frames it
completed, each ending with its image on the host: frame_s as the traced
run reads it, under the profiler, for a cell whose frames are too
host-bound for frame_s to hold an end-to-end bound."""


def read(run):
    return run.get("frame_s")
