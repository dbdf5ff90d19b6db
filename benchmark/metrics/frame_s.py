"""frame_s: the window's wall seconds over the whole frames it completed,
each frame ending with its image on the host."""


def read(run):
    return run.get("frame_s")
