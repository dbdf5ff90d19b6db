"""launches.render: the intersection kernels' launches a frame, from the
renderer's own counters (ops/bvh_cuda.launches, ops/mt_cuda.launches)
over the traced frames."""


def read(run):
    if run.get("stats") is None or not run.get("n"):
        return None
    return run["launches"] / run["n"]
