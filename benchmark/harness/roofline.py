"""A kernel's share of its least time over the traced frames, in percent.

The least time reads the same work whatever implements the kernel: each
ray the integrator traces read once (origin, direction, mint, maxt: 32
bytes) and its answer written once, t and id (8 bytes) for a ray that
needs the nearest hit and one byte, a flag, for a ray that needs any hit;
and the scene's triangles read once a frame (three f32 vertices: 36
bytes); over the card's 3.35 TB/s (NVIDIA H100 SXM, HBM3). No operation
term: a walk's tests depend on the tree the program builds, and the brute
force on a few triangles is bound by its bytes.

The rays are the reference's count of what the integrator traces in the
checked frames (reference/render.py: camera and continuation rays, and at
each vertex only the visibility rays its BSDF and lights need, so none at
a specular vertex), by frame: exact where the check takes every traced
frame, as the cells' traced runs do, and their mean otherwise. The time is
the device time, in the profiler's trace, of the kernels whose names hold
one of the metric's KERNELS.
"""
HBM_BYTES_PER_S = 3.35e12
RAY_BYTES = 32
NEAREST_BYTES = 8
ANY_BYTES = 1
TRIANGLE_BYTES = 36


def least_bytes(nearest, any_hit, frames, triangles):
    return (nearest * (RAY_BYTES + NEAREST_BYTES) +
            any_hit * (RAY_BYTES + ANY_BYTES) +
            frames * triangles * TRIANGLE_BYTES)


def kernel_seconds(trace, kernels):
    return sum(v for k, v in trace.get("kernels", {}).items()
               if any(n in k for n in kernels))


def share(run, kernels):
    """The share, or None where the trace holds none of the kernels or the
    check counted no rays."""
    t = kernel_seconds(run.get("trace") or {}, kernels)
    rays = run.get("ref_rays")
    if not t or not rays or not run.get("n"):
        return None
    n = run["n"]
    b = least_bytes(rays["nearest"] * n, rays["any"] * n, n,
                    len(run["ref_scene"].idx))
    return 100.0 * b / HBM_BYTES_PER_S / t
