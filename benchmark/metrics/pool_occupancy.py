"""pool_occupancy: the lanes live at a pass's start over all the pool's
lanes of all passes, the StatsRegistry ratio "Wavefront / Lane
occupancy" (path segments traced over passes times lanes)."""


def read(run):
    st = run.get("stats")
    passes = st.get("Wavefront", "Passes") if st is not None else 0
    if not passes:
        return None
    return 100.0 * st.get("Wavefront", "Path segments traced") / (
        passes * run["lanes"])
