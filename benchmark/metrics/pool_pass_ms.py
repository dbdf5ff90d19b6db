"""pool_pass_ms: the traced frames' wall over the wavefront pool's passes
(StatsRegistry "Wavefront / Passes")."""


def read(run):
    st = run.get("stats")
    passes = st.get("Wavefront", "Passes") if st is not None else 0
    return 1e3 * run["window_s"] / passes if passes else None
