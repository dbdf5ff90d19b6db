"""graph_share.pool: the wavefront pool's passes replayed from a CUDA graph
over all its passes, in percent (StatsRegistry "Wavefront / Graph passes"
over "Wavefront / Passes"); None where the program keeps no such counter."""


def read(run):
    st = run.get("stats")
    if st is None or ("Wavefront", "Graph passes") not in dict(st.items()):
        return None
    passes = st.get("Wavefront", "Passes")
    return 100.0 * st.get("Wavefront", "Graph passes") / passes \
        if passes else None
