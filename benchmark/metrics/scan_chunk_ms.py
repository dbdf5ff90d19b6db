"""scan_chunk_ms: the traced frames' wall over the chunked driver's chunks
(StatsRegistry "Film / Wavefront chunks")."""


def read(run):
    st = run.get("stats")
    chunks = st.get("Film", "Wavefront chunks") if st is not None else 0
    return 1e3 * run["window_s"] / chunks if chunks else None
