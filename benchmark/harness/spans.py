"""The renderer's stage spans (tpuprt_torch/utils/stats.py: span) as the
traced run's StatsRegistry holds them, under the category "Spans"."""


def per_frame(run, key):
    """"Spans / <key>" over the traced frames, a frame; None where the
    program keeps no spans (no "frame" span in the registry)."""
    st = run.get("stats")
    if st is None or not st.get("Spans", "frame calls") or not run.get("n"):
        return None
    return st.get("Spans", key) / run["n"]
