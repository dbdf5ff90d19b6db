"""span_cover.render: the share of the traced frames' render() time that
the renderer's stage and sync spans explain, 100 (1 - frame self /
frame total). The spans' self times partition the frames, so the total
is the sum of every "Spans / <name> ms"."""


def read(run):
    st = run.get("stats")
    if st is None or not st.get("Spans", "frame calls"):
        return None
    total = sum(v for (cat, name), v in st.items()
                if cat == "Spans" and name.endswith(" ms"))
    if total <= 0:
        return None
    return 100.0 * (1.0 - st.get("Spans", "frame ms") / total)
