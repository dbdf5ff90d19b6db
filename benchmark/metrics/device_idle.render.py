"""device_idle.render: 1 - device busy / wall over the traced frames, in
percent: busy is the union of the device's activity intervals in the
profiler's trace."""


def read(run):
    busy = run["trace"].get("busy_s")
    if not busy or "frame_s" not in run:
        return None
    return 100.0 * (1.0 - busy / run["window_s"])
