"""device_idle.grad: 1 - device busy / wall over the traced steps, in
percent (as device_idle.render)."""


def read(run):
    busy = run["trace"].get("busy_s")
    if not busy or "step_s" not in run:
        return None
    return 100.0 * (1.0 - busy / run["window_s"])
