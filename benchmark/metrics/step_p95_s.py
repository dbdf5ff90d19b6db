"""step_p95_s: the 95th percentile of the window's step times, each from
CUDA events recorded on the stream at the step's start and end (the
device's clock: a step is shorter than the host clock can time alone)."""
import statistics


def read(run):
    t = run.get("step_times")
    if not t or len(t) < 20:
        return None
    return statistics.quantiles(t, n=20)[-1]
