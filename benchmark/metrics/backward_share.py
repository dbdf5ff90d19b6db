"""backward_share: the backward pass's share of forward plus backward,
from the benchmark's spans around render_loss_fn and backward(), each
closed by a synchronize (traced run only)."""


def read(run):
    f, b = run.get("forward_s"), run.get("backward_s")
    return 100.0 * b / (f + b) if f and b else None
