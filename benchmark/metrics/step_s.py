"""step_s: the window's wall seconds over the Adam steps it completed
(forward, backward, optimizer step)."""


def read(run):
    return run.get("step_s")
