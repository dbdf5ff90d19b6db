"""peak_mem_GiB: torch.cuda.max_memory_allocated() over the window, after
a reset at its start."""


def read(run):
    v = run.get("window_peak")
    return v / 2 ** 30 if v else None
