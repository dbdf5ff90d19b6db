"""setup_s: process start to the first timed frame or step (imports, CUDA
context, parse and build, tables to the card, warm-up, and in a run that
builds them the native libraries), by the host clock."""


def read(run):
    return run["setup_s"]
