"""load_s: the benchmark's span around the scene's parse and build and its
tables' move to the device (render.on_device), in set-up."""


def read(run):
    return run.get("load_s")
