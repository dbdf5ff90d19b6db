"""The hand-written kernels and their wrappers.

Each wrapper module keeps its kernels' launches by kernel name in a dict
made by `launch_counter` (plain integers, added to where a kernel
launches). The functions below read and reset every such dict, so that
code which counts launches (a frame's, a replayed pass's) counts the
kernels of every wrapper, one added later too.
"""

_counters = []


def launch_counter(*names):
    """A new dict of launches by kernel name, each 0, that
    launch_counters() returns from then on."""
    counter = dict.fromkeys(names, 0)
    _counters.append(counter)
    return counter


def launch_counters():
    """Every wrapper's launch dict, in the order the modules made them."""
    return tuple(_counters)


def launch_counts():
    """Launches by kernel name so far, over every wrapper."""
    return {k: v for c in _counters for k, v in c.items()}


def reset_launches():
    """Set every launch count to 0."""
    for c in _counters:
        c.update(dict.fromkeys(c, 0))
