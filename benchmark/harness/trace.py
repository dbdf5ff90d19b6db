"""The device trace of a traced window: torch.profiler over whole frames
or steps, reduced to device busy seconds (the union of the device's
activity intervals), device seconds by kernel name, and the idle gaps
between device activity named by what the host was doing meanwhile (the
innermost host op open at the gap's middle)."""
from __future__ import annotations

import collections
import contextlib

import torch

TOP = 10


@contextlib.contextmanager
def profiled(enabled: bool, out: dict):
    """Profile the block when enabled; `out` receives the reduction."""
    if not enabled:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    out.update(reduce(_intervals(prof.profiler.kineto_results.events())))


def _intervals(events):
    """(device [(start_us, end_us, name)], host [(start, end, name)]) of
    the profiler's raw events; annotations are not device work."""
    dev, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in events:
        if e.is_user_annotation():
            continue
        item = (e.start_ns() * 1e-3, e.end_ns() * 1e-3, e.name())
        (dev if e.device_type() == cuda else host).append(item)
    return dev, host


def _union(iv):
    """Merged, sorted intervals."""
    out = []
    for s, e, _ in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _name_gaps(gaps, host):
    """Each gap (start, end) named by the innermost host op open at its
    middle: ops of one thread nest, so a stack in order of start holds
    the open ones."""
    host = sorted((s, e, n) for s, e, n in host
                  if n.startswith("aten::") or
                  ("::" not in n and not n.startswith("cu")))
    names, stack, i = [], [], 0
    for gs, ge in sorted(gaps):
        mid = 0.5 * (gs + ge)
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        names.append(((gs, ge), stack[-1][2] if stack else "(host idle)"))
    return names


def reduce(intervals):
    """busy_s, kernels {name: device s}, device_ops and idle_gaps (the
    top ten each, seconds)."""
    dev, host = intervals
    by_name = collections.Counter()
    for s, e, n in dev:
        by_name[n] += (e - s) * 1e-6
    busy = _union(dev)
    out = {"busy_s": sum(e - s for s, e in busy) * 1e-6,
           "kernels": dict(by_name),
           "device_ops": [[n, v] for n, v in by_name.most_common(TOP)]}
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    idle = collections.Counter()
    for (gs, ge), name in _name_gaps(gaps, host):
        idle[name] += (ge - gs) * 1e-6
    out["idle_gaps"] = [[n, v] for n, v in idle.most_common(TOP)]
    return out
