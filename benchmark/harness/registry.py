"""Where the benchmark finds things by name: BENCHMARK.json at the root of
the checkout, a configuration in configs/<name>.json, a cell in
workloads/<name>.json, a metric's reader in metrics/<name>.py, a cell's
driver in harness/<kind>.py (the cell's "kind"), a configuration's plain
reference in reference/<module>.py (the configuration's "reference"). A
new configuration, cell, kind of traffic, reference or metric is a new
file; no file here changes."""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(kind: str, name: str, bench_dir: str) -> dict:
    path = os.path.join(bench_dir, kind, f"{name}.json")
    with open(path) as f:
        out = json.load(f)
    out.setdefault("name", name)
    out.setdefault("bench_dir", bench_dir)
    return out


def config(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return _json("configs", name, bench_dir)


def workload(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return _json("workloads", name, bench_dir)


def _module(package: str, name: str, bench_dir: str):
    """Module `name` of the benchmark's `package` (harness or reference),
    read from bench_dir/package/name.py; its relative imports resolve in
    that package."""
    full = f"{package}.{name}"
    if full not in sys.modules:
        importlib.import_module(package)
        spec = importlib.util.spec_from_file_location(
            full, os.path.join(bench_dir, package, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[full] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[full]
            raise
    return sys.modules[full]


def driver(wl: dict):
    """The module that runs a cell of the workload's "kind": its run(args,
    cfg, wl, device, window, t0)."""
    return _module("harness", wl["kind"], wl["bench_dir"])


def reference(cfg: dict):
    """The configuration's plain reference, named by its "reference": a
    module with load(path), the scene as the reference reads it, and
    Reference(scene, device, dtype, params=None)."""
    return _module("reference", cfg["reference"],
                   cfg.get("bench_dir", BENCH_DIR))


def reader(name: str, bench_dir: str = BENCH_DIR):
    """The module of metric `name` (its file may have dots in its name)."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(bench: dict, cell: str, trace: bool) -> list:
    """The metrics a run of `cell` reports: its end-to-end metrics with
    trace off, its per-layer metrics with trace on. A metric without a
    "workloads" list belongs to every cell (per-layer: every cell that
    reports the end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]
