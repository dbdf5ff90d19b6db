"""The benchmark's run: one cell, one seed, one window.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics with --trace 0,
its per-layer metrics with --trace 1), device, breakdown (with --trace
1), and last the numbers the check compared, each beside its limit (also
the last lines of standard error). Without a CUDA device, or with fewer
than the cell asks for, it exits with 2 and prints no result; with a JAX
module loaded in its process, with 3.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from . import registry

FORBIDDEN = ("jax", "jaxlib", "flax", "tpuprt")


def parse(argv):
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def main(argv=None, t0=None, device="cuda", window=None,
         bench_dir=registry.BENCH_DIR):
    """A run; `device` and `window` (a crop of the film) are for the CPU
    tests only: the command always takes the card."""
    import time
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    root = os.path.dirname(bench_dir)
    bench = registry.benchmark(root)
    cell = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch
    if device == "cuda" and (not torch.cuda.is_available() or
                             torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    wl = registry.workload(args.workload, bench_dir)
    cfg = registry.config(cell["config"], bench_dir)
    if root not in sys.path:
        sys.path.insert(0, root)
    run = registry.driver(wl).run(args, cfg, wl, device, window, t0)

    metrics = {}
    for m in registry.metrics_for(bench, args.workload, bool(args.trace)):
        v = registry.reader(m["name"], bench_dir).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    from . import compare
    correct, rows = compare.judge(run["numbers"], wl["limits"])
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"],
           "memory_peak_bytes": int(max(run["setup_peak"],
                                        run["window_peak"]))}
    out = {"correct": bool(correct), "attempted": int(run["attempted"]),
           "failed": 0 if correct else int(run["checked"]),
           "metrics": metrics, "device": dev}
    if args.trace:
        tr = run["trace"]
        dev.update(busy_s=tr.get("busy_s", 0.0), window_s=run["window_s"])
        out["breakdown"] = {"device_ops": tr.get("device_ops", []),
                            "idle_gaps": tr.get("idle_gaps", [])}
    out["checked"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    bad = forbidden_modules()
    if bad:
        print("modules of JAX or the JAX package were loaded: " +
              ", ".join(bad), file=sys.stderr)
        return 3
    if args.trace and cuda:
        import subprocess
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True)
        print("card (name, power limit) beside the shares: " +
              r.stdout.strip(), file=sys.stderr)
    for k, v, lim in rows:
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0
