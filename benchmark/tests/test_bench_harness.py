"""The harness on the CPU, on crops of the films: the result line, cells
found by name, no JAX, no run without a card."""
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT, WINDOWS
from harness import main as hm, registry, trace
from harness.seeds import Seeds

CONTRACT = {"correct", "attempted", "failed", "metrics", "device"}


def run_cpu(cell, trace_on=0, seed=2147483999, bench_dir=registry.BENCH_DIR,
            window=None):
    out, err = io.StringIO(), io.StringIO()
    cfg = cell.split(".")[0]
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = hm.main(["--workload", cell, "--seed", str(seed), "--seconds",
                      "0.5", "--trace", str(trace_on)], device="cpu",
                     window=window or WINDOWS.get(cfg, WINDOWS["bench3"]),
                     bench_dir=bench_dir)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


@pytest.mark.parametrize("trace_on", [0, 1])
def test_last_line_has_the_contract_keys(trace_on):
    rc, res, err = run_cpu("config4_big.pool", trace_on)
    assert rc == 0 and res["correct"] is True
    extra = {"checked"} | ({"breakdown"} if trace_on else set())
    assert set(res) == CONTRACT | extra
    assert list(res)[-1] == "checked"
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(res["device"])
    if trace_on:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"load_s", "frame_wall_s"} <= set(res["metrics"])
    else:
        # config4_big's pool frames are too host-bound for frame_s to
        # hold a bound: it is this cell's per-layer frame_wall_s instead.
        assert "setup_s" in res["metrics"]
        assert "frame_s" not in res["metrics"]
    # The compared numbers are the last lines of standard error.
    tail = err.strip().splitlines()[-len(res["checked"]):]
    assert all(line.startswith("check ") for line in tail)


def test_grad_cell_runs_and_checks():
    rc, res, _ = run_cpu("config4_big.grad")
    assert rc == 0 and res["correct"] is True
    assert set(res["checked"]) == {"loss_gap", "grad_gap", "change_gap",
                                   "target_off"}
    assert "step_s" in res["metrics"]


def test_new_config_workload_and_metric_are_found_by_name(tmp_path):
    """A configuration with its own reference module, a cell of a new
    kind of traffic with its own driver, and a metric, each added as new
    files, with no file of the harness or the reference edited."""
    root = tmp_path / "checkout"
    bench = root / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "*.pbrt"))
    b = registry.benchmark(ROOT)
    (bench / "configs" / "box.json").write_text(json.dumps(
        {"source": "test", "scene": "benchmark/configs/bench3.pbrt",
         "reference": "boxref", "precision": "float32", "reduced": []}))
    (bench / "reference" / "boxref.py").write_text(
        "from . import render\n"
        "load = render.load\n\n\n"
        "class Reference(render.Reference):\n"
        "    def frame(self, *a, **k):\n"
        "        out = super().frame(*a, **k)\n"
        "        self.rays = dict(self.rays, box=1)\n"
        "        return out\n")
    (bench / "harness" / "frames_once.py").write_text(
        "from . import frames\n\n\n"
        "def run(args, cfg, wl, device, window, t0):\n"
        "    return dict(frames.run(args, cfg, wl, device, window, t0),\n"
        "                kind='frames_once')\n")
    (bench / "workloads" / "box.small.json").write_text(json.dumps(
        {"config": "box", "kind": "frames_once", "driver": "scan",
         "limits": {"off_share": 0.01, "mean_gap": 0.001}}))
    (bench / "metrics" / "frames_done.py").write_text(
        "def read(run):\n"
        "    ok = run['kind'] == 'frames_once' and run['ref_rays']['box']\n"
        "    return run['n'] if ok else None\n")
    b["configs"].append({"name": "box", "source": "test",
                         "file": "benchmark/configs/box.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "box.small", "config": "box",
                           "traffic": "small", "chips": 1, "why": "test"})
    b["end_to_end"].append({"name": "frames_done", "unit": "frames",
                            "better": "higher", "bound": 0.01,
                            "source": "host_clock",
                            "workloads": ["box.small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    def sources():
        return {os.path.join(d, p): open(os.path.join(BENCH, d, p)).read()
                for d in ("harness", "reference")
                for p in os.listdir(os.path.join(BENCH, d))
                if p.endswith(".py")}
    before = sources()
    rc, res, _ = run_cpu("box.small", bench_dir=str(bench),
                         window=WINDOWS["bench3"])
    assert rc == 0 and res["correct"] is True
    assert res["metrics"]["frames_done"]["value"] >= 1
    assert set(res["metrics"]) == {"setup_s", "frames_done"}
    assert before == sources()


def test_nothing_loaded_is_jax_or_the_jax_package():
    """A whole CPU run of a cell, the reference and the calibration
    loaded, in a fresh process: no module whose top-level name is jax,
    jaxlib, flax or tpuprt (tpuprt_torch is another name)."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import io, contextlib\n"
        "from harness import main as hm, calibrate\n"
        "from reference import render, scene, geometry, sampling\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    rc = hm.main(['--workload', 'bench3.scan', '--seed', '5',\n"
        "                  '--seconds', '0.1', '--trace', '0'],\n"
        "                 device='cpu', window=(100, 104, 100, 104))\n"
        "names = {m.split('.')[0] for m in sys.modules}\n"
        "assert rc == 0 and 'tpuprt_torch' in names, rc\n"
        "print(sorted(names & {'jax', 'jaxlib', 'flax', 'tpuprt'}),\n"
        "      hm.forbidden_modules())\n") % (BENCH, ROOT)
    env = dict(os.environ)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[] []"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpuprt_torch_x", sys)
    assert "tpuprt" not in hm.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert hm.forbidden_modules() == ["jaxlib"]


def test_a_run_without_a_cuda_device_fails_and_prints_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "config4_big.pool", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=ROOT, env=env, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "bench3.pool", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=tmp_path, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_metrics_of_each_cell():
    b = registry.benchmark()
    names = {w["name"] for w in b["workloads"]}
    for cell in names:
        e2e = {m["name"] for m in registry.metrics_for(b, cell, False)}
        layer = registry.metrics_for(b, cell, True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        for m in layer:       # each moves an end-to-end metric of the cell
            assert m["moves"] in e2e
            registry.reader(m["name"])


def test_trace_reduction_of_a_hand_made_trace():
    dev = [(0, 10, "k1"), (5, 20, "k2"), (40, 50, "k1"), (100, 110, "k3")]
    host = [(0, 200, "aten::outer"), (25, 35, "aten::nonzero"),
            (60, 90, "cudaLaunchKernel")]
    r = trace.reduce((dev, host))
    assert r["busy_s"] == pytest.approx(40e-6)
    assert r["kernels"]["k1"] == pytest.approx(20e-6)
    gaps = dict(r["idle_gaps"])
    assert gaps["aten::nonzero"] == pytest.approx(20e-6)   # 20..40
    assert gaps["aten::outer"] == pytest.approx(50e-6)     # 50..100


def test_seeds_are_the_seeds_and_take_large_ones():
    a, b = Seeds(2 ** 31 + 12345), Seeds(2 ** 31 + 12345)
    assert [a.frame(k) for k in range(5)] == [b.frame(k) for k in range(5)]
    assert a.checked(10, 2) == b.checked(10, 2)
    assert a.frame(0) != Seeds(2 ** 31 + 12346).frame(0)
    assert all(0 <= a.frame(k) < 2 ** 32 for k in range(100))
