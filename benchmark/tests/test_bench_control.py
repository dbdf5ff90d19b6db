"""What `correct` must catch. The control, the reference in bfloat16 put
in the renderer's place, fails each cell's limits (here on crops; on the
card at the cells' sizes: harness/calibrate.py --mode control). A run
driven with the renderer broken underneath (the chip's look skipped, a
crop of the film) comes out not correct for each fault a cell can have:
frames, a stale frame, half of each pixel's samples, a tile of the image
altered; gradient steps, a step that leaves the parameters unchanged,
half of the pixels left out of the loss, the loss altered where it is
made."""
import contextlib
import io
import json
import os

import pytest
import torch

from conftest import BENCH, WINDOWS
from harness import compare, frames, grad, main as hm, registry
from harness.seeds import Seeds


def run(cell, seed=2147480001):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = hm.main(["--workload", cell, "--seed", str(seed), "--seconds",
                      "0.3", "--trace", "0"], device="cpu",
                     window=WINDOWS[cell.split(".")[0]])
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["config4_big.pool", "bench3.pool",
                                  "bench3.scan"])
def test_the_bfloat16_control_fails_the_frame_limits(cell):
    wl = registry.workload(cell)
    cfg = registry.config(wl["config"])
    win = WINDOWS[wl["config"]]
    fs = [Seeds(7).frame(0)]
    ref, _ = frames.reference_frames(cfg, fs, "cpu", win)
    ctl, _ = frames.reference_frames(cfg, fs, "cpu", win, torch.bfloat16)
    ok, _ = compare.judge(frames.numbers(ctl, ref, win), wl["limits"])
    assert not ok


def test_the_bfloat16_control_fails_the_gradient_limits():
    wl = registry.workload("config4_big.grad")
    cfg = registry.config("config4_big")
    S, win = Seeds(7), WINDOWS["config4_big"]
    ref, rt, _ = grad.reference_steps(cfg, wl, S, "cpu", win)
    ctl, ct, _ = grad.reference_steps(cfg, wl, S, "cpu", win,
                                      torch.bfloat16)
    nums = compare.grad_numbers(ctl, ref)
    nums["target_off"] = frames.numbers([ct], [rt], win)["off_share"]
    ok, _ = compare.judge(nums, wl["limits"])
    assert not ok


def _stale(render):
    last = {}

    def broken(*a, **k):
        got = render(*a, **k)
        prev = last.get("img", got)
        last["img"] = got
        return prev
    return broken


def _half(render):
    def broken(sc, opts, *a, **k):
        spp = opts.sampler.pixelsamples
        return render(sc, opts._replace(sampler=opts.sampler._replace(
            pixelsamples=spp // 2)), *a, **k)
    return broken


def _tile(render):
    def broken(*a, **k):
        rgb, alpha = render(*a, **k)
        rgb = rgb.copy()
        x0, y0 = WINDOWS["bench3"][0], WINDOWS["bench3"][2]
        rgb[y0:y0 + 2, x0:x0 + 2] *= 1.5        # 4 of the crop's 36 pixels
        return rgb, alpha
    return broken


@pytest.mark.parametrize("fault", [_stale, _half, _tile])
@pytest.mark.parametrize("cell", ["bench3.pool", "bench3.scan"])
def test_a_broken_frame_is_not_correct(monkeypatch, cell, fault):
    from tpuprt_torch import render as R
    assert run(cell)["correct"] is True
    monkeypatch.setattr(R, "render", fault(R.render))
    res = run(cell)
    assert res["correct"] is False and res["failed"] > 0


def test_a_broken_pool_frame_of_config4_big_is_not_correct(monkeypatch):
    from tpuprt_torch import render as R
    monkeypatch.setattr(R, "render", _stale(R.render))
    assert run("config4_big.pool")["correct"] is False


def _noop_step(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a, **k: None)


def _half_batch(monkeypatch):
    from tpuprt_torch.parallel import shard
    fn = shard.render_loss_fn
    monkeypatch.setattr(shard, "render_loss_fn", lambda sc, o, px, py, s, *a,
                        **k: fn(sc, o, px[::2], py[::2], s[::2], *a, **k))


def _altered_loss(monkeypatch):
    from tpuprt_torch.parallel import shard
    fn = shard.render_loss_fn
    monkeypatch.setattr(shard, "render_loss_fn",
                        lambda *a, **k: 1.01 * fn(*a, **k))


@pytest.mark.parametrize("fault", [_noop_step, _half_batch, _altered_loss])
def test_a_broken_gradient_step_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    res = run("config4_big.grad")
    assert res["correct"] is False


@pytest.mark.card
def test_each_cell_runs_correct_on_the_card(card):
    """One short run of every cell on the card, through the command."""
    import subprocess
    import sys
    root = os.path.dirname(BENCH)
    for w in registry.benchmark()["workloads"]:
        r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                            w["name"], "--seed", "2147480077", "--seconds",
                            "2", "--trace", "0"], capture_output=True,
                           text=True, cwd=root, timeout=900)
        assert r.returncode == 0, r.stderr[-2000:]
        assert json.loads(r.stdout.strip().splitlines()[-1])["correct"]
