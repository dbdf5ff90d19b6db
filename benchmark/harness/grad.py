"""Gradient steps: scene parameters fitted by Adam through the renderer's
differentiable loss, `parallel.shard.render_loss_fn` (the scan Li under
autograd), over every pixel's sample 0 of the film, against a target
the renderer makes in set-up (its scan render at the file's values).

The parameters are the checkerboard's two colours, started at half the
file's, and the distant light's radiance. One object, the step with its
parameters and Adam's state, is built in set-up, driven through steps
1-3 (their losses, the first gradient as Adam holds it, the change over
the three are kept for the check) and handed on to the window, whose steps
continue it. Step k draws its samples from the run's seed and k.
"""
from __future__ import annotations

import dataclasses
import gc
import time

import torch

from . import compare, frames, registry
from .seeds import Seeds
from .trace import profiled

LEAVES = ("tex1", "tex2", "distant_L")
BETAS = (0.9, 0.999)
EPS = 1e-8


class Fit:
    """The training step of the renderer under test."""

    def __init__(self, cfg, wl, device, window, seeds):
        from tpuprt_torch import render as R
        from tpuprt_torch.scene.data import LIGHT_DISTANT
        self.device = device
        t = time.perf_counter()
        sc, opts = frames.setup(cfg, {"driver": "scan"}, device, window)
        self.load_s = time.perf_counter() - t
        self.opts = opts._replace(half_readback=False)
        rgb, self.target_alpha = R.render(
            sc, self.opts._replace(seed=seeds.target), device=device)
        self.target = torch.from_numpy(rgb).to(device)
        self.sc = sc
        node = next(i for i, m in enumerate(sc.textures.nodes)
                    if m.kind == "checkerboard2d")
        self.kids = list(sc.textures.nodes[node].children)
        self.light = sc.lights.kinds_list.index(LIGHT_DISTANT)
        fp = sc.textures.fparams
        start = [float(wl.get("start_scale", 0.5)) * fp[k, 0:3]
                 for k in self.kids] + [sc.lights.spectrum[self.light]]
        self.params = [p.detach().clone().requires_grad_(True)
                       for p in start]
        self.opt = torch.optim.Adam(self.params, lr=float(wl["lr"]),
                                    betas=BETAS, eps=EPS)
        x0, x1, y0, y1 = window or (0, opts.xres, 0, opts.yres)
        ys, xs = torch.meshgrid(torch.arange(y0, y1), torch.arange(x0, x1),
                                indexing="ij")
        self.px = xs.reshape(-1).to(torch.int32).to(device)
        self.py = ys.reshape(-1).to(torch.int32).to(device)
        self.s = torch.zeros_like(self.px)
        self.seeds = seeds
        self.k = 0

    def scene(self):
        sc = self.sc
        fp = sc.textures.fparams.clone()
        for k, p in zip(self.kids, self.params[:2]):
            fp[k, 0:3] = p
        spec = sc.lights.spectrum.clone()
        spec[self.light] = self.params[2]
        return dataclasses.replace(
            sc, textures=dataclasses.replace(sc.textures, fparams=fp),
            lights=dataclasses.replace(sc.lights, spectrum=spec))

    def forward(self):
        from tpuprt_torch.parallel import shard
        opts = self.opts._replace(seed=self.seeds.frame(self.k))
        return shard.render_loss_fn(self.scene(), opts, self.px, self.py,
                                    self.s, self.target, device=self.device)

    def step(self, spans=None):
        """One Adam step; spans: a dict given the forward's and the
        backward's seconds, each closed by a synchronize."""
        t = time.perf_counter()
        loss = self.forward()
        if spans is not None:
            frames.sync(self.device)
            t2 = time.perf_counter()
            spans["forward_s"] = spans.get("forward_s", 0.0) + t2 - t
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        if spans is not None:
            frames.sync(self.device)
            spans["backward_s"] = spans.get("backward_s", 0.0) + \
                time.perf_counter() - t2
        self.opt.step()
        self.k += 1
        return loss

    def first_steps(self):
        """Steps 1-3: (losses, the first gradient from Adam's state, the
        parameters' change), each by leaf."""
        p0 = [p.detach().clone() for p in self.params]
        losses = [self.step().item()]
        # Adam's first moment after one step is (1 - beta1) g1; a step that
        # never reached Adam left no state: no gradient arrived.
        g1 = {n: (self.opt.state[p].get("exp_avg", torch.zeros_like(p)) /
                  (1.0 - BETAS[0])).cpu().numpy()
              for n, p in zip(LEAVES, self.params)}
        losses += [self.step().item() for _ in range(2)]
        change = {n: (p.detach() - q).cpu().numpy()
                  for n, p, q in zip(LEAVES, self.params, p0)}
        return dict(losses=losses, g1=g1, change=change)


def reference_steps(cfg, wl, seeds, device, window, dtype=torch.float32):
    """The reference's three steps from the same start, its own target
    and its own Adam; and its target image."""
    rr = registry.reference(cfg)
    sc = rr.load(frames.scene_path(cfg))
    target, talpha = rr.Reference(sc, device, dtype).frame(seeds.target,
                                                           window)
    c = next(m["Kd"][1] for m in sc.materials if m["kind"] == "matte" and
             m["Kd"][0] == "checker")
    dist = next(li for li in sc.lights if li["kind"] == "distant")
    scale = float(wl.get("start_scale", 0.5))
    leaves = {n: torch.tensor(v, dtype=dtype, device=device,
                              requires_grad=True)
              for n, v in zip(LEAVES, (scale * c["tex1"], scale * c["tex2"],
                                       dist["L"]))}
    ref = rr.Reference(sc, device, dtype, params=leaves)
    lr = float(wl["lr"])
    m = {n: torch.zeros_like(v) for n, v in leaves.items()}
    v2 = {n: torch.zeros_like(v) for n, v in leaves.items()}
    p0 = {n: v.detach().clone() for n, v in leaves.items()}
    losses, g1 = [], None
    for k in range(3):
        loss = ref.loss(seeds.frame(k), target, window)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        losses.append(loss.item())
        if g1 is None:
            g1 = {n: g.float().cpu().numpy() for n, g in zip(leaves, grads)}
        with torch.no_grad():
            for (n, p), g in zip(leaves.items(), grads):
                m[n] = BETAS[0] * m[n] + (1 - BETAS[0]) * g
                v2[n] = BETAS[1] * v2[n] + (1 - BETAS[1]) * g * g
                mh = m[n] / (1 - BETAS[0] ** (k + 1))
                vh = v2[n] / (1 - BETAS[1] ** (k + 1))
                p -= lr * mh / (torch.sqrt(vh) + EPS)
    change = {n: (p.detach() - p0[n]).float().cpu().numpy()
              for n, p in leaves.items()}
    return (dict(losses=losses, g1=g1, change=change),
            (target.float().cpu().numpy(), talpha.float().cpu().numpy()),
            sc)


def run(args, cfg, wl, device, window, t0):
    out = {}
    seeds = Seeds(args.seed)
    fit = Fit(cfg, wl, device, window, seeds)
    out["load_s"] = fit.load_s
    first = fit.first_steps()
    frames.sync(device)
    out["setup_peak"] = frames._peak(device, reset=True)
    out["setup_s"] = time.perf_counter() - t0

    cuda = torch.device(device).type == "cuda"
    limit = min(args.seconds, float(wl.get("trace_seconds", args.seconds))) \
        if args.trace else args.seconds
    spans = {} if args.trace else None
    events, tr, n = [], {}, 0
    with profiled(args.trace, tr):
        t1 = time.perf_counter()
        while True:
            if cuda:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            fit.step(spans)
            if cuda:
                ev[1].record()
                events.append(ev)
            n += 1
            if time.perf_counter() - t1 >= limit:
                break
        frames.sync(device)
        t2 = time.perf_counter()
    out.update(window_s=t2 - t1, n=n, step_s=(t2 - t1) / n, trace=tr,
               step_times=[a.elapsed_time(b) * 1e-3 for a, b in events],
               window_peak=frames._peak(device), attempted=n,
               **(spans or {}))
    target = (fit.target.cpu().numpy(), fit.target_alpha)
    del fit
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ref, ref_target, sc = reference_steps(cfg, wl, seeds, device, window)
    nums = compare.grad_numbers(first, ref)
    nums["target_off"] = frames.numbers(
        [target], [ref_target], window)["off_share"]
    out.update(numbers=nums, ref_scene=sc, checked=3, first=first, ref=ref)
    return out
