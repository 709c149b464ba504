"""Driver of `hlod_gaussians_torch.train.flat.train_step`, the per-view
training step (render with kernel B1, L1 + D-SSIM, backward with kernel
B2, sparse Adam), on a scene that starts perturbed from its ground truth.

Set-up: the scene and its perturbed start from the seed, the targets
(the unperturbed scene rendered by the reference at every view; their
seconds, `reference_s`, are the reference's and are left out of
`setup_s`, their memory out of the peak), the
program's training state; then the first `check_steps` steps through the
window's own call on views that all differ (their losses, the first
gradient as the optimizer's first moment gives it, and the change of the
parameters after them are kept, as norms) and the rest of a cycle of
views, so every view has been trained once. A unit is one step, ended by
reading its loss on the host, as a training log does; a step whose frame
overflowed its entry capacity or whose loss is not finite fails.

`correct` holds the kept readings to the reference's steps from the same
start: each step's loss, each leaf's first-gradient norm, and each
moving leaf's change norm (a leaf moves unless the reference's gradient
norm is under a thousandth of the median leaf's), as the relative gap of
the norms against the larger of the leaf's and the median leaf's.
"""

from __future__ import annotations

import math
import statistics
import time

import torch

from benchmark.harness import data, reference, work as work_mod

LEAVES = reference.LEAVES


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(t.float())) for k, t in
            tensors.items()}


def gaps(prog: dict, ref: dict) -> list:
    """The numbers compared: [(name, value)] of the program's (or the
    control's) readings against the reference's."""
    loss_gap = max(abs(p - r) / abs(r)
                   for p, r in zip(prog["losses"], ref["losses"]))
    g_med = statistics.median(ref["grad"].values())
    grad_gap = max(abs(prog["grad"][k] - ref["grad"][k])
                   / max(ref["grad"][k], g_med) for k in LEAVES)
    moving = [k for k in LEAVES if ref["grad"][k] >= 1e-3 * g_med]
    d_med = statistics.median(ref["change"][k] for k in moving)
    change_gap = max(abs(prog["change"][k] - ref["change"][k])
                     / max(ref["change"][k], d_med) for k in moving)
    return [("loss_gap", loss_gap), ("grad_gap", grad_gap),
            ("change_gap", change_gap)]


class Session:
    unit_name = "step"
    profile_cycles = 2

    def __init__(self, cfg, traffic, seed, device, log):
        from hlod_gaussians_torch.config import (OptimizationConfig,
                                                 RasterizerConfig)
        from hlod_gaussians_torch.models.gaussians import GaussianState
        from hlod_gaussians_torch.ops import rasterize_cuda
        from hlod_gaussians_torch.train import flat
        self.cfg, self.traffic, self.seed, self.device = (cfg, traffic, seed,
                                                          device)
        self.log = log
        if device.type == "cuda":
            rasterize_cuda.build()
        self.flat = flat
        self.tile = tuple(cfg["tile"])
        self.cams = data.cameras(cfg, traffic, device)
        self.cycle = len(self.cams)
        scene = data.flat_scene(cfg, seed, device)
        t0 = time.perf_counter()
        self.targets = [reference.render(*reference.activate(scene),
                                         cfg["sh_degree"], cam, self.tile)
                        for cam in self.cams]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        self.reference_s = time.perf_counter() - t0
        log(f"targets: {len(self.targets)} reference renders in "
            f"{self.reference_s:.3f} s")
        start = data.perturb(scene, traffic, seed, device)
        del scene
        n = start["xyz"].shape[0]
        state = GaussianState(
            **{k: start[k].clone() for k in LEAVES},
            alive=torch.ones((n,), dtype=torch.bool, device=device),
            nodes=torch.full((n, 6), -1, dtype=torch.int32, device=device))
        self.ts = flat.init_flat_train(state)
        self.step_kw = dict(
            exposure_idx=traffic["exposure_idx"],
            scene_extent=cfg["scene_extent"],
            opt=OptimizationConfig(**traffic["optimizer"]),
            cfg=RasterizerConfig(backend="pallas", tile_w=self.tile[0],
                                 tile_h=self.tile[1], max_dup=cfg["max_dup"],
                                 tight_binning=cfg["tight_binning"]),
            width=cfg["width"], height=cfg["height"], k_max=cfg["k_max"],
            sh_degree=cfg["sh_degree"],
            big_gauss_frac=traffic["big_gauss_frac"])
        self.bg = torch.zeros(3, device=device)
        self.prog_cams = [
            (c.view, c.full_proj, c.campos,
             torch.tensor(c.tan_fovx, dtype=torch.float32, device=device),
             torch.tensor(c.tan_fovy, dtype=torch.float32, device=device))
            for c in self.cams]
        self.i = 0

        b1 = traffic["optimizer_b1"]
        losses = []
        p0 = {k: start[k] for k in LEAVES}
        for step in range(traffic["check_steps"]):
            losses.append(self.unit()["loss"])
            if step == 0:
                grad = _norms({k: m / (1.0 - b1)
                               for k, m in self.ts.adam.m.items()})
        params = self.ts.gaussians.params()
        change = _norms({k: params[k] - p0[k] for k in LEAVES})
        self.readings = dict(losses=losses, grad=grad, change=change)
        del start, p0, params
        while self.i < self.cycle:
            self.unit()
        self.snapshot = None

    def unit(self):
        k = self.i % self.cycle
        t0 = time.perf_counter()
        ts, aux = self.flat.train_step(self.ts, *self.prog_cams[k],
                                       self.targets[k], self.bg,
                                       **self.step_kw)
        t1 = time.perf_counter()
        loss = float(aux.loss)
        truncated = bool(aux.truncated)
        t2 = time.perf_counter()
        self.ts = ts
        self.i += 1
        return dict(dispatch=t1 - t0, lat=t2 - t0, loss=loss,
                    failed=truncated or not math.isfinite(loss))

    def end_to_end(self, records, seconds):
        px = self.cfg["width"] * self.cfg["height"]
        self.log(f"{len(records)} steps, loss {records[0]['loss']:.6f} -> "
                 f"{records[-1]['loss']:.6f}")
        return dict(train_mpix_s=len(records) * px / seconds / 1e6)

    def before_trace(self):
        self.snapshot = {k: v.detach().clone()
                         for k, v in self.ts.gaussians.params().items()}

    def release(self):
        self.ts = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _views(self, dtype):
        n = self.traffic["check_steps"]
        out = []
        for cam, gt in zip(self.cams[:n], self.targets[:n]):
            out.append((cam._replace(view=cam.view.to(dtype),
                                     full_proj=cam.full_proj.to(dtype),
                                     campos=cam.campos.to(dtype)),
                        gt.to(dtype)))
        return out

    def _steps(self, dtype):
        """The reference's readings from the same start, in `dtype`."""
        start = data.perturb(data.flat_scene(self.cfg, self.seed,
                                             self.device),
                             self.traffic, self.seed, self.device)
        p0 = {k: start[k].to(dtype) for k in LEAVES}
        losses, g, p3, _ = reference.train_steps(
            p0, self._views(dtype), self.cfg["sh_degree"], self.tile,
            self.traffic["optimizer"], self.cfg["scene_extent"],
            self.traffic["big_gauss_frac"], self.traffic["check_steps"])
        return dict(losses=losses, grad=_norms(g),
                    change=_norms({k: p3[k].float() - start[k]
                                   for k in LEAVES}))

    def check(self, mode="program"):
        ref = self._steps(torch.float32)
        prog = (self._steps(torch.bfloat16) if mode == "control"
                else self.readings)
        self.log("reference losses " + " ".join(f"{x:.7f}" for x in
                                                 ref["losses"])
                 + "; program " + " ".join(f"{x:.7f}" for x in
                                           prog["losses"]))
        for name in ("grad", "change"):
            self.log(f"{name} norms, reference / program: " + ", ".join(
                f"{k} {ref[name][k]:.6g} / {prog[name][k]:.6g}"
                for k in LEAVES))
        limits = self.traffic["limits"]
        return [(n, v, limits[n]) for n, v in gaps(prog, ref)]

    def work(self):
        """What a step needs, averaged over the views, on the parameters
        as the traced part of the window found them."""
        p = self.snapshot
        ws = []
        for cam in self.cams:
            _, w = reference.render(*reference.activate(p),
                                    self.cfg["sh_degree"], cam, self.tile,
                                    count=True)
            ws.append(w)
        mean = reference.Work(*(statistics.mean(x) for x in zip(*ws)))
        self.log(f"work a step: {mean.pairs:.0f} needed pairs naming "
                 f"{mean.gaussians:.0f} Gaussians, {mean.visible:.0f} "
                 "visible")
        return work_mod.train_step(mean, self.cfg["width"]
                                   * self.cfg["height"],
                                   self.cfg["sh_degree"])
