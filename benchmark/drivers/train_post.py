"""Driver of `hlod_gaussians_torch.pipeline.full_train.post_iteration`, one
view of hierarchy post-optimization (the SPT working-set cut, the masked
render with kernel B1, L1 + D-SSIM and the working-set opacity term, the
backward with kernel B2 into the whole capacity-padded tree, masked Adam)
on a merged tree that starts perturbed from its ground truth.

Set-up: the leaves from the seed and the tree over them (the benchmark's
`data.build_tree`, as a merged chunk hierarchy is loaded), the targets
(the unperturbed tree rendered by the reference at the reference's own
working set of every view; their seconds, `reference_s`, are the
reference's and are left out of `setup_s`, their memory out of the
peak), the program's state and its SPT forest (`rebuild_spt`, once: the
cell's densify interval puts no round in a window), the view order (the
program's own Metropolis-Hastings walk over the cameras, seeded); then
the first `check_steps` steps through the window's own call (their
losses, working sets, the first gradient as the optimizer's first moment
gives it, and the change of the parameters after them are kept) and the
rest of a cycle of steps. A unit is one step, ended by reading its
feedback on the host in the program's one copy (`read_post_step`), as a
training log does; a step whose frame overflowed its entry capacity or
whose loss is not finite fails.

`correct` holds the kept readings to the reference's steps from the same
start: `ws_gap`, the rows where the program's working set and the
reference's differ over the reference's working-set rows, the worst of
the checked steps; and `loss_gap`, `grad_gap` and `change_gap` as
train_flat.gaps defines them.
"""

from __future__ import annotations

import math
import statistics
import time

import numpy as np
import torch

from benchmark.drivers.train_flat import _norms, gaps
from benchmark.harness import data, data_post, reference
from benchmark.harness import reference_post as ref_post
from benchmark.harness import work as work_mod

LEAVES = reference.LEAVES
ROW_LEAVES = ref_post.ROW_LEAVES


class Session:
    unit_name = "step"
    profile_cycles = 1

    def __init__(self, cfg, traffic, seed, device, log):
        # the entry point first: a program without it fails here, at once
        from hlod_gaussians_torch.pipeline.full_train import (post_iteration,
                                                              read_post_step)
        from hlod_gaussians_torch.config import (OptimizationConfig,
                                                 PostConfig, RasterizerConfig)
        from hlod_gaussians_torch.models.gaussians import GaussianState
        from hlod_gaussians_torch.ops import rasterize_cuda
        from hlod_gaussians_torch.train import post as post_mod
        from hlod_gaussians_torch.utils import scheduler
        from hlod_gaussians_torch.utils.camera import Camera
        self.post_iteration, self.read_post_step = (post_iteration,
                                                    read_post_step)
        self.cfg, self.traffic, self.seed, self.device = (cfg, traffic, seed,
                                                          device)
        self.log = log
        if device.type == "cuda":
            rasterize_cuda.build()
        self.tile = tuple(cfg["tile"])
        self.post = PostConfig(**traffic["post"])
        self.degree = min(cfg["sh_degree"], self.post.max_sh_degree)
        self.cams = data_post.orbit(cfg, traffic, device)
        self.cycle = len(self.cams)
        t0 = time.perf_counter()
        tree = data.build_tree(*data_post.post_leaves(cfg, seed, device))
        clean = data_post.post_start(tree, cfg["capacity"], self.cycle)
        start = data_post.post_start(tree, cfg["capacity"], self.cycle,
                                     traffic["perturb"]["f_dc_shift"])
        del tree
        self._sync()
        log(f"tree: {int(clean['alive'].sum())} nodes in "
            f"{time.perf_counter() - t0:.3f} s; capacity {cfg['capacity']}")

        t0 = time.perf_counter()
        self.targets, rows = [], []
        for cam, ws in zip(self.cams, self._working_sets(clean)):
            self.targets.append(ref_post.render(clean, ws, cam, self.degree,
                                                self.tile))
            rows.append(int(ws.sum()))
        del clean
        self._sync()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        self.reference_s = time.perf_counter() - t0
        log(f"targets: {len(self.targets)} reference renders in "
            f"{self.reference_s:.3f} s; working-set rows min {min(rows)}, "
            f"mean {statistics.mean(rows):.0f}, max {max(rows)}")

        state = GaussianState(**{k: start[k] for k in LEAVES + (
            "alive", "nodes")})
        del start
        self.ts = post_mod.init_post_train(state)
        t0 = time.perf_counter()
        self.forest = post_mod.rebuild_spt(state, post=self.post)
        self._sync()
        log(f"rebuild_spt: {self.forest.n_spts} SPTs, "
            f"{self.forest.entry_gid.shape[0]} entries in "
            f"{time.perf_counter() - t0:.3f} s")
        del state
        self.views = [
            Camera(width=c.width, height=c.height, world_view=c.view,
                   full_proj=c.full_proj, campos=c.campos,
                   tan_fovx=torch.tensor(c.tan_fovx, dtype=torch.float32,
                                         device=device),
                   tan_fovy=torch.tensor(c.tan_fovy, dtype=torch.float32,
                                         device=device), image=gt)
            for c, gt in zip(self.cams, self.targets)]
        centers = np.stack([c.campos.cpu().numpy() for c in self.cams])
        self.order = scheduler.view_schedule(
            centers, self.cycle, traffic["schedule_steps"], seed=seed,
            walk=True)
        self.step_kw = dict(
            opt=OptimizationConfig(**traffic["optimizer"]), post=self.post,
            cfg=RasterizerConfig(backend="pallas", tile_w=self.tile[0],
                                 tile_h=self.tile[1], max_dup=cfg["max_dup"],
                                 tight_binning=cfg["tight_binning"]),
            k_max=cfg["k_max"], sh_degree=self.degree,
            densify_every=self.post.densify_interval,
            generator=torch.Generator(device=device).manual_seed(seed),
            centers=centers)
        self.bg = torch.zeros(3, device=device)
        self.i = 0

        b1 = traffic["optimizer_b1"]
        losses, masks = [], []
        p0 = self.ts.gaussians.params()
        for step in range(traffic["check_steps"]):
            losses.append(self.unit()["loss"])
            masks.append(self.last.mask.cpu())
            if step == 0:
                grad = _norms({k: m / (1.0 - b1)
                               for k, m in self.ts.adam.m.items()})
        params = self.ts.gaussians.params()
        change = _norms({k: params[k] - p0[k] for k in LEAVES})
        self.readings = dict(losses=losses, grad=grad, change=change,
                             masks=masks)
        del p0, params
        while self.i < self.cycle:
            self.unit()
        self.last = None
        self.snapshot = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _working_sets(self, p, cams=None):
        """The reference's working set of each camera (default: the
        cycle's) over the tree of raw parameters `p`, one at a time."""
        post = self.traffic["post"]
        spt = ref_post.spt_nodes(p, p["nodes"], p["alive"], post)
        for cam in self.cams if cams is None else cams:
            yield ref_post.working_set(spt, cam, post)

    def _start(self):
        """The training start, made from the seed again."""
        tree = data.build_tree(*data_post.post_leaves(self.cfg, self.seed,
                                                      self.device))
        return data_post.post_start(tree, self.cfg["capacity"], self.cycle,
                                    self.traffic["perturb"]["f_dc_shift"])

    def unit(self):
        k = int(self.order[self.i % len(self.order)])
        t0 = time.perf_counter()
        self.ts, self.forest, fb = self.post_iteration(
            self.ts, self.forest, self.i, self.views[k], self.bg,
            self.cfg["scene_extent"], **self.step_kw)
        t1 = time.perf_counter()
        read = self.read_post_step(fb)
        t2 = time.perf_counter()
        self.last = fb
        self.i += 1
        return dict(dispatch=t1 - t0, lat=t2 - t0, loss=read["loss"],
                    ws_rows=read["n_cut"], view=k,
                    failed=read["truncated"] or not math.isfinite(
                        read["loss"]))

    def end_to_end(self, records, seconds):
        px = self.cfg["width"] * self.cfg["height"]
        ws = [r["ws_rows"] for r in records]
        self.log(f"{len(records)} steps, loss {records[0]['loss']:.6f} -> "
                 f"{records[-1]['loss']:.6f}; working-set rows min "
                 f"{min(ws)}, mean {statistics.mean(ws):.0f}, max {max(ws)}")
        return dict(train_mpix_s=len(records) * px / seconds / 1e6)

    def before_trace(self):
        self.snapshot = {k: v.detach().clone()
                         for k, v in self.ts.gaussians.params().items()
                         if k in ROW_LEAVES}

    def release(self):
        self.ts = self.forest = self.views = self.last = None
        self.step_kw = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _steps(self, dtype):
        """The reference's readings from the same start, in `dtype`: the
        working sets of the checked views, from the start's tree."""
        start = self._start()
        p0 = {k: start[k].to(dtype) for k in LEAVES}
        n = self.traffic["check_steps"]
        views = []
        for i in range(n):
            k = int(self.order[i])
            cam = self.cams[k]
            cam = cam._replace(view=cam.view.to(dtype),
                               full_proj=cam.full_proj.to(dtype),
                               campos=cam.campos.to(dtype))
            views.append((cam, self.targets[k].to(dtype)))
        ws = list(self._working_sets(dict(p0, nodes=start["nodes"],
                                          alive=start["alive"]),
                                     [c for c, _ in views]))
        losses, g, p3 = ref_post.post_steps(
            p0, views, ws, self.degree, self.tile,
            self.traffic["optimizer"], self.traffic["post"],
            self.cfg["scene_extent"], n, b1=self.traffic["optimizer_b1"])
        return dict(losses=losses, grad=_norms(g),
                    change=_norms({k: p3[k].float() - start[k]
                                   for k in LEAVES}), masks=ws)

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
        ws_gap = 0.0
        for i, (a, b) in enumerate(zip(prog["masks"], ref["masks"])):
            a, b = a.cpu(), b.cpu()
            differ = int((a != b).sum())
            n_ref = max(int(b.sum()), 1)
            self.log(f"checked step {i}: working set {int(a.sum())} rows, "
                     f"reference {n_ref}, {differ} differ")
            ws_gap = max(ws_gap, differ / n_ref)
        limits = self.traffic["limits"]
        return [("ws_gap", ws_gap, limits["ws_gap"])] + [
            (n, v, limits[n]) for n, v in gaps(prog, ref)]

    def work(self):
        """What a step needs, averaged over the views, on the parameters
        as the traced part of the window found them, at the reference's
        working set of each view and the training SH degree."""
        p = self.snapshot
        start = self._start()
        ws = []
        for cam, rows in zip(self.cams, self._working_sets(start)):
            _, w = ref_post.render(p, rows, cam, self.degree, self.tile,
                                   count=True)
            ws.append(w)
        del start
        mean = reference.Work(*(statistics.mean(x) for x in zip(*ws)))
        self.log(f"work a step: {mean.pairs:.0f} needed pairs naming "
                 f"{mean.gaussians:.0f} Gaussians, {mean.visible:.0f} "
                 "visible")
        return work_mod.train_step(mean, self.cfg["width"]
                                   * self.cfg["height"], self.degree)
