"""Driver of `hlod_gaussians_torch.render.render_lod_stream`, the viewer's
streaming hierarchical-LOD render, for one viewer in a closed loop: the
next camera of the cycle is requested as soon as the last frame has
arrived, that is once its uint8 [H, W, 3] image is in host memory
(clamped to [0, 1], times 255, truncated, as the viewer's render function
hands it to the server). A frame's latency runs from its request to its
arrival; frames a second and the latency's tail are what the viewer gets.

Set-up: the leaves from the seed and the tree over them (benchmark's
inputs, as a create-hierarchy file would be loaded), the program's
per-tree tables (`build_parent_cache`, `build_interp_table`), then one
frame more than a cycle of cameras, so the stream's budget and capacity
state has adapted to every view. A unit
is one frame; a frame whose entries overflowed the binning capacity, or
whose cut outgrew its budget and dropped nodes (the stream's own feedback
for that frame), fails.

`correct`: `check_frames` delivered frames, drawn from the seed over the
window, are rendered again by the reference (the cut at the tau's
threshold, the parent interpolation, projection + SH, the blend with the
LOD alpha, the uint8 image), and compared: the mean absolute difference
of the uint8 images in levels and the relative gap of the number of nodes
drawn, each the worst over the frames; the traffic's `limits` name the
numbers a cell compares.
"""

from __future__ import annotations

import random
import statistics
import time

import numpy as np
import torch

from benchmark.harness import data, reference, work as work_mod


def threshold(tau, tan_fovx, width):
    """Pixel granularity tau -> size threshold (render_hierarchy.py's
    (2 (tau + 0.5)) tan(fovx / 2) / (width / 2)), floored at 1e-9."""
    return max(2.0 * (tau + 0.5) * tan_fovx / (0.5 * width), 1e-9)


class Session:
    unit_name = "frame"
    profile_cycles = 1

    def __init__(self, cfg, traffic, seed, device, log):
        from hlod_gaussians_torch import render
        from hlod_gaussians_torch.config import RasterizerConfig
        from hlod_gaussians_torch.hierarchy import cut
        from hlod_gaussians_torch.ops import rasterize_cuda
        self.cfg, self.traffic, self.device, self.log = (cfg, traffic,
                                                         device, log)
        if device.type == "cuda":
            rasterize_cuda.build()
        self.render = render
        self.tile = tuple(cfg["tile"])
        self.cams = data.cameras(cfg, traffic, device)
        self.cycle = len(self.cams)
        t0 = time.perf_counter()
        self.tree = data.build_tree(*data.lod_leaves(cfg, seed, device))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        log(f"tree: {self.tree['nodes'].shape[0]} nodes in "
            f"{time.perf_counter() - t0:.3f} s")
        t = self.tree
        self.args = (t["pos"], t["scale"], t["quat"], t["opacity"], t["sh"],
                     t["nodes"], t["alive"])
        self.kw = dict(
            pcache=cut.build_parent_cache(
                t["nodes"], t["pos"], torch.max(t["scale"], dim=1).values),
            interp_table=cut.build_interp_table(
                dict(means3d=t["pos"], scales=t["scale"], quats=t["quat"],
                     opacities=t["opacity"], shs=t["sh"]), t["nodes"]),
            sh_degree=cfg["sh_degree"], width=cfg["width"],
            height=cfg["height"], max_budget=cfg["max_budget"],
            cfg=RasterizerConfig(backend="pallas", tile_w=self.tile[0],
                                 tile_h=self.tile[1], max_dup=cfg["max_dup"],
                                 tight_binning=cfg["tight_binning"]),
            k_max=cfg["k_max"], use_frustum=cfg["use_frustum"])
        self.bg = torch.zeros(3, device=device)
        self.prog_cams = [
            (c.view, c.full_proj, c.campos,
             torch.tensor(c.tan_fovx, dtype=torch.float32, device=device),
             torch.tensor(c.tan_fovy, dtype=torch.float32, device=device))
            for c in self.cams]
        self.target = max(float(render.tau_to_threshold(
            traffic["tau"], float(self.prog_cams[0][3]), cfg["width"])),
            1e-9)
        self.state = {}
        self.i = 0
        self.sampling = False
        for _ in range(self.cycle + 1):
            self.unit()
        self.rng = random.Random(seed)
        self.kept = []
        self.seen = 0
        self.sampling = True

    def unit(self):
        k = self.i % self.cycle
        t0 = time.perf_counter()
        with torch.no_grad():
            out, _ = self.render.render_lod_stream(
                *self.args, *self.prog_cams[k], self.bg, self.target,
                self.state, **self.kw)
        t1 = time.perf_counter()
        image = (torch.clamp(out.image, 0, 1).permute(1, 2, 0) * 255).to(
            torch.uint8).cpu().numpy()
        t2 = time.perf_counter()
        (fb, _), budget, _ = self.state["pending"]
        n_sel, truncated, n_dup = fb.tolist()
        dropped = budget != "MASKED" and n_sel > budget
        self.i += 1
        if self.sampling:
            self._sample((k, image, n_sel))
        return dict(dispatch=t1 - t0, lat=t2 - t0, n_dup=n_dup,
                    failed=bool(truncated) or dropped)

    def _sample(self, frame):
        """Reservoir sampling of `check_frames` frames, seeded."""
        self.seen += 1
        n = self.traffic["check_frames"]
        if len(self.kept) < n:
            self.kept.append(frame)
        else:
            j = self.rng.randrange(self.seen)
            if j < n:
                self.kept[j] = frame

    def end_to_end(self, records, seconds):
        lat = [r["lat"] for r in records]
        self.log(f"{len(records)} frames; latency median "
                 f"{1e3 * statistics.median(lat):.3f} ms, p95 "
                 f"{1e3 * float(np.percentile(lat, 95)):.3f} ms; entries "
                 f"at most {max(r['n_dup'] for r in records)} of "
                 f"{self.cfg['max_dup']}")
        return dict(serve_frames_s=len(records) / seconds,
                    frame_ms_p95=1e3 * float(np.percentile(lat, 95)))

    def before_trace(self):
        pass

    def release(self):
        self.kw = self.state = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _tree(self, dtype):
        return {k: (v.to(dtype) if v.is_floating_point() else v)
                for k, v in self.tree.items()}

    def _frame(self, tree, k, count=False):
        cam = self.cams[k]
        if tree["pos"].dtype != torch.float32:
            d = tree["pos"].dtype
            cam = cam._replace(view=cam.view.to(d),
                               full_proj=cam.full_proj.to(d),
                               campos=cam.campos.to(d))
        target = threshold(self.traffic["tau"], cam.tan_fovx, cam.width)
        return reference.lod_frame(tree, cam, target, self.tile,
                                   self.cfg["sh_degree"], count=count)

    def check(self, mode="program"):
        ref_tree = self._tree(torch.float32)
        low = self._tree(torch.bfloat16) if mode == "control" else None
        mad, cut_gap = 0.0, 0.0
        for k, image, n_sel in self.kept:
            img, n_ref = self._frame(ref_tree, k)
            ref_u8 = reference.to_uint8(img).cpu().numpy().astype(np.int16)
            if low is not None:
                img, n_sel = self._frame(low, k)
                image = reference.to_uint8(img).cpu().numpy()
            d = float(np.abs(image.astype(np.int16) - ref_u8).mean())
            g = abs(n_sel - n_ref) / max(n_ref, 1)
            self.log(f"camera {k}: mean |d| {d:.6f} levels, nodes drawn "
                     f"{n_sel} / reference {n_ref}")
            mad, cut_gap = max(mad, d), max(cut_gap, g)
        limits = self.traffic["limits"]
        return [(n, v, limits[n]) for n, v in (("image_mad", mad),
                                               ("cut_gap", cut_gap))
                if n in limits]

    def work(self):
        """What a frame needs, averaged over the cameras of the cycle."""
        ws, drawn = [], []
        for k in range(self.cycle):
            _, n, w = self._frame(self.tree, k, count=True)
            ws.append(w)
            drawn.append(n)
        mean = reference.Work(*(statistics.mean(x) for x in zip(*ws)))
        self.log(f"work a frame: {statistics.mean(drawn):.0f} nodes drawn, "
                 f"{mean.pairs:.0f} needed pairs naming "
                 f"{mean.gaussians:.0f} Gaussians")
        return work_mod.lod_frame(mean, self.cfg["width"] * self.cfg["height"],
                                  self.cfg["sh_degree"],
                                  self.tree["nodes"].shape[0],
                                  statistics.mean(drawn))
