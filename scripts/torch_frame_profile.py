#!/usr/bin/env python3
"""Device-time profile of the PyTorch port's serving frames and training
step on one GPU.

    python3 scripts/torch_frame_profile.py [--frames 8]
        [--path lod_stream|post|offload|pipeline] [--workload CELL]

By default serves the flat 1080p bench request (render_arrays, 100k
Gaussians, SH 3, 32x32 tiles, tight binning) and the tau-3 LOD request of
chip_smoke.py, and takes the flat training step of chip_smoke.py
(train.flat.train_step on the perturbed bench scene at 1080p). With
``--path lod_stream`` it builds chip_smoke.py's full-size LOD bench tree
(1,048,575 nodes, SH 3) and profiles render_lod_stream at tau 0 and tau 15
over the 26 bench cameras, after 6 warm-up frames.
With ``--path post`` it builds chip_smoke.py's post-optimization bench tree
(4,194,303 nodes, SH 1), perturbs it as phase [12] does and profiles
train.post.post_train_step over the 40-view 1080p orbit (each step's SPT
cut included), after 3 warm-up steps. With ``--path offload`` it packs the
same tree (unperturbed) into a host store, cuts the orbit with
train.offload.CachedCutter as chip_smoke.py's phase [13] does, and
profiles DeviceResidentTrainer.step resident on view 0, then over the
orbit with the next view prefetched (after a lap that fills the cache).
With ``--path pipeline`` it profiles train.flat.train_step on the center
chunk of chip_smoke.py's pipeline cell (9 shells, 2.25M points, 512x512)
at that cell's max_dup 2^22 and at 2^21. With ``--workload`` it runs a
cell of BENCHMARK.json (its configuration and traffic, seed 1) through the
set-up of its module in benchmark/drivers/ and profiles its units.
Each path runs under torch.profiler
and prints: the CUDA-event time per frame (or step), the host wall time,
the device busy time (union of CUDA kernel intervals), the busy share of
the CUDA-event window, kernel launches per frame, and the kernels with the
most device time. Then, from the same profile, a table of the program's
`hlod.*` spans (utils/metrics.span: cut, compaction, interpolation,
projection + SH, binning, blend, loss, backward, Adam and the entry
points): each span's host ms a frame, whole and less its nested spans,
and its device ms a frame through the profiler's launch correlation
(`FunctionEvent.device_time_total`, whole and less its nested spans),
with the kernels that take most of its own device time. Kernels that the
autograd engine launches from its device thread (the backward pass) fall
outside every span. Needs a CUDA device.
"""

import dataclasses

import argparse
import os
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def union_us(intervals):
    total, end = 0.0, -1e30
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def profile(name, serve, frames):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    for _ in range(3):
        serve()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        a.record()
        for _ in range(frames):
            serve()
        b.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    window_ms = a.elapsed_time(b)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = union_us([(e.time_range.start, e.time_range.end)
                        for e in kernels]) / 1e3
    by_name = defaultdict(float)
    for e in kernels:
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3
    print(f"{name}: {frames} frames, CUDA-event {window_ms / frames:.3f} "
          f"ms/frame, host wall {host_ms / frames:.3f} ms/frame", flush=True)
    if not kernels:
        print(f"{name}: device busy time not measured (the profiler "
              "recorded no CUDA kernels)")
    else:
        print(f"{name}: device busy {busy_ms / frames:.3f} ms/frame = "
              f"{busy_ms / window_ms:.3f} of the window (idle "
              f"{1 - busy_ms / window_ms:.3f}); "
              f"{len(kernels) / frames:.1f} kernel launches per frame")
        for k, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
            print(f"    {ms / frames:8.4f} ms/frame  {k[:110]}")
    span_table(name, prof, frames)


def _inside(e):
    """(the `hlod.*` spans nested directly in event e, the events between
    e and them)."""
    nested, own, todo = [], [], list(e.cpu_children)
    while todo:
        c = todo.pop()
        if c.name.startswith("hlod."):
            nested.append(c)
        else:
            own.append(c)
            todo.extend(c.cpu_children)
    return nested, own


def span_table(name, prof, frames):
    """Per `hlod.*` span name, a frame's host ms and device ms, each whole
    and self (less the nested spans), and the kernels with most of the
    span's self device time."""
    rows = defaultdict(lambda: [0, 0.0, 0.0, 0.0, 0.0])
    kernels = defaultdict(lambda: defaultdict(float))
    for e in prof.events():
        if not e.name.startswith("hlod."):
            continue
        nested, own = _inside(e)
        host = e.time_range.elapsed_us()
        r = rows[e.name]
        r[0] += 1
        r[1] += host
        r[2] += host - sum(c.time_range.elapsed_us() for c in nested)
        r[3] += e.device_time_total
        r[4] += e.device_time_total - sum(c.device_time_total
                                          for c in nested)
        for c in [e] + own:
            for k in c.kernels:
                kernels[e.name][k.name] += k.duration
    if not rows:
        print(f"{name}: no hlod.* spans in the profile")
        return
    print(f"{name}: spans per frame (ms): calls, host whole / self, device "
          "whole / self, top kernels of the span's self device time")
    for span, (n, h, hs, d, ds) in sorted(rows.items(),
                                          key=lambda kv: -kv[1][2]):
        print(f"    {span:18s} {n / frames:5.2f} {h / 1e3 / frames:9.3f} "
              f"{hs / 1e3 / frames:9.3f} {d / 1e3 / frames:9.3f} "
              f"{ds / 1e3 / frames:9.3f}")
        top = sorted(kernels[span].items(), key=lambda kv: -kv[1])[:4]
        for k, us in top:
            print(f"        {us / 1e3 / frames:8.4f}  {k[:100]}")


def lod_stream_profiles(dev, frames):
    """render_lod_stream on the full-size bench tree at tau 0 and 15."""
    import torch
    from chip_smoke import lod_bench_camera, lod_bench_tree, lod_target
    from hlod_gaussians_torch import render
    from hlod_gaussians_torch.config import RasterizerConfig
    from hlod_gaussians_torch.hierarchy import cut as cut_mod
    from hlod_gaussians_torch.models import gaussians as gm

    width, height = 1920, 1080
    state, _, build_s, _ = lod_bench_tree(dev)
    act = gm.activate(state)
    max_scale = torch.max(act.scales, dim=1).values
    pcache = cut_mod.build_parent_cache(state.nodes, act.means3d, max_scale)
    params = dict(means3d=act.means3d, scales=act.scales, quats=act.quats,
                  opacities=act.opacities, shs=act.shs)
    itab = cut_mod.build_interp_table(params, state.nodes)
    cfg = RasterizerConfig(backend="pallas", tile_w=32, tile_h=32,
                           max_dup=1 << 20, tight_binning=True)
    cams = [lod_bench_camera(i, width, height, dev) for i in range(26)]
    bg = torch.zeros(3, device=dev)
    print(f"lod_stream: {state.nodes.shape[0]} nodes, built in {build_s:.2f} "
          "s", flush=True)
    for tau in (0.0, 15.0):
        st, count = {}, [0]
        target = lod_target(tau, cams[0], width)

        def serve():
            cam = cams[count[0] % len(cams)]
            count[0] += 1
            with torch.no_grad():
                return render.render_lod_stream(
                    act.means3d, act.scales, act.quats, act.opacities,
                    act.shs, state.nodes, state.alive, cam.world_view,
                    cam.full_proj, cam.campos, cam.tan_fovx, cam.tan_fovy,
                    bg, target, st, pcache=pcache, interp_table=itab,
                    sh_degree=3, width=width, height=height, cfg=cfg,
                    k_max=512, use_frustum=False)

        for _ in range(3):               # with profile()'s 3: 6 warm-up
            serve()
        profile(f"lod_stream tau {tau:g}", serve, frames)
        path = st["pending"][1]
        masked = path == "MASKED"
        md = min(st["md"].get(path, cfg.max_dup), cfg.max_dup)
        print(f"lod_stream tau {tau:g}: path "
              f"{'masked' if masked else 'budgeted'}, budget {st['budget']}, "
              f"md {md}, n_truncated_frames "
              f"{st.get('n_truncated_frames', 0)}")


def post_profiles(dev, frames):
    """post_train_step on the post bench tree, each step's SPT cut
    included, over the orbit's views in turn."""
    import torch
    from chip_smoke import (post_bench_cameras, post_bench_dhier,
                            post_targets, perturb_post_dhier)
    from hlod_gaussians_torch.config import PostConfig, RasterizerConfig
    from hlod_gaussians_torch.hierarchy import spt as spt_mod
    from hlod_gaussians_torch.train import post

    width, height, extent = 1920, 1080, 25.0
    pcfg = PostConfig()
    d, build_s = post_bench_dhier(dev)
    cap = d.nodes.shape[0] + (1 << 16)
    cams = post_bench_cameras(width, height, dev)
    t = post_targets(d, cap, cams, dev, width, height)
    forest, gts = t["forest"], [v.image for v in t["views"]]
    cfg = RasterizerConfig(backend="pallas", tile_w=32, tile_h=32,
                           max_dup=t["max_dup"], tight_binning=True)
    bg = torch.zeros(3, device=dev)

    def cut(cam):
        return spt_mod.spt_cut_budgeted(
            forest, cap, cam.campos, cam.full_proj, pcfg.max_gaussian_budget,
            grow=pcfg.distance_multiplier_until_budget).gaussian_mask

    box = [post.init_post_train(post.create_from_dhier(
        perturb_post_dhier(d), cap, scene_radius=extent, device=dev))]
    count = [0]
    print(f"post: {d.nodes.shape[0]} nodes, built in {build_s:.2f} s, "
          f"forest {forest.n_spts} SPTs, max_dup {cfg.max_dup}", flush=True)

    def step():
        i = count[0] % len(cams)
        count[0] += 1
        cam = cams[i]
        box[0], aux = post.post_train_step(
            box[0], cut(cam), cam.world_view, cam.full_proj, cam.campos,
            cam.tan_fovx, cam.tan_fovy, gts[i], bg, extent, post=pcfg,
            cfg=cfg, width=width, height=height, sh_degree=1)
        return aux

    profile("post step", step, frames)
    aux = step()
    print(f"post step: truncated {bool(aux.truncated)}, loss "
          f"{float(aux.loss):.6f}, rendered rows {int(aux.n_rendered)}")


def offload_profiles(dev, frames, max_dup=1 << 20):
    """DeviceResidentTrainer.step on the post bench tree's working sets:
    resident on view 0, then the orbit with the next view prefetched."""
    import torch
    from chip_smoke import post_bench_cameras, post_bench_dhier
    from hlod_gaussians_torch.config import PostConfig, RasterizerConfig
    from hlod_gaussians_torch.train import offload, post

    width, height, extent = 1920, 1080, 25.0
    pcfg = PostConfig()
    d, _ = post_bench_dhier(dev)
    m = d.nodes.shape[0]
    state = post.create_from_dhier(d, m, scene_radius=extent, device=dev)
    forest = post.rebuild_spt(state, post=pcfg)
    store = offload.PackedStore.from_state(state)
    del state
    cams = post_bench_cameras(width, height, dev)
    cutter = offload.CachedCutter(forest, m, pcfg)
    rows = [torch.nonzero(cutter.cut(c.campos, c.full_proj).gaussian_mask
                          )[:, 0].int().cpu().numpy() for c in cams]
    budget = int(max(len(r) for r in rows) * 1.05) // 256 * 256 + 256
    cfg = RasterizerConfig(backend="pallas", tile_w=32, tile_h=32,
                           max_dup=max_dup, tight_binning=True)
    tr = offload.DeviceResidentTrainer(
        store, budget, cfg=cfg, width=width, height=height, k_max=512,
        scene_extent=extent, device=dev)
    gt = torch.full((3, height, width), 0.35, device=dev)
    bg = torch.zeros(3, device=dev)
    count = [0]
    print(f"offload: {m} nodes, budget {budget}, working sets "
          f"{min(map(len, rows))}-{max(map(len, rows))}", flush=True)

    def step(i, prefetch):
        c = cams[i % len(cams)]
        return tr.step(rows[i % len(cams)], c.world_view, c.full_proj,
                       c.campos, c.tan_fovx, c.tan_fovy, gt, bg,
                       prefetch_rows=(rows[(i + 1) % len(cams)] if prefetch
                                      else None))

    profile("offload resident step", lambda: step(0, False), frames)

    def orbit():
        count[0] += 1
        return step(count[0], True)

    for _ in range(len(cams)):
        orbit()
    profile("offload orbit step (prefetch)", orbit, frames)
    torch.cuda.synchronize()
    print(f"offload: last fetch {tr.last_fetch}, truncated "
          f"{bool(tr.last_truncated)}")


def pipeline_profiles(dev, frames):
    """flat.train_step on the center chunk of chip_smoke.py's pipeline cell
    (the scaffold-conditioned state at its start, 2^19 rows, SH 1) over the
    chunk's 512x512 views, with the cell's max_dup 2^22 and with 2^21."""
    import torch
    from chip_smoke import PIPE, SceneCamera, pipeline_scene
    from hlod_gaussians_torch.config import (OptimizationConfig,
                                             RasterizerConfig)
    from hlod_gaussians_torch.data.scene import SceneInfo
    from hlod_gaussians_torch.models import gaussians as gm
    from hlod_gaussians_torch.pipeline import chunking
    from hlod_gaussians_torch.train import coarse, flat
    pts, cols, views = pipeline_scene(dev, PIPE["per"])
    n_ring = 9 * PIPE["ring"]
    scene = SceneInfo(points=pts, colors=cols, train_cameras=[
        SceneCamera(v) for i, v in enumerate(views[:n_ring]) if i % 3],
        test_cameras=[], extent=9.0, center=np.zeros(3, np.float32))
    chunk = chunking.make_chunks(scene, chunk_size=2.9, point_padding=0.15,
                                 min_n_cams=1, min_points=1)[4]
    n = int(chunk.point_mask.sum())
    cap = PIPE["chunk_capacity"]
    scaffold = coarse.init_coarse(pts, cols, PIPE["coarse_capacity"], 9.0,
                                  skybox_num=1024, device=dev).gaussians
    g = gm.create_with_scaffold(
        scaffold, chunk.center, float(chunk.extent[0]),
        pts[chunk.point_mask], cols[chunk.point_mask], cap, sh_degree=1,
        n_exposures=64, max_scaffold_rows=max(0, cap - n - 4096),
        device=dev)
    del scaffold
    cams = [dataclasses.replace(c.v, exposure_idx=j)
            for j, c in enumerate(chunk.cameras)]
    bg = torch.zeros(3, device=dev)
    opt = OptimizationConfig(iterations=1500, densify_until_iter=0)
    print(f"pipeline chunk {chunk.index}: {int(g.alive.sum())} rows of "
          f"{cap}, {len(cams)} views", flush=True)
    for max_dup in (PIPE["max_dup"], PIPE["max_dup"] // 2):
        cfg = RasterizerConfig(backend="pallas", tile_w=16, tile_h=16,
                               max_dup=max_dup, tight_binning=True)
        box = [flat.init_flat_train(g), 0, None]

        def step():
            v = cams[box[1] % len(cams)]
            box[1] += 1
            box[0], box[2] = flat.train_step(
                box[0], v.world_view, v.full_proj, v.campos, v.tan_fovx,
                v.tan_fovy, v.image, bg, exposure_idx=v.exposure_idx,
                scene_extent=9.0, opt=opt, cfg=cfg, width=v.width,
                height=v.height, sh_degree=1, skybox_locked=True)

        profile(f"chunk step, max_dup {max_dup}", step, frames)
        print(f"chunk step, max_dup {max_dup}: last step truncated "
              f"{bool(box[2].truncated)}", flush=True)


def cell_profiles(dev, frames, workload):
    """A benchmark cell's units after its Session's set-up."""
    import importlib
    from benchmark.harness import core
    _, cfg, traffic = core.cell_parts(core.load_bench(), workload)
    mod = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    sess = mod.Session(cfg, traffic, 1, dev,
                       lambda msg: print(msg, flush=True))
    profile(workload, sess.unit, frames)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--path", choices=("serve_train", "lod_stream", "post",
                                       "offload", "pipeline"),
                    default="serve_train",
                    help="the flat and LOD requests and the train step, "
                    "the full-size LOD stream, the post step, the "
                    "out-of-core step, or a pipeline chunk's train step")
    ap.add_argument("--workload", help="a cell of BENCHMARK.json instead")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import load_bench_scene
    from hlod_gaussians_torch import convert, render
    from hlod_gaussians_torch.config import RasterizerConfig
    from hlod_gaussians_torch.data.dhier import load_dhier
    from hlod_gaussians_torch.models import gaussians as gm
    from hlod_gaussians_torch.train import flat
    from hlod_gaussians_torch.train.post import create_from_dhier
    from hlod_gaussians_torch.utils.camera import make_camera

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, f"torch {torch.__version__}", flush=True)
    dev = torch.device("cuda")
    if args.workload:
        cell_profiles(dev, args.frames, args.workload)
        return 0
    if args.path == "lod_stream":
        lod_stream_profiles(dev, args.frames)
        return 0
    if args.path == "post":
        post_profiles(dev, args.frames)
        return 0
    if args.path == "offload":
        offload_profiles(dev, args.frames)
        return 0
    if args.path == "pipeline":
        pipeline_profiles(dev, args.frames)
        return 0
    width, height = 1920, 1080
    cfg = RasterizerConfig(backend="pallas", tile_w=32, tile_h=32,
                           max_dup=352 * 1024, tight_binning=True)
    s = load_bench_scene()
    t = lambda a: torch.as_tensor(a, device=dev)
    means, scales = t(s["xyz"]), torch.exp(t(s["log_scale"]))
    quats = t(s["quat"])
    quats = quats / torch.linalg.norm(quats, dim=-1, keepdim=True)
    opac = torch.sigmoid(t(s["opacity_logit"][:, 0]))
    shs = torch.cat([t(s["f_dc"]), t(s["f_rest"])], dim=1)
    valid = torch.ones((means.shape[0],), dtype=torch.bool, device=dev)
    bg = torch.zeros(3, device=dev)
    cam = make_camera(np.eye(3), np.zeros(3), 1.2, 0.8, width, height,
                      device=dev)

    def serve_flat():
        with torch.no_grad():
            return render.render_arrays(
                means, scales, quats, opac, shs, valid, cam.world_view,
                cam.full_proj, cam.campos, cam.tan_fovx, cam.tan_fovy, bg,
                sh_degree=3, width=width, height=height, cfg=cfg)

    profile("flat", serve_flat, args.frames)

    d = load_dhier(os.path.join(ROOT, "tests", "fixtures", "oracle",
                                "hierarchy.dhier.gz"))
    g = d.pos.shape[0]
    state = create_from_dhier(
        d, capacity=g + 100_000, skybox_num=100_000,
        scene_radius=float(np.linalg.norm(d.pos, axis=1).max()), device=dev)
    act = gm.activate(state)
    lod_cam = make_camera(np.eye(3), np.array([0.0, 0.0, 16.0]), 1.2, 0.8,
                          width, height, device=dev)
    lod_cfg = RasterizerConfig(backend="pallas", tile_w=32, tile_h=32,
                               max_dup=1 << 21, tight_binning=True)
    target = render.tau_to_threshold(3.0, lod_cam.tan_fovx, width)

    def serve_lod():
        with torch.no_grad():
            return render.render_lod(
                act.means3d, act.scales, act.quats, act.opacities, act.shs,
                state.nodes, state.alive, lod_cam.world_view,
                lod_cam.full_proj, lod_cam.campos, lod_cam.tan_fovx,
                lod_cam.tan_fovy, bg, target, sh_degree=d.sh_degree,
                width=width, height=height, budget=2048,
                n_skybox=state.n_skybox, cfg=lod_cfg)

    profile("lod tau 3", serve_lod, args.frames)
    del state, act

    # the training step of chip_smoke.py [5]: the bench scene with f_dc
    # + 0.3 and xyz jitter, fit toward its own render
    n = means.shape[0]
    truth = convert.state_from_numpy(
        dict(s, exposure=np.eye(3, 4, dtype=np.float32)[None],
             alive=np.ones(n, bool), nodes=np.full((n, 6), -1, np.int32)),
        n_skybox=0, device=dev)
    gt = serve_flat().image
    noise = np.random.default_rng(7).normal(size=(n, 3)).astype(np.float32)
    box = [flat.init_flat_train(dataclasses.replace(
        truth, f_dc=truth.f_dc + 0.3, xyz=truth.xyz + t(noise * 0.01)))]

    def train():
        box[0], _ = flat.train_step(
            box[0], cam.world_view, cam.full_proj, cam.campos, cam.tan_fovx,
            cam.tan_fovy, gt, bg, exposure_idx=0, scene_extent=8.0, cfg=cfg,
            width=width, height=height, sh_degree=3)

    profile("train step", train, args.frames)
    return 0


if __name__ == "__main__":
    sys.exit(main())
