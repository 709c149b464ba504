"""Command-line entry points (port of hlod_gaussians_tpu/cli.py).

The reference exposes its pipeline as a family of argparse scripts
(scripts/full_train.py, train_*.py, hierarchy_viewer.py, ...). Here one
`python -m hlod_gaussians_torch.cli <command>` front end drives the same
stages through the library API, on the card: `full-train`, `eval`,
`viewer` and `create-hierarchy`, with the JAX package's flags and defaults;
`--backend pallas` selects the CUDA blend kernels, `xla` the plain PyTorch
path.

    python -m hlod_gaussians_torch.cli full-train -s <colmap dir> -o <out>
    python -m hlod_gaussians_torch.cli eval --hierarchy merged.dhier -s <dir>
    python -m hlod_gaussians_torch.cli viewer --hierarchy merged.dhier
    python -m hlod_gaussians_torch.cli create-hierarchy in.ply out.dhier
"""

from __future__ import annotations

import argparse
import json
import os
import time


def cmd_full_train(args):
    from hlod_gaussians_torch.config import (ModelConfig, OptimizationConfig,
                                             PostConfig, RasterizerConfig)
    from hlod_gaussians_torch.data.scene import load_colmap_scene
    from hlod_gaussians_torch.pipeline import full_train
    from hlod_gaussians_torch.utils.metrics import MetricsLogger

    mcfg = ModelConfig(
        source_path=args.source_path, model_path=args.output,
        images=args.images, depths=args.depths,
        alpha_masks=args.alpha_masks, eval=args.eval,
        resolution=args.resolution, white_background=args.white_background,
        skip_scale_big_gauss=args.skip_scale_big_gauss,
        scaffold_file=args.scaffold_file, skybox_num=args.skybox_num,
        train_test_exp=args.train_test_exp)
    scene = load_colmap_scene(mcfg.source_path, images_dir=mcfg.images,
                              depths_dir=mcfg.depths,
                              alpha_masks_dir=mcfg.alpha_masks,
                              eval_split=mcfg.eval,
                              train_test_exp=mcfg.train_test_exp)
    pcfg = full_train.PipelineConfig(
        coarse_iters=args.coarse_iters, chunk_iters=args.chunk_iters,
        post_iters=args.post_iters, skybox_num=mcfg.skybox_num,
        chunk_size=args.chunk_size)
    out_dir = mcfg.model_path
    logger = MetricsLogger(os.path.join(out_dir, "metrics.jsonl"),
                           echo=True)
    cfg = RasterizerConfig(backend=args.backend, tile_w=16, tile_h=8,
                           max_dup=1 << args.max_dup_log2)
    try:
        merged = full_train.run_pipeline(
            scene, output_dir=out_dir, pcfg=pcfg, cfg=cfg, mcfg=mcfg,
            opt=OptimizationConfig(), post=PostConfig(), logger=logger)
    finally:
        logger.close()
    print(f"merged hierarchy: {merged.nodes.shape[0]} nodes -> "
          f"{os.path.join(out_dir, 'merged.dhier')}")


def cmd_eval(args, device=None):
    """The granularity sweep on the test split (JAX cli.py:53-119): a .hier
    cuts on its stored boxes; a .dhier with --tau on boxes built from the
    tree; one JSON line a level."""
    import numpy as np
    import torch

    from hlod_gaussians_torch import eval as eval_mod
    from hlod_gaussians_torch.config import PipelineConfig, RasterizerConfig
    from hlod_gaussians_torch.data import dhier as dhier_io
    from hlod_gaussians_torch.data.scene import load_colmap_scene, load_view
    from hlod_gaussians_torch.hierarchy import boxes as boxes_mod
    from hlod_gaussians_torch.ops.lpips import make_lpips
    from hlod_gaussians_torch.train import post as post_mod

    device = torch.device("cuda") if device is None else torch.device(device)
    boxes = None
    if args.hierarchy.endswith(".hier"):
        # upstream box-metric hierarchy: cut on projected box size
        # (render_hierarchy.py protocol)
        d, nb = boxes_mod.upstream_to_fork(dhier_io.load_hier(args.hierarchy))
        cap = 1 << (int(np.ceil(np.log2(d.pos.shape[0] + 1))))
        state = post_mod.create_from_dhier(d, capacity=cap, device=device)
        pad = lambda a: np.concatenate(
            [a, np.zeros((cap - a.shape[0],) + a.shape[1:], a.dtype)])
        boxes = (pad(nb.lo), pad(nb.hi), pad(nb.max_side))
    else:
        d = dhier_io.load_dhier(args.hierarchy)
        cap = 1 << (int(np.ceil(np.log2(d.pos.shape[0] + 1))))
        state = post_mod.create_from_dhier(d, capacity=cap, device=device)
        if args.tau:
            # the tau protocol cuts on PROJECTED BOXES
            # (render_hierarchy.py:56-80); a .dhier carries no boxes, so
            # build them bottom-up from the tree (host numpy, as the JAX
            # package does)
            nb = boxes_mod.compute_node_boxes(
                state.nodes.cpu().numpy(), state.xyz.cpu().numpy(),
                np.exp(state.log_scale.cpu().numpy()).max(-1),
                alive=state.alive.cpu().numpy())
            boxes = (nb.lo, nb.hi, nb.max_side)
    scene = load_colmap_scene(args.source_path, images_dir=args.images,
                              eval_split=True)
    cams = [load_view(ci, device=device)
            for ci in scene.test_cameras[:args.max_views]]
    gts = [c.image for c in cams]
    levels = [float(x) for x in args.levels.split(",")]
    pipe = PipelineConfig(antialiasing=args.antialiasing, debug=args.debug)
    results = eval_mod.eval_views(
        state, cams, gts, levels, level_is_tau=args.tau, boxes=boxes,
        cfg=RasterizerConfig(backend=args.backend, tile_w=16, tile_h=8),
        antialiasing=pipe.antialiasing,
        lpips_fn=make_lpips(args.lpips_weights, device=device))
    if pipe.debug:
        # the per-limit node-count curve that localizes a bad cut before
        # rendering is even attempted
        from hlod_gaussians_torch import debug as debug_mod
        cam0 = cams[0]
        zdir = cam0.world_view[:3, 2]
        curve = debug_mod.gaussians_per_limit(state, cam0.campos, zdir,
                                              limits=levels)
        print(f"[debug] nodes per level {levels}: {curve}")
    for r in results:
        print(json.dumps(dict(level=r.level, psnr=round(r.psnr, 3),
                              ssim=round(r.ssim, 4), lpips=r.lpips,
                              gmsd=round(r.gmsd, 5),
                              mean_rendered=r.mean_rendered)))


_RES_BUCKETS = ((256, 192), (512, 384), (800, 600), (1024, 768),
                (1280, 960), (1600, 1200), (1920, 1440))


def _res_bucket(w, h):
    """Round a client window up to a fixed bucket (the JAX package renders
    at most one shape a bucket, since a TPU compile takes minutes a shape);
    kept so that the served bytes match the JAX package's: a window is
    rendered at its bucket and sampled back to the nearest pixel."""
    for bw, bh in _RES_BUCKETS:
        if w <= bw and h <= bh:
            return bw, bh
    return _RES_BUCKETS[-1]


class _LaggedCount:
    """A device count read one frame late: each push starts a non-blocking
    copy into pinned host memory and returns the previous push's value
    (the JAX package's copy_to_host_async), so no frame waits on its own
    count."""

    def __init__(self, device):
        import torch

        pin = torch.device(device).type == "cuda"
        self.bufs = [torch.zeros((), dtype=torch.int64, pin_memory=pin)
                     for _ in range(2)]
        self.events = [torch.cuda.Event() if pin else None for _ in range(2)]
        self.i = 0
        self.pending = False

    def push(self, count):
        prev = None
        if self.pending:
            j = 1 - self.i
            if self.events[j] is not None:
                self.events[j].synchronize()
            prev = int(self.bufs[j])
        self.bufs[self.i].copy_(count, non_blocking=True)
        if self.events[self.i] is not None:
            self.events[self.i].record()
        self.i, self.pending = 1 - self.i, True
        return prev


def _spt_shs(nodes_np, capacity):
    """False colours a subtree (render_SPTs): every row takes the hash
    colour of its root, as SH DC."""
    import numpy as np

    from hlod_gaussians_torch.models.gaussians import NODE_PARENT

    root_of = np.arange(capacity)
    par = nodes_np[:, NODE_PARENT]
    for _ in range(64):
        nxt = np.where(par[root_of] >= 0, par[root_of], root_of)
        if (nxt == root_of).all():
            break
        root_of = nxt
    rng_cols = ((root_of * 2654435761) % 255) / 255.0
    spt_dc = np.stack([rng_cols, (rng_cols * 7.13) % 1.0,
                       (rng_cols * 3.77) % 1.0], axis=-1)
    return ((spt_dc - 0.5) / 0.28209479177387814)[:, None, :].astype(
        np.float32)


def make_viewer(args, device=None):
    """The viewer's server and its ``render_fn(cam, opts) -> uint8 [H, W,
    3]`` (JAX cli.py:132-266): the .dhier loaded on ``device`` (the card by
    default), the initial cut, a budget controller (budget 2^19), the parent
    cache and the interp table built once; per frame two
    incremental_cut_steps, the active count read one frame late into the
    status, the sliders (granularity, distance_multiplier, freeze_view,
    render_SPTs), the optional occlusion cull and render_lod at the
    window's resolution bucket."""
    import numpy as np
    import torch

    from hlod_gaussians_torch import render as render_mod
    from hlod_gaussians_torch.config import RasterizerConfig
    from hlod_gaussians_torch.data import dhier as dhier_io
    from hlod_gaussians_torch.hierarchy import cut as cut_mod
    from hlod_gaussians_torch.models import gaussians as gm
    from hlod_gaussians_torch.train import post as post_mod
    from hlod_gaussians_torch.viewer import maintenance as maint
    from hlod_gaussians_torch.viewer.server import ViewerServer

    device = torch.device("cuda") if device is None else torch.device(device)
    d = dhier_io.load_dhier(args.hierarchy)
    cap = 1 << (int(np.ceil(np.log2(d.pos.shape[0] + 1))))
    state = post_mod.create_from_dhier(d, capacity=cap, device=device)
    act = gm.activate(state)
    cfg = RasterizerConfig(backend=args.backend, tile_w=16, tile_h=16,
                           max_dup=1 << 20)

    # persistent incremental cut (runtime_switching.cu:236-491 re-design)
    budget = 1 << 19
    active = torch.as_tensor(maint.initial_cut(state.nodes, state.alive),
                             device=device)
    ctrl = maint.BudgetController(budget=budget)
    max_scale = torch.max(act.scales, dim=-1).values
    # the tree is static while the viewer runs: one parent gather, then
    # gather-free cuts a frame
    pcache = cut_mod.build_parent_cache(state.nodes, act.means3d, max_scale)
    # static child + parent feature table: a frame's interpolation is one
    # lerp
    itab = cut_mod.build_interp_table(
        dict(means3d=act.means3d, scales=act.scales, quats=act.quats,
             opacities=act.opacities, shs=act.shs), state.nodes)
    spt_shs = torch.as_tensor(_spt_shs(state.nodes.cpu().numpy(),
                                       state.capacity), device=device)
    n_alive = int(state.alive.sum())
    lagged = _LaggedCount(device)
    frozen_vp = [None]          # viewer slider state (hierarchy_viewer.py
    bg = torch.zeros(3, device=device)                     # :220-247)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    def render_fn(cam, opts):
        nonlocal active
        sliders = opts.get("slider", {})
        target = float(sliders.get("granularity", ctrl.target))
        target *= max(float(sliders.get("distance_multiplier", 1.0)), 1e-6)
        if sliders.get("freeze_view", 0) > 0:
            if frozen_vp[0] is None:
                frozen_vp[0] = cam.campos.astype(np.float32)
        else:
            frozen_vp[0] = None
        cut_vp = f32(frozen_vp[0] if frozen_vp[0] is not None
                     else cam.campos)
        # a few split / collapse passes a frame: the cut tracks the camera
        # incrementally, with no host sync inside the frame; the budget
        # controller reads the previous frame's count
        for _ in range(2):
            active, _, _ = maint.incremental_cut_step(
                state.nodes, act.means3d, max_scale, state.alive, active,
                cut_vp, max(target, 1e-9))
        prev_n = lagged.push(torch.sum(active))
        if prev_n is not None:
            # regulate ctrl.target (the slider base) for the NEXT frame;
            # this frame keeps the slider-scaled target, so the cut mask
            # and the render's ts / kids use the same granularity
            ctrl.update(prev_n)
            # SIBR status blob fields (hierarchy_viewer.py:538)
            srv.status["train_params"] = {
                "Num_Rendered": prev_n,
                "Percentage_Rendered": prev_n / max(n_alive, 1)}

        wv, fp, campos = (f32(cam.world_view), f32(cam.full_proj),
                          f32(cam.campos))
        tfx, tfy = f32(cam.tan_fovx), f32(cam.tan_fovy)
        render_mask = active
        if getattr(args, "occlusion_cull", False):
            # render only the cut nodes that contributed to a low-res
            # pre-pass (hierarchy_viewer.py:280-282); the maintained cut
            # itself is untouched
            from hlod_gaussians_torch.models import reorder
            render_mask = reorder.occlusion_cull(state, active, wv, fp,
                                                 campos, tfx, tfy)

        shs_r, itab_r = act.shs, itab
        if sliders.get("render_SPTs", 0) > 0:
            shs_r = torch.cat([spt_shs, torch.zeros_like(act.shs[:, 1:])],
                              dim=1)
            itab_r = None      # false-colour mode: interpolate on the fly

        bw, bh = _res_bucket(cam.width, cam.height)
        with torch.no_grad():
            out, _ = render_mod.render_lod(
                act.means3d, act.scales, act.quats, act.opacities, shs_r,
                state.nodes, state.alive, wv, fp, campos, tfx, tfy, bg,
                max(target, 1e-9), None, render_mask, pcache, None, itab_r,
                sh_degree=state.sh_degree, width=bw, height=bh,
                budget=budget, n_skybox=state.n_skybox, cfg=cfg)
        img = torch.clamp(out.image, 0, 1).permute(1, 2, 0)
        if (bw, bh) != (cam.width, cam.height):
            yi = np.clip((np.arange(cam.height) * (bh / cam.height))
                         .astype(int), 0, bh - 1)
            xi = np.clip((np.arange(cam.width) * bw / cam.width).astype(int),
                         0, bw - 1)
            img = img[torch.as_tensor(yi, device=device)][
                :, torch.as_tensor(xi, device=device)]
        return (img * 255).to(torch.uint8).cpu().numpy()

    srv = ViewerServer(args.host, args.port)
    srv.status = dict(num_gaussians=n_alive, sh_degree=state.sh_degree)
    return srv, render_fn


def cmd_viewer(args, device=None):
    """Serve SIBR requests until interrupted (a KeyboardInterrupt closes
    the server)."""
    srv, render_fn = make_viewer(args, device)
    print(f"viewer listening on {args.host}:{srv.port}", flush=True)
    try:
        while True:
            if srv.poll_once(render_fn) is None:
                time.sleep(0.02)   # idle: no busy spin on try_connect
    except KeyboardInterrupt:
        srv.close()


def cmd_create_hierarchy(args, device=None):
    """Offline hierarchy build of a 3DGS .ply into a .dhier (JAX cli.py
    :277-305): the port's builder on ``device`` (the card by default), or
    the C++ creator with --native; the .gdf graph dump next to it."""
    from hlod_gaussians_torch.data import dhier as dhier_io

    if args.native:
        from hlod_gaussians_torch.native import build_hierarchy_file
        n = build_hierarchy_file(args.input, args.output)
    else:
        import numpy as np

        from hlod_gaussians_torch.data import ply as ply_io
        from hlod_gaussians_torch.hierarchy import build as hb

        g = ply_io.load_gaussian_ply(args.input)
        # exp and sigmoid in host numpy: the kd split follows the last bit
        # of exp, and torch's differs from numpy's and XLA's
        scales = np.exp(g.log_scale)
        ops = 1.0 / (1.0 + np.exp(-g.opacity))
        shs = np.concatenate([g.f_dc, g.f_rest], axis=1)
        h = hb.build_hierarchy(g.xyz, scales, g.quat, ops, shs,
                               device=device)
        deg = {1: 0, 4: 1, 9: 2, 16: 3}[shs.shape[1]]
        dhier_io.save_dhier(args.output, dhier_io.DHier(
            sh_degree=deg, pos=h.pos, quat=h.quat,
            log_scale=np.log(np.maximum(h.scale, 1e-12)).astype(np.float32),
            opacity=np.clip(h.opacity, 1e-4, 1 - 1e-6).astype(np.float32),
            shs=h.sh.astype(np.float32), nodes=h.nodes))
        n = h.nodes.shape[0]
    # graph dump next to the hierarchy, as the reference creator always
    # does (mainHierarchyCreator.cpp:184)
    d = dhier_io.load_dhier(args.output)
    gdf = os.path.splitext(args.output)[0] + ".gdf"
    dhier_io.save_gdf(gdf, d.nodes)
    print(f"wrote {n} nodes -> {args.output} (+ {os.path.basename(gdf)})")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="hlod_gaussians_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("full-train", help="end-to-end pipeline")
    t.add_argument("--source_path", "-s", required=True)
    t.add_argument("--output", "-o", required=True)
    t.add_argument("--images", default="images")
    t.add_argument("--depths", default="")
    t.add_argument("--alpha_masks", default="")
    t.add_argument("--eval", action="store_true")
    t.add_argument("--resolution", "-r", type=int, default=-1)
    t.add_argument("--white_background", action="store_true")
    t.add_argument("--train_test_exp", action="store_true",
                   help="train exposures on the visible half of test views")
    t.add_argument("--skip_scale_big_gauss", action="store_true")
    t.add_argument("--scaffold_file", default="",
                   help="saved scaffold.npz: skip the coarse stage")
    t.add_argument("--coarse_iters", type=int, default=30_000)
    t.add_argument("--chunk_iters", type=int, default=30_000)
    t.add_argument("--post_iters", type=int, default=15_000)
    t.add_argument("--skybox_num", type=int, default=100_000)
    t.add_argument("--chunk_size", type=float, default=100.0)
    t.add_argument("--backend", default="pallas", choices=["pallas", "xla"],
                   help="pallas: the CUDA blend kernels; xla: plain PyTorch")
    t.add_argument("--max_dup_log2", type=int, default=21)
    t.set_defaults(fn=cmd_full_train)

    e = sub.add_parser("eval", help="granularity sweep on the test split")
    e.add_argument("--hierarchy", required=True)
    e.add_argument("--source_path", "-s", required=True)
    e.add_argument("--images", default="images")
    e.add_argument("--levels", default="0,0.01,0.1")
    e.add_argument("--tau", action="store_true",
                   help="interpret levels as tau pixels")
    e.add_argument("--max_views", type=int, default=50)
    e.add_argument("--backend", default="pallas", choices=["pallas", "xla"],
                   help="pallas: the CUDA blend kernels; xla: plain PyTorch")
    e.add_argument("--lpips_weights", default=None)
    e.add_argument("--antialiasing", action="store_true",
                   help="EWA convolution AA (the alt-rasterizer variant)")
    e.add_argument("--debug", action="store_true",
                   help="print the per-level cut-size curve")
    e.set_defaults(fn=cmd_eval)

    v = sub.add_parser("viewer", help="SIBR-compatible live view server")
    v.add_argument("--hierarchy", required=True)
    v.add_argument("--host", default="127.0.0.1")
    v.add_argument("--port", type=int, default=6009)
    v.add_argument("--backend", default="pallas", choices=["pallas", "xla"],
                   help="pallas: the CUDA blend kernels; xla: plain PyTorch")
    v.add_argument("--occlusion-cull", action="store_true",
                   help="low-res visibility pre-pass culls the cut per "
                        "frame (reference hierarchy_viewer.py:280-282)")
    v.set_defaults(fn=cmd_viewer)

    c = sub.add_parser("create-hierarchy", help="offline hierarchy build")
    c.add_argument("input", help="3DGS .ply")
    c.add_argument("output", help=".dhier path")
    c.add_argument("--native", action="store_true",
                   help="use the C++ creator")
    c.set_defaults(fn=cmd_create_hierarchy)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
