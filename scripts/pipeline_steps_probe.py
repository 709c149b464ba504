#!/usr/bin/env python3
"""The pipeline cell of chip_smoke.py's phase [14] at several step counts,
on one GPU: the tau sweep of the merged tree over the ring test views at
each, to see how many training steps the tree needs before its leaves
(tau 0) beat its coarser cuts (tau 15) against the ground truth.

    python3 scripts/pipeline_steps_probe.py [--steps CHUNK:POST ...]

The scene, cameras, capacities and configs are phase [14]'s (9 shells of
250,000 points, 512x512, 16x16 tiles, max_dup 2^22). The coarse scaffold
is trained once (PIPE's coarse steps) and shared by every setting through
ModelConfig.scaffold_file; each setting then runs run_pipeline with its
chunk and post steps (an MCMC round at half the post steps, one a chunk).
Prints, for each setting, its seconds, each chunk's mean loss over the
views it trained again (first and last visit), the merged tree's mean
leaf opacity, and the tau table with an all-black image's PSNR beside it.
"""

import argparse
import dataclasses
import os
import statistics
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", nargs="+",
                    default=["100:40", "200:40", "400:40", "200:100"])
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("pipeline_steps_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    import chip_smoke as cs
    from hlod_gaussians_torch import eval as eval_mod
    from hlod_gaussians_torch.config import (ModelConfig, OptimizationConfig,
                                             PostConfig, RasterizerConfig)
    from hlod_gaussians_torch.data.scene import SceneInfo
    from hlod_gaussians_torch.ops.ssim import psnr
    from hlod_gaussians_torch.pipeline import full_train
    from hlod_gaussians_torch.train import flat
    from hlod_gaussians_torch.train.post import create_from_dhier
    P = cs.PIPE
    print(cs.nvidia_smi_line(), flush=True)
    pts, cols, views = cs.pipeline_scene(dev, P["per"])
    n_ring = len(cs.PIPE_CENTERS) * P["ring"]
    train = [v for i, v in enumerate(views[:n_ring]) if i % 3 != 0]
    test = [v for i, v in enumerate(views[:n_ring]) if i % 3 == 0]
    scene = SceneInfo(points=pts, colors=cols,
                      train_cameras=[cs.SceneCamera(v) for v in train],
                      test_cameras=[], extent=9.0,
                      center=np.zeros(3, np.float32))
    opt = OptimizationConfig(iterations=1500, densify_until_iter=0,
                             densify_grad_threshold=1e8)
    pconf = PostConfig(spt_root_volume=1e-3, min_spt_size=64,
                       lambda_opacity=0.0, grow_fraction=0.005,
                       max_sh_degree=1)
    cfg = RasterizerConfig(backend="pallas", tile_w=16, tile_h=16,
                           max_dup=P["max_dup"], tight_binning=True)
    eval_cfg = dataclasses.replace(cfg, max_dup=P["gt_max_dup"])
    black = statistics.mean(float(psnr(torch.zeros_like(v.image), v.image))
                            for v in test)
    root = tempfile.mkdtemp(prefix="steps_probe_")

    def pcfg(chunk, post_iters, coarse):
        return full_train.PipelineConfig(
            coarse_iters=coarse, chunk_iters=chunk, post_iters=post_iters,
            skybox_num=1024, coarse_capacity=P["coarse_capacity"],
            chunk_capacity=P["chunk_capacity"], k_max=1024, mh_walk=True,
            densification_interval=10_000, densify_from_iter=10_000,
            opacity_reset_interval=100_000,
            post_densify_interval=max(1, post_iters // 2), chunk_size=2.9,
            chunk_point_padding=0.15)

    t0 = time.perf_counter()
    scaffold = full_train.train_coarse_scaffold(
        train, pts, cols, scene.extent, P["coarse_iters"],
        P["coarse_capacity"], opt=opt, cfg=cfg,
        pcfg=pcfg(1, 2, P["coarse_iters"]), skybox_num=1024, device=dev)
    from hlod_gaussians_torch.utils import checkpoint
    scaffold_path = os.path.join(root, "scaffold.npz")
    checkpoint.save_flat_state(scaffold_path, scaffold)
    del scaffold
    print(f"scene + scaffold ({P['coarse_iters']} coarse steps): "
          f"{time.perf_counter() - t0:.1f} s; an all-black image scores "
          f"PSNR {black:.3f} on the {len(test)} ring test views", flush=True)

    for spec in args.steps:
        chunk, post_iters = (int(x) for x in spec.split(":"))
        steps = []
        orig = flat.train_step

        def step(*a, **kw):
            ts, aux = orig(*a, **kw)
            steps.append((aux.loss, id(a[6])))
            return ts, aux
        flat.train_step = step
        t0 = time.perf_counter()
        try:
            merged = full_train.run_pipeline(
                scene, view_loader=lambda ci: ci.v,
                output_dir=os.path.join(root, spec.replace(":", "_")),
                pcfg=pcfg(chunk, post_iters, P["coarse_iters"]), opt=opt,
                post=pconf, cfg=cfg,
                mcfg=ModelConfig(sh_degree=1, scaffold_file=scaffold_path),
                device=dev)
        finally:
            flat.train_step = orig
        run_s = time.perf_counter() - t0
        losses = [float(x) for x in torch.stack([s[0] for s in steps])]
        rev = []
        for j in range(9):
            run = list(zip(losses, (s[1] for s in steps)))[
                j * chunk:(j + 1) * chunk]
            first, last = {}, {}
            for k, (_, v) in enumerate(run):
                first.setdefault(v, k)
                last[v] = k
            pairs = [(run[first[v]][0], run[last[v]][0]) for v in first
                     if last[v] > first[v]]
            rev.append(tuple(round(float(x), 5) for x in np.mean(
                pairs, 0)) if pairs else (np.nan, np.nan))
        leaf = merged.nodes[:, 2] == 0
        st = create_from_dhier(
            merged, capacity=1 << int(np.ceil(np.log2(
                merged.pos.shape[0] + 1))), device=dev)
        table = eval_mod.eval_views(
            st, test, [v.image for v in test], cs.EVAL_TAUS,
            level_is_tau=True, budget=P["eval_budget"], cfg=eval_cfg,
            k_max=1024, warn=lambda *a, **k: None)
        print(f"chunk {chunk} / post {post_iters} steps (a round at "
              f"{max(1, post_iters // 2)}): run_pipeline {run_s:.1f} s, "
              f"{merged.nodes.shape[0]} nodes; mean leaf opacity "
              f"{float(merged.opacity[leaf].mean()):.4f}; revisit losses "
              f"(first, last) {rev}", flush=True)
        for r in table:
            print(f"  tau {r.level:4.1f}: PSNR {r.psnr:.3f}  SSIM "
                  f"{r.ssim:.4f}  mean rendered {r.mean_rendered:.1f}",
                  flush=True)
        del st, merged
    return 0


if __name__ == "__main__":
    sys.exit(main())
