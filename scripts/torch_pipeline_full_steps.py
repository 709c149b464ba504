#!/usr/bin/env python3
"""run_pipeline at the JAX package's pipeline point with its own step
counts, on one GPU: chip_smoke.py phase [14]'s scene and settings (9 shells
of 250,000 points, 512x512, 72 train and 36 ring test views, 16x16 tiles,
max_dup 2^22) at coarse / chunk / post steps 600 / 1500 / 800 with an MCMC
round every 400 (scripts/tpu_pipeline_scale3.py:134-137), where
chip_smoke.py cuts them to 60 / 200 / 100.

    python3 scripts/torch_pipeline_full_steps.py [--out PATH]

Prints the run's log as it comes (stage seconds from run_pipeline's
logger), then the merged tree's node count and depth, the leaves' mean
opacity and the tau sweep (0, 3, 6, 15: PSNR, SSIM, GMSD, mean rendered)
over the ring test views with an all-black image's PSNR beside it; then,
for each chunk, its own post-optimized tree (chunk_*/hierarchy.dhier_opt)
and the merged tree at tau 0 over the ring test views of the shell the
chunk holds, to tell the chunks' training from the merge. Writes them as
JSON to --out (default chiprun_out/pipeline_full.json).
"""

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ITERS = (600, 1500, 800, 400)       # coarse, chunk, post, post densify


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "pipeline_full.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_pipeline_full_steps: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    res = run(torch.device("cuda"), cs.nvidia_smi_line())
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1, default=float)
    return 0


def run(dev, smi, iters=ITERS):
    """The run and its tau sweep on `dev`; returns the results."""
    import torch
    import chip_smoke as cs
    from hlod_gaussians_torch import eval as eval_mod
    from hlod_gaussians_torch.config import RasterizerConfig
    from hlod_gaussians_torch.data import dhier as dhier_io
    from hlod_gaussians_torch.data.scene import SceneInfo
    from hlod_gaussians_torch.models.gaussians import (NODE_CHILD_COUNT,
                                                       NODE_DEPTH)
    from hlod_gaussians_torch.ops.ssim import psnr
    from hlod_gaussians_torch.pipeline import full_train
    from hlod_gaussians_torch.train.post import create_from_dhier
    P = cs.PIPE
    print(smi, flush=True)
    t0 = time.perf_counter()
    pts, cols, views = cs.pipeline_scene(dev, P["per"])
    n_ring = len(cs.PIPE_CENTERS) * P["ring"]
    train = [v for i, v in enumerate(views[:n_ring]) if i % 3 != 0]
    test = [v for i, v in enumerate(views[:n_ring]) if i % 3 == 0]
    scene = SceneInfo(points=pts, colors=cols,
                      train_cameras=[cs.SceneCamera(v) for v in train],
                      test_cameras=[], extent=9.0,
                      center=np.zeros(3, np.float32))
    scene_s = time.perf_counter() - t0
    print(f"scene: {len(pts)} ground-truth points, {len(train)} train and "
          f"{len(test)} ring test views in {scene_s:.1f} s", flush=True)
    pcfg, opt, pconf, mcfg, cfg = cs.pipeline_settings(*iters)
    entries, t_run = [], [time.perf_counter()]

    class Echo:
        def log(self, **kv):
            entries.append(kv)
            print(f"  +{time.perf_counter() - t_run[0]:.1f} s "
                  + json.dumps(kv, default=float), flush=True)

    out_dir = tempfile.TemporaryDirectory(prefix="pipeline_full_")
    out = out_dir.name
    t_run[0] = time.perf_counter()
    merged = full_train.run_pipeline(
        scene, view_loader=lambda ci: ci.v, output_dir=out, pcfg=pcfg,
        opt=opt, post=pconf, cfg=cfg, mcfg=mcfg, logger=Echo(), device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run[0]
    leaf = merged.nodes[:, NODE_CHILD_COUNT] == 0
    res = dict(device=smi, iters=iters, seconds=run_s, scene_seconds=scene_s,
               nodes=int(merged.nodes.shape[0]),
               depth=int(merged.nodes[:, NODE_DEPTH].max()),
               leaf_mean_opacity=float(merged.opacity[leaf].mean()),
               jax_run=dict(nodes=cs.PIPE_JAX["nodes"],
                            depth=cs.PIPE_JAX["depth"]))
    print(f"run_pipeline {run_s:.1f} s; merged {res['nodes']} nodes, depth "
          f"{res['depth']} (the JAX run: {cs.PIPE_JAX['nodes']} nodes, depth "
          f"{cs.PIPE_JAX['depth']}, PIPELINE_r05.json); leaves' mean opacity "
          f"{res['leaf_mean_opacity']:.4f} [{smi}]", flush=True)

    cap = 1 << int(np.ceil(np.log2(merged.pos.shape[0] + 1)))
    st = create_from_dhier(merged, capacity=cap, device=dev)
    eval_cfg = RasterizerConfig(backend="pallas", tile_w=16, tile_h=16,
                                max_dup=P["gt_max_dup"], tight_binning=True)
    warned = []
    table = eval_mod.eval_views(
        st, test, [v.image for v in test], cs.EVAL_TAUS, level_is_tau=True,
        budget=P["eval_budget"], cfg=eval_cfg, k_max=1024,
        warn=warned.append)
    black = statistics.mean(float(psnr(torch.zeros_like(v.image), v.image))
                            for v in test)
    res["tau_sweep_ring_heldout"] = [
        dict(tau=r.level, psnr=r.psnr, ssim=r.ssim, gmsd=r.gmsd,
             mean_rendered=r.mean_rendered) for r in table]
    res["black_psnr"], res["warnings"] = black, warned
    for r in table:
        print(f"  tau {r.level:4.1f}: PSNR {r.psnr:.3f}  SSIM {r.ssim:.4f}  "
              f"GMSD {r.gmsd:.5f}  mean rendered {r.mean_rendered:.1f}",
              flush=True)
    print(f"  an all-black image: PSNR {black:.3f}; warnings {warned}",
          flush=True)
    # each chunk's own tree against the merged tree, at tau 0 over the ring
    # test views of the shell nearest the chunk tree's leaves
    ring = P["ring"]
    res["per_chunk_tau0"] = []
    for name in sorted(os.listdir(out)):
        path = os.path.join(out, name, "hierarchy.dhier_opt")
        if not name.startswith("chunk_") or not os.path.exists(path):
            continue
        d = dhier_io.load_dhier(path)
        leaves = d.pos[d.nodes[:, NODE_CHILD_COUNT] == 0]
        c = int(np.argmin(np.linalg.norm(
            cs.PIPE_CENTERS - leaves.mean(axis=0), axis=1)))
        vs = [views[i] for i in range(c * ring, (c + 1) * ring) if i % 3 == 0]
        gts = [v.image for v in vs]
        cst = create_from_dhier(
            d, capacity=1 << int(np.ceil(np.log2(d.pos.shape[0] + 1))),
            device=dev)
        own = eval_mod.eval_views(cst, vs, gts, [0.0], level_is_tau=True,
                                  budget=P["eval_budget"], cfg=eval_cfg,
                                  k_max=1024, warn=lambda *a: None)[0]
        mrg = eval_mod.eval_views(st, vs, gts, [0.0], level_is_tau=True,
                                  budget=P["eval_budget"], cfg=eval_cfg,
                                  k_max=1024, warn=lambda *a: None)[0]
        row = dict(chunk=name, center=c, nodes=int(d.nodes.shape[0]),
                   leaf_mean_opacity=float(d.opacity[
                       d.nodes[:, NODE_CHILD_COUNT] == 0].mean()),
                   psnr_chunk_tree=own.psnr, psnr_merged=mrg.psnr)
        res["per_chunk_tau0"].append(row)
        print(f"  {name} (shell {c}, {row['nodes']} nodes, leaves' mean "
              f"opacity {row['leaf_mean_opacity']:.4f}): tau-0 PSNR "
              f"{own.psnr:.3f} for its own tree, {mrg.psnr:.3f} for the "
              "merged tree", flush=True)
        del cst
    out_dir.cleanup()
    res["log"] = entries
    return res


if __name__ == "__main__":
    sys.exit(main())
