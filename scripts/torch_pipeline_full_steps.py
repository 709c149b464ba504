#!/usr/bin/env python3
"""run_pipeline at the JAX package's pipeline point with its own step
counts, on one GPU: chip_smoke.py phase [14]'s scene and settings (9 shells
of 250,000 points, 512x512, 72 train and 36 ring test views, 16x16 tiles,
max_dup 2^22) at coarse / chunk / post steps 600 / 1500 / 800 with an MCMC
round every 400 (scripts/tpu_pipeline_scale3.py:134-137), where
chip_smoke.py cuts them to 60 / 200 / 100.

    python3 scripts/torch_pipeline_full_steps.py [--out PATH] [--keep DIR]

Prints the run's log as it comes (stage seconds from run_pipeline's
logger), then the merged tree's node count and depth, the leaves' mean
opacity and two tau sweeps (0, 3, 6, 15: PSNR, SSIM, GMSD, mean
rendered), each column beside the JAX run's (PIPELINE_r05.json, copied
into chip_smoke.PIPE_JAX) with an all-black image's PSNR: over the 36
ring test views, and over the 4 orbit views of the whole grid, which no
chunk trained on, with their tau-0 cuts before the budget; then,
for each chunk, its own post-optimized tree (chunk_*/hierarchy.dhier_opt)
and the merged tree at tau 0 over the ring test views of the chunk's
shell, to tell the chunks' training from the merge. Writes them as
JSON to --out (default chiprun_out/pipeline_full.json).

With ``--keep DIR`` the run's output directory is DIR and stays: the chunk
trees (chunk_*/hierarchy.dhier_opt, center.txt), merged.dhier and
views.npz (the ring test views' cameras, ground-truth images and shells),
which is what `scripts/torch_merge_bisect.py DIR` reads.
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
    ap.add_argument("--keep", default=None, metavar="DIR",
                    help="write the run's artifacts to DIR and keep them")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_pipeline_full_steps: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    res = run(torch.device("cuda"), cs.nvidia_smi_line(), keep=args.keep)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1, default=float)
    return 0


def beside_jax(rows, jax_rows):
    """One line a tau of a tau table (dicts of tau, psnr, ssim, gmsd,
    mean_rendered), each column as port / JAX run, with the PSNR
    difference."""
    lines = []
    for r, j in zip(rows, jax_rows, strict=True):
        if j["tau"] != r["tau"]:
            raise ValueError(f"tau {r['tau']} beside the JAX run's {j['tau']}")
        lines.append(
            f"tau {r['tau']:4.1f}: PSNR {r['psnr']:.3f} / {j['psnr']:.3f} "
            f"({r['psnr'] - j['psnr']:+.3f} dB)  SSIM {r['ssim']:.4f} / "
            f"{j['ssim']:.4f}  GMSD {r['gmsd']:.5f} / {j['gmsd']:.5f}  mean "
            f"rendered {r['mean_rendered']:.1f} / {j['mean_rendered']:.1f}")
    return lines


def run(dev, smi, iters=ITERS, keep=None):
    """The run and its tau sweeps on `dev`; returns the results. With
    `keep`, the run writes its artifacts there and leaves them."""
    import torch
    import chip_smoke as cs
    from hlod_gaussians_torch import eval as eval_mod
    from hlod_gaussians_torch.config import RasterizerConfig
    from hlod_gaussians_torch.data import dhier as dhier_io
    from hlod_gaussians_torch.data.scene import SceneInfo
    from hlod_gaussians_torch.models.gaussians import (NODE_CHILD_COUNT,
                                                       NODE_DEPTH)
    from hlod_gaussians_torch.ops.ssim import psnr
    from hlod_gaussians_torch.pipeline import chunking, full_train
    from hlod_gaussians_torch.train.post import create_from_dhier
    from torch_merge_bisect import chunk_shell, cut_sizes, save_views
    P = cs.PIPE
    print(smi, flush=True)
    t0 = time.perf_counter()
    pts, cols, views = cs.pipeline_scene(dev, P["per"])
    n_ring = len(cs.PIPE_CENTERS) * P["ring"]
    train = [v for i, v in enumerate(views[:n_ring]) if i % 3 != 0]
    test = [v for i, v in enumerate(views[:n_ring]) if i % 3 == 0]
    orbit = views[n_ring:]
    scene = SceneInfo(points=pts, colors=cols,
                      train_cameras=[cs.SceneCamera(v) for v in train],
                      test_cameras=[], extent=9.0,
                      center=np.zeros(3, np.float32))
    scene_s = time.perf_counter() - t0
    print(f"scene: {len(pts)} ground-truth points, {len(train)} train, "
          f"{len(test)} ring test and {len(orbit)} orbit views in "
          f"{scene_s:.1f} s", flush=True)
    pcfg, opt, pconf, mcfg, cfg = cs.pipeline_settings(*iters)
    entries, t_run = [], [time.perf_counter()]

    class Echo:
        def log(self, **kv):
            entries.append(kv)
            print(f"  +{time.perf_counter() - t_run[0]:.1f} s "
                  + json.dumps(kv, default=float), flush=True)

    out_dir = None if keep else tempfile.TemporaryDirectory(
        prefix="pipeline_full_")
    out = keep or out_dir.name
    if keep:
        os.makedirs(keep, exist_ok=True)
        save_views(os.path.join(keep, "views.npz"), test,
                   [i // P["ring"] for i in range(n_ring) if i % 3 == 0],
                   cs.PIPE_CENTERS)
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

    def sweep(key, vs):
        """The tau sweep over `vs`, stored under `key` and printed beside
        the JAX run's table of that name; and an all-black image's PSNR."""
        table = eval_mod.eval_views(
            st, vs, [v.image for v in vs], cs.EVAL_TAUS, level_is_tau=True,
            budget=P["eval_budget"], cfg=eval_cfg, k_max=1024,
            warn=lambda w: "LPIPS" in w or warned.append(w))
        res[key] = [dict(tau=r.level, psnr=r.psnr, ssim=r.ssim, gmsd=r.gmsd,
                         mean_rendered=r.mean_rendered) for r in table]
        black = statistics.mean(float(psnr(torch.zeros_like(v.image),
                                           v.image)) for v in vs)
        print(f"  {key} over {len(vs)} views, port / JAX run "
              "(PIPELINE_r05.json):", flush=True)
        for line in beside_jax(res[key], cs.PIPE_JAX[key]):
            print("    " + line, flush=True)
        print(f"    an all-black image: PSNR {black:.3f}", flush=True)
        return black

    res["black_psnr"] = sweep("tau_sweep_ring_heldout", test)
    # the four orbit views of the whole grid, from directions no chunk
    # trained on (tpu_pipeline_scale3.py:96-101), and their tau-0 cuts
    # before the budget, which drops the smallest on-screen nodes
    res["black_psnr_orbit"] = sweep("tau_sweep_global_orbit", orbit)
    res["orbit_cut_tau0"] = cut_sizes(st, orbit, 0.0)
    print(f"  the orbit views' tau-0 cuts before the budget: "
          f"{res['orbit_cut_tau0']}, over {P['eval_budget']}: "
          f"{sum(n > P['eval_budget'] for n in res['orbit_cut_tau0'])} of "
          f"{len(orbit)}; warnings {warned}", flush=True)
    res["warnings"] = warned
    # each chunk's own tree against the merged tree, at tau 0 over the ring
    # test views of the chunk's shell (its leaves' mean lies elsewhere: a
    # chunk tree also holds the scaffold ring around the chunk)
    ring = P["ring"]
    res["per_chunk_tau0"] = []
    for name in sorted(os.listdir(out)):
        path = os.path.join(out, name, "hierarchy.dhier_opt")
        if not name.startswith("chunk_") or not os.path.exists(path):
            continue
        d = dhier_io.load_dhier(path)
        c = chunk_shell(chunking.load_chunk_centers(
            [os.path.join(out, name)])[0], cs.PIPE_CENTERS)
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
    if out_dir is not None:
        out_dir.cleanup()
    res["log"] = entries
    return res


if __name__ == "__main__":
    sys.exit(main())
