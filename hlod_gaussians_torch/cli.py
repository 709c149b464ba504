"""Command-line entry points (port of hlod_gaussians_tpu/cli.py).

The reference exposes its pipeline as a family of argparse scripts
(scripts/full_train.py, train_*.py, ...). Here one `python -m
hlod_gaussians_torch.cli <command>` front end drives the same stages
through the library API, on the card. Ported so far: `full-train`, with
the JAX package's flags and defaults; `--backend pallas` selects the CUDA
blend kernels, `xla` the plain PyTorch path.

    python -m hlod_gaussians_torch.cli full-train -s <colmap dir> -o <out>
"""

from __future__ import annotations

import argparse
import os


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
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
