"""Coarse scaffold training (port of hlod_gaussians_tpu/train/coarse.py;
reference train_coarse.py:29-175).

A thin specialization of the flat trainer: SH degree 1, positions frozen
(xyz LR = 0), low opacity init, random background per step, no
densification, per-step big-Gaussian shrink. The random background comes
from a caller's `torch.Generator` where the JAX package takes a key."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from hlod_gaussians_torch.config import OptimizationConfig, RasterizerConfig
from hlod_gaussians_torch.models import gaussians as gm
from hlod_gaussians_torch.train import flat


def coarse_opt_config(base: OptimizationConfig = OptimizationConfig()
                      ) -> OptimizationConfig:
    """Coarse hyperparameters (train_coarse.py:33-36,60-62): xyz frozen."""
    return dataclasses.replace(
        base,
        position_lr_init=0.0,
        position_lr_final=0.0,
        densify_until_iter=0,
    )


def init_coarse(points: np.ndarray, colors: np.ndarray, capacity: int,
                scene_radius: float, skybox_num: int = 100_000,
                n_exposures: int = 1,
                device=torch.device("cuda")) -> flat.FlatTrainState:
    """Scaffold init: SH degree 1, opacity logit -3 ~ sigmoid 0.047
    (train_coarse.py / create_from_pcd with scaffold defaults)."""
    state = gm.create_from_points(
        points, colors, capacity=capacity, sh_degree=1,
        n_exposures=n_exposures, scene_radius=scene_radius,
        skybox_num=skybox_num,
        opacity_init=float(torch.sigmoid(torch.tensor(-3.0))),
        device=device)
    return flat.init_flat_train(state)


def coarse_step(ts: flat.FlatTrainState, cam_arrays, gt_image,
                generator: torch.Generator, scene_extent: float, *,
                opt: OptimizationConfig, cfg: RasterizerConfig,
                width: int, height: int, k_max: int = 1024,
                bg: Optional[torch.Tensor] = None,
                ) -> Tuple[flat.FlatTrainState, flat.StepAux]:
    """One coarse step with a random background color drawn from
    `generator` (train_coarse.py:70), or the given [3] ``bg`` (a replayed
    draw; then `generator` is not advanced)."""
    world_view, full_proj, campos, tan_fovx, tan_fovy = cam_arrays
    if bg is None:
        bg = torch.rand((3,), generator=generator, device=generator.device)
    bg = torch.as_tensor(bg, dtype=torch.float32).to(gt_image.device)
    return flat.train_step(
        ts, world_view, full_proj, campos, tan_fovx, tan_fovy, gt_image, bg,
        exposure_idx=0, scene_extent=scene_extent,
        opt=opt, cfg=cfg, width=width, height=height, k_max=k_max,
        sh_degree=1, use_exposure=False, skybox_locked=False,
        scale_big_gauss=True, big_gauss_frac=0.1)
