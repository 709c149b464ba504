"""End-to-end pipeline (port of hlod_gaussians_tpu/pipeline/full_train.py;
reference scripts/full_train.py:45-263 + train_post.py).

Ported so far: `PipelineConfig`, `_exposure_bucket` and the post-
optimization loop `post_optimize` (full_train.py:33-54, 124-133, 167-241).
The other stages (coarse scaffold, chunk training, hierarchy conversion,
`run_pipeline`) are not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from hlod_gaussians_torch.config import (OptimizationConfig, PostConfig,
                                         RasterizerConfig)
from hlod_gaussians_torch.data.dhier import DHier
from hlod_gaussians_torch.hierarchy import spt as spt_mod
from hlod_gaussians_torch.models import reorder
from hlod_gaussians_torch.train import post as post_mod
from hlod_gaussians_torch.utils import scheduler


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Stage iteration counts + capacities (reference defaults:
    scripts/full_train.py:141-143, README.md:490-512). Copied field for
    field; post_optimize reads post_densify_interval, k_max, mh_walk and
    seed, and the coarse, chunk, skybox and densification fields wait for
    the stages not ported yet."""

    coarse_iters: int = 30_000
    chunk_iters: int = 30_000
    post_iters: int = 15_000
    skybox_num: int = 100_000
    coarse_capacity: int = 1 << 20
    chunk_capacity: int = 1 << 21
    densification_interval: int = 300
    post_densify_interval: int = -1     # <=0: use PostConfig.densify_interval
    opacity_reset_interval: int = 3_000
    densify_from_iter: int = 500
    chunk_size: float = 100.0
    # chunk point window = chunk box padded by this fraction of chunk_size
    # (make_chunk.py's padded point boxes)
    chunk_point_padding: float = 2.0
    k_max: int = 1024
    mh_walk: bool = True            # cache-coherent view schedule
    seed: int = 0


def _cam_arrays(cam):
    return (cam.world_view, cam.full_proj, cam.campos, cam.tan_fovx,
            cam.tan_fovy)


def _exposure_bucket(n: int) -> int:
    """Exposure-table capacity bucket (power of two, floor 8), as the JAX
    package sizes it; rows past the real view count are never indexed."""
    b = 8
    while b < n:
        b <<= 1
    return b


def post_optimize(
    d: DHier,
    views: Sequence,
    scene_extent: float,
    n_iters: int,
    capacity: int,
    *,
    opt: OptimizationConfig = OptimizationConfig(),
    post: PostConfig = PostConfig(),
    cfg: RasterizerConfig = RasterizerConfig(),
    pcfg: PipelineConfig = PipelineConfig(),
    skybox_num: int = 0,
    logger=None,
    log_every: int = 50,
    device=torch.device("cuda"),
) -> post_mod.PostTrainState:
    """The train_post.py loop: per view an SPT cut, optionally the occlusion
    cull, a post step, and every densify interval an MCMC round followed by
    an SPT rebuild. `views` are Cameras with `image` on `device`.

    ``logger`` (MetricsLogger-like: ``log(**kv)``) receives each round's
    counts with its densify and rebuild seconds (host clock; the round ends
    in a sync), and every ``log_every``-th step's loss, rendered and cut
    rows and whether its render truncated (a sync; after the step's round
    where one ran). The MCMC host draws come from a generator seeded with
    pcfg.seed."""
    state = post_mod.create_from_dhier(
        d, capacity, skybox_num=skybox_num, scene_radius=scene_extent,
        n_exposures=_exposure_bucket(len(views)), device=device)
    ts = post_mod.init_post_train(state)
    forest = post_mod.rebuild_spt(state, post=post)

    centers = np.stack([v.campos.cpu().numpy() for v in views])
    order = scheduler.view_schedule(centers, len(views), n_iters,
                                    seed=pcfg.seed + 1, walk=pcfg.mh_walk)
    w, h = views[0].width, views[0].height
    gen = torch.Generator(device=device).manual_seed(pcfg.seed)
    bg = torch.zeros(3, device=device)
    densify_every = (pcfg.post_densify_interval
                     if pcfg.post_densify_interval > 0
                     else post.densify_interval)
    # the fork trains post at SH degree Max_SH_Degree=1
    # (train_post.py:109,151): higher bands keep their built values
    sh_degree = min(d.sh_degree, post.max_sh_degree)

    for it in range(n_iters):
        v = views[int(order[it])]
        # over-budget fallback (train_post.py:324-430) on the device: no
        # device->host sync on the cut size per view
        cut = spt_mod.spt_cut_budgeted(
            forest, capacity, v.campos, v.full_proj,
            post.max_gaussian_budget,
            grow=post.distance_multiplier_until_budget,
            use_frustum=post.use_frustum_culling)
        ws_mask = cut.gaussian_mask
        if post.use_occlusion_culling:
            # drop working-set rows invisible in a low-res pre-render
            # (train_post.py:344-351 culls the coarse cut the same way)
            ws_mask = reorder.occlusion_cull(ts.gaussians, ws_mask,
                                             *_cam_arrays(v))
        ts, aux = post_mod.post_train_step(
            ts, ws_mask, *_cam_arrays(v), v.image, bg, scene_extent,
            opt=opt, post=post, cfg=cfg, width=w, height=h,
            k_max=pcfg.k_max, sh_degree=sh_degree)
        if it > 0 and it % densify_every == 0:
            extra_dead = None
            if post.use_mip_respawn:
                # relocate SPT entries no training camera can ever select
                # (train_post.py:752-761)
                extra_dead = spt_mod.mip_respawn_mask(
                    forest, capacity,
                    torch.as_tensor(centers.astype(np.float32),
                                    device=device))
            t0 = time.perf_counter()
            ts, stats = post_mod.densify_round(ts, gen, post=post,
                                               extra_dead=extra_dead)
            stats = {k: int(s) for k, s in stats.items()}
            t1 = time.perf_counter()
            forest = post_mod.rebuild_spt(ts.gaussians, post=post)
            if logger:
                logger.log(stage="post_densify", it=it, **stats,
                           densify_s=t1 - t0,
                           rebuild_s=time.perf_counter() - t1)
        if logger and it % log_every == 0:
            logger.log(stage="post", it=it, loss=float(aux.loss),
                       n_rendered=int(aux.n_rendered),
                       n_cut=int(cut.n_selected),
                       truncated=bool(aux.truncated))
    return ts
