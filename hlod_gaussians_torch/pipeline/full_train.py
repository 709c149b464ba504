"""End-to-end pipeline: coarse scaffold -> per-chunk training -> hierarchy
build -> post-optimization -> consolidation (port of
hlod_gaussians_tpu/pipeline/full_train.py; reference
scripts/full_train.py:45-263 + train_no_chunks.py:98-265).

One program, no subprocesses or filesystem barriers: each stage is a
Python call around the training steps, on the card unless the caller passes
another device. `run_pipeline` strings the stages together over a chunked
scene and merges the chunk hierarchies into one `.dhier`;
`run_pipeline_no_chunks` builds one hierarchy over the scaffold. In a
`torch.distributed` world of several processes `run_pipeline` trains one
block of chunks a process and process 0 merges them from the shared output
directory, as the JAX package's multi-process branch does.
"""

from __future__ import annotations

import dataclasses
import os
import time
import traceback
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from hlod_gaussians_torch.config import (ModelConfig, OptimizationConfig,
                                         PostConfig, RasterizerConfig)
from hlod_gaussians_torch.data import dhier as dhier_io
from hlod_gaussians_torch.data.dhier import DHier
from hlod_gaussians_torch.data.scene import SceneInfo, load_view
from hlod_gaussians_torch.hierarchy import build as hb
from hlod_gaussians_torch.hierarchy import filter as flt
from hlod_gaussians_torch.hierarchy import spt as spt_mod
from hlod_gaussians_torch.models import gaussians as gm
from hlod_gaussians_torch.models import reorder
from hlod_gaussians_torch.parallel import distributed as pdist
from hlod_gaussians_torch.pipeline import chunking, merge
from hlod_gaussians_torch.train import coarse as coarse_mod
from hlod_gaussians_torch.train import flat
from hlod_gaussians_torch.train import post as post_mod
from hlod_gaussians_torch.utils import checkpoint as ckpt
from hlod_gaussians_torch.utils import scheduler
from hlod_gaussians_torch.utils.metrics import counters, span


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Stage iteration counts + capacities (reference defaults:
    scripts/full_train.py:141-143, README.md:490-512), copied field for
    field from the JAX package."""

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


def train_flat_scene(
    views: Sequence,                  # Cameras with .image on the device
    points: np.ndarray, colors: np.ndarray,
    scene_extent: float,
    n_iters: int,
    capacity: int,
    *,
    opt: OptimizationConfig = OptimizationConfig(),
    cfg: RasterizerConfig = RasterizerConfig(),
    pcfg: PipelineConfig = PipelineConfig(),
    skybox_num: int = 0,
    sh_degree: int = 3,
    scale_big_gauss: bool = True,
    logger=None,
    stage: str = "chunk",
    initial_state: Optional[gm.GaussianState] = None,
    bg=None,
    device=torch.device("cuda"),
) -> flat.FlatTrainState:
    """The train_single.py loop: step + densify/reset on schedule, and
    every 50th step's loss, L1 and live rows to ``logger`` (a sync).

    ``initial_state`` lets the caller pass a scaffold-conditioned chunk
    state (gm.create_with_scaffold); otherwise a fresh point-cloud init on
    ``device``."""
    state = initial_state if initial_state is not None else \
        gm.create_from_points(
            points, colors, capacity=capacity, sh_degree=sh_degree,
            n_exposures=_exposure_bucket(len(views)),
            scene_radius=scene_extent,
            skybox_num=skybox_num, device=device)
    skybox_num = state.n_skybox
    ts = flat.init_flat_train(state)

    centers = np.stack([v.campos.cpu().numpy() for v in views])
    order = scheduler.view_schedule(centers, len(views), n_iters,
                                    seed=pcfg.seed, walk=pcfg.mh_walk)
    w, h = views[0].width, views[0].height

    bg = torch.zeros(3, device=state.xyz.device) if bg is None else bg
    for it in range(n_iters):
        v = views[int(order[it])]
        ts, aux = flat.train_step(
            ts, *_cam_arrays(v), v.image, bg,
            alpha_mask=v.alpha_mask,
            mono_invdepth=None if v.invdepth is None else v.invdepth[0],
            depth_mask=None if v.depth_mask is None else v.depth_mask[0],
            exposure_idx=v.exposure_idx, scene_extent=scene_extent,
            opt=opt, cfg=cfg, width=w, height=h, k_max=pcfg.k_max,
            sh_degree=sh_degree, use_exposure=True,
            skybox_locked=skybox_num > 0, scale_big_gauss=scale_big_gauss)
        if (pcfg.densify_from_iter < it < opt.densify_until_iter
                and it % pcfg.densification_interval == 0):
            ts, _ = flat.densify_step(ts, scene_extent, opt=opt)
        if it > 0 and it % pcfg.opacity_reset_interval == 0 \
                and it < opt.densify_until_iter:
            ts = flat.reset_opacity(ts)
        if logger and it % 50 == 0:
            logger.log(stage=stage, it=it, loss=float(aux.loss),
                       l1=float(aux.l1),
                       n_alive=int(torch.sum(ts.gaussians.alive)))
    return ts


def state_to_hierarchy(ts: flat.FlatTrainState) -> DHier:
    """Trained flat state -> merge hierarchy (.dhier), skipping skybox rows
    (the GaussianHierarchyCreator stage, mainHierarchyCreator.cpp:41-184).
    The rows are filtered and the tree built on the state's device."""
    g = ts.gaussians
    dev = g.xyz.device
    keep = g.alive & (torch.arange(g.capacity, device=dev) >= g.n_skybox)
    act = gm.activate(g)
    means, scales, quats, ops, shs = (
        a[keep] for a in (act.means3d, act.scales, act.quats,
                          act.opacities, act.shs))

    # input filtering (mainHierarchyCreator.cpp:87-152): drop NaN/Inf/huge
    finite = (torch.isfinite(means).all(1) & torch.isfinite(scales).all(1)
              & torch.isfinite(quats).all(1) & (ops > 0.0)
              & (scales.amax(1) < 10.0))
    h = hb.build_hierarchy(means[finite], scales[finite], quats[finite],
                           ops[finite], shs[finite], device=dev)
    sh_degree = {1: 0, 4: 1, 9: 2, 16: 3}[shs.shape[1]]
    return DHier(
        sh_degree=sh_degree, pos=h.pos, quat=h.quat,
        log_scale=np.log(np.maximum(h.scale, 1e-12)).astype(np.float32),
        opacity=np.clip(h.opacity, 1e-4, 1.0 - 1e-6).astype(np.float32),
        shs=h.sh.astype(np.float32), nodes=h.nodes)


class PostStep(NamedTuple):
    """One post_iteration's feedback. The first four stay on the device
    until `read_post_step` brings them over in one copy: the step's loss,
    whether its render truncated, the SPT cut's working-set rows and the
    rows it rendered. ``mask`` ([C] bool, on the device) is the working
    set the step trained. ``rows_projected`` (a host int) is the rows the
    step's per-row work covered: the capacity, since activation, the
    projection and Adam run over every row under a mask. ``round`` holds
    the MCMC round's counts and its densify and rebuild seconds (host
    clock) when one ran after the step, else None."""
    loss: torch.Tensor
    truncated: torch.Tensor
    n_cut: torch.Tensor
    n_rendered: torch.Tensor
    mask: torch.Tensor
    rows_projected: int
    round: Optional[dict] = None


def post_iteration(
    ts: post_mod.PostTrainState,
    forest: spt_mod.SPTForest,
    it: int,
    view,
    bg: torch.Tensor,
    scene_extent: float,
    *,
    opt: OptimizationConfig = OptimizationConfig(),
    post: PostConfig = PostConfig(),
    cfg: RasterizerConfig = RasterizerConfig(),
    k_max: int = 1024,
    sh_degree: int = 1,
    densify_every: int = 5000,
    generator: Optional[torch.Generator] = None,
    centers: Optional[np.ndarray] = None,
):
    """One view of the train_post.py loop, inside the `hlod.post_step`
    span: the SPT cut under the post budget (and the occlusion cull when
    on) in `hlod.spt_cut`, a post step on `view` (a Camera with its
    `image`), and, when step `it` is due (it > 0, it % densify_every ==
    0), an MCMC round and the SPT rebuild. ``centers`` ([V, 3] camera
    positions) feed the MIP respawn when post.use_mip_respawn is on; the
    round's host draws come from ``generator``.

    Returns (state, forest, PostStep); the forest is the rebuilt one after
    a round. Without a round the step reads nothing back to the host."""
    with span("hlod.post_step"):
        with span("hlod.spt_cut"):
            # over-budget fallback (train_post.py:324-430) on the device:
            # no device->host sync on the cut size per view
            cut = spt_mod.spt_cut_budgeted(
                forest, ts.gaussians.capacity, view.campos, view.full_proj,
                post.max_gaussian_budget,
                grow=post.distance_multiplier_until_budget,
                use_frustum=post.use_frustum_culling)
            ws_mask = cut.gaussian_mask
            if post.use_occlusion_culling:
                # drop working-set rows invisible in a low-res pre-render
                # (train_post.py:344-351 culls the coarse cut the same way)
                ws_mask = reorder.occlusion_cull(ts.gaussians, ws_mask,
                                                 *_cam_arrays(view))
        ts, aux = post_mod.post_train_step(
            ts, ws_mask, *_cam_arrays(view), view.image, bg, scene_extent,
            opt=opt, post=post, cfg=cfg, width=view.width,
            height=view.height, k_max=k_max, sh_degree=sh_degree)
        rows = ts.gaussians.capacity
        mcmc_round = None
        if it > 0 and it % densify_every == 0:
            extra_dead = None
            if post.use_mip_respawn:
                # relocate SPT entries no training camera can ever select
                # (train_post.py:752-761)
                extra_dead = spt_mod.mip_respawn_mask(
                    forest, ts.gaussians.capacity,
                    torch.as_tensor(centers.astype(np.float32),
                                    device=ts.gaussians.xyz.device))
            t0 = time.perf_counter()
            ts, stats = post_mod.densify_round(ts, generator, post=post,
                                               extra_dead=extra_dead)
            stats = {k: int(s) for k, s in stats.items()}
            t1 = time.perf_counter()
            forest = post_mod.rebuild_spt(ts.gaussians, post=post)
            mcmc_round = dict(stats, densify_s=t1 - t0,
                              rebuild_s=time.perf_counter() - t1)
        fb = PostStep(loss=aux.loss, truncated=aux.truncated,
                      n_cut=cut.n_selected, n_rendered=aux.n_rendered,
                      mask=ws_mask, rows_projected=rows, round=mcmc_round)
    return ts, forest, fb


def read_post_step(fb: PostStep) -> dict:
    """A post step's feedback on the host, in one device-to-host copy:
    {loss, n_rendered, n_cut, truncated}, as a training log reads it. Adds
    the step's working-set rows to `metrics.counters["post.ws_rows"]` and
    the rows its per-row work covered to `"post.rows_projected"`: the
    counters add up the steps that are read, and no other (post_optimize
    reads every `log_every`-th)."""
    loss, truncated, n_cut, n_rendered = torch.stack([
        fb.loss.double(), fb.truncated.double(), fb.n_cut.double(),
        fb.n_rendered.double()]).tolist()
    counters["post.ws_rows"] += int(n_cut)
    counters["post.rows_projected"] += fb.rows_projected
    return dict(loss=loss, n_rendered=int(n_rendered), n_cut=int(n_cut),
                truncated=bool(truncated))


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
    """The train_post.py loop: `post_iteration` for each view of the
    schedule (an SPT cut, optionally the occlusion cull, a post step, and
    every densify interval an MCMC round followed by an SPT rebuild).
    `views` are Cameras with `image` on `device`.

    ``logger`` (MetricsLogger-like: ``log(**kv)``) receives each round's
    counts with its densify and rebuild seconds (host clock; the round ends
    in a sync), and every ``log_every``-th step's loss, rendered and cut
    rows and whether its render truncated (`read_post_step`: one copy;
    after the step's round where one ran). The MCMC host draws come from a
    generator seeded with pcfg.seed."""
    state = post_mod.create_from_dhier(
        d, capacity, skybox_num=skybox_num, scene_radius=scene_extent,
        n_exposures=_exposure_bucket(len(views)), device=device)
    ts = post_mod.init_post_train(state)
    forest = post_mod.rebuild_spt(state, post=post)

    centers = np.stack([v.campos.cpu().numpy() for v in views])
    order = scheduler.view_schedule(centers, len(views), n_iters,
                                    seed=pcfg.seed + 1, walk=pcfg.mh_walk)
    gen = torch.Generator(device=device).manual_seed(pcfg.seed)
    bg = torch.zeros(3, device=device)
    densify_every = (pcfg.post_densify_interval
                     if pcfg.post_densify_interval > 0
                     else post.densify_interval)
    # the fork trains post at SH degree Max_SH_Degree=1
    # (train_post.py:109,151): higher bands keep their built values
    sh_degree = min(d.sh_degree, post.max_sh_degree)

    for it in range(n_iters):
        ts, forest, fb = post_iteration(
            ts, forest, it, views[int(order[it])], bg, scene_extent,
            opt=opt, post=post, cfg=cfg, k_max=pcfg.k_max,
            sh_degree=sh_degree, densify_every=densify_every,
            generator=gen, centers=centers)
        if logger and fb.round is not None:
            logger.log(stage="post_densify", it=it, **fb.round)
        if logger and it % log_every == 0:
            logger.log(stage="post", it=it, **read_post_step(fb))
    return ts


def train_coarse_scaffold(
    views: Sequence,
    points: np.ndarray, colors: np.ndarray,
    scene_extent: float,
    n_iters: int,
    capacity: int,
    *,
    opt: OptimizationConfig = OptimizationConfig(),
    cfg: RasterizerConfig = RasterizerConfig(),
    pcfg: Optional[PipelineConfig] = None,
    skybox_num: int = 100_000,
    logger=None,
    bgs: Optional[Sequence] = None,
    device=torch.device("cuda"),
) -> flat.FlatTrainState:
    """Faithful coarse stage (train_coarse.py:29-175): SH degree 1, xyz
    frozen, opacity logit -3, random background per step, no exposure, no
    densification, 0.1*extent big-Gaussian shrink.

    The backgrounds come from a generator on ``device`` seeded with
    pcfg.seed + 7, or from ``bgs`` (one [3] per step, e.g. another run's
    draws replayed)."""
    pcfg = pcfg or PipelineConfig()
    coarse_opt = coarse_mod.coarse_opt_config(opt)
    ts = coarse_mod.init_coarse(points, colors, capacity, scene_extent,
                                skybox_num=skybox_num,
                                n_exposures=_exposure_bucket(len(views)),
                                device=device)
    centers = np.stack([v.campos.cpu().numpy() for v in views])
    order = scheduler.view_schedule(centers, len(views), n_iters,
                                    seed=pcfg.seed, walk=pcfg.mh_walk)
    w, h = views[0].width, views[0].height
    gen = torch.Generator(device=device).manual_seed(pcfg.seed + 7)
    for it in range(n_iters):
        v = views[int(order[it])]
        ts, aux = coarse_mod.coarse_step(
            ts, _cam_arrays(v), v.image, gen, scene_extent,
            opt=coarse_opt, cfg=cfg, width=w, height=h, k_max=pcfg.k_max,
            bg=None if bgs is None else bgs[it])
        if logger and it % 50 == 0:
            logger.log(stage="coarse", it=it, loss=float(aux.loss),
                       l1=float(aux.l1))
    return ts


def resolution_args(mcfg) -> tuple:
    """(resolution_scale, max_width) for load_view from ModelConfig.resolution
    (reference utils/camera_utils.py:19-54): -1 = native capped at 1600 px;
    1/2/4/8 = explicit downscale factor, no cap."""
    if mcfg.resolution in (1, 2, 4, 8):
        return float(mcfg.resolution), 0
    return 1.0, 1600


def _sync(device) -> float:
    """Host clock after the device's queued work has finished."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def run_pipeline(
    scene: SceneInfo,
    view_loader: Callable[[object], object] = None,
    output_dir: str = "",
    *,
    pcfg: PipelineConfig = PipelineConfig(),
    opt: OptimizationConfig = OptimizationConfig(),
    post: PostConfig = PostConfig(),
    cfg: RasterizerConfig = RasterizerConfig(),
    mcfg: Optional[ModelConfig] = None,
    logger=None,
    skip_if_exists: bool = False,
    keep_running: bool = False,
    device=torch.device("cuda"),
) -> DHier:
    """Full pipeline on a loaded scene. Returns the merged hierarchy.

    view_loader maps a CameraInfo to a Camera with its tensors on
    ``device`` (defaults to data.scene.load_view at ModelConfig.resolution).

    ``skip_if_exists`` resumes a partially-completed run from output_dir
    artifacts (the reference's --skip_if_exists, scripts/full_train.py:58,82,
    158); ``keep_running`` continues past failed chunks (--keep_running,
    scripts/full_train.py:59). ``mcfg`` supplies the reference ModelParams
    knobs: resolution, white_background, skip_scale_big_gauss, sh_degree,
    scaffold_file (resume the coarse stage from a saved scaffold), cap_max
    (overrides PostConfig.max_cap when > 0).

    With a ``logger``, the scaffold stage (with its scaffold.npz write),
    each chunk and the merge also log their seconds (host clock after a
    device sync), and each chunk its trained rows, tree nodes and post
    capacity. Each chunk's training and
    post states are freed before the next chunk; only the scaffold lives
    across chunks.

    In a torch.distributed world of several processes (the reference's
    SLURM job array, scripts/full_train.py:161-236, over a shared
    filesystem) every rank trains the scaffold (same seed, same result) and
    rank 0 alone writes scaffold.npz before the ranks meet; each rank then
    trains its block of chunks (`distributed.process_chunk_assignment`) into
    the shared ``output_dir``; after a barrier rank 0 loads every chunk's
    hierarchy.dhier_opt in chunk order and merges, and the other ranks
    return None. Each stage seeds its own draws (pcfg.seed, pcfg.seed + 1),
    so a chunk's result does not depend on the rank that trains it."""
    n_ranks = pdist.world_size()
    if n_ranks > 1 and not output_dir:
        raise ValueError("a multi-process pipeline needs a shared output_dir")
    mcfg = mcfg or ModelConfig()
    if mcfg.cap_max > 0:
        post = dataclasses.replace(post, max_cap=mcfg.cap_max)
    bg = (torch.ones(3, device=device) if mcfg.white_background
          else torch.zeros(3, device=device))

    if view_loader is None:
        # one exposure slot per image (reference assigns exposures per
        # image; a constant exposure_idx=0 would collapse them all into
        # one shared matrix)
        scale, max_w = resolution_args(mcfg)
        views_all = [load_view(ci, resolution_scale=scale, max_width=max_w,
                               exposure_idx=i,
                               train_test_exp=mcfg.train_test_exp,
                               device=device)
                     for i, ci in enumerate(scene.train_cameras)]
    else:
        views_all = [view_loader(ci) for ci in scene.train_cameras]
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)

    # 1) coarse scaffold over every view (random bg, frozen xyz, skybox);
    # a pre-trained scaffold_file (reference --scaffold_file) skips it
    clock = _Clock(device, on=logger is not None)
    coarse_path = os.path.join(output_dir, "scaffold.npz") if output_dir else ""
    resume = skip_if_exists and coarse_path and os.path.exists(coarse_path)
    pdist.barrier()              # every rank looked before rank 0 writes
    if mcfg.scaffold_file:
        ts_coarse = ckpt.load_flat_state(mcfg.scaffold_file, device=device)
        source = "scaffold_file"
    elif resume:
        ts_coarse = ckpt.load_flat_state(coarse_path, device=device)
        source = "resumed"
    else:
        ts_coarse = train_coarse_scaffold(
            views_all, scene.points, scene.colors, scene.extent,
            pcfg.coarse_iters, pcfg.coarse_capacity, opt=opt, cfg=cfg,
            pcfg=pcfg, skybox_num=pcfg.skybox_num, logger=logger,
            device=device)
        if coarse_path:
            clock.mark()
            # one writer: the JAX package lets every process write the same
            # path at once
            if pdist.rank() == 0:
                ckpt.save_flat_state(coarse_path, ts_coarse)
            clock.mark()
        source = "trained"
    pdist.barrier()
    if logger:
        clock.mark()
        m = clock.marks
        logger.log(stage="scaffold", source=source, seconds=m[-1] - m[0],
                   save_s=m[2] - m[1] if len(m) == 4 else 0.0)

    # 2) chunks (falls back to one whole-scene "chunk")
    chunks = chunking.make_chunks(scene, chunk_size=pcfg.chunk_size,
                                  point_padding=pcfg.chunk_point_padding,
                                  min_n_cams=1, min_points=1)
    if not chunks:
        chunks = [chunking.Chunk(index=(0, 0),
                                 center=np.zeros(3, np.float32),
                                 extent=np.full(3, pcfg.chunk_size, np.float32),
                                 cameras=list(scene.train_cameras),
                                 point_mask=np.ones(len(scene.points), bool))]

    mine = set(range(len(chunks)))
    if n_ranks > 1:
        mine = set(pdist.process_chunk_assignment(len(chunks)))

    info_to_idx = {id(ci): i for i, ci in enumerate(scene.train_cameras)}
    chunk_dhiers: List[DHier] = []
    centers = []
    for chunk_i, chunk in enumerate(chunks):
        if chunk_i not in mine:
            continue
        cd = os.path.join(output_dir,
                          f"chunk_{chunk.index[0]}_{chunk.index[1]}") \
            if output_dir else ""
        hier_path = os.path.join(cd, "hierarchy.dhier_opt") if cd else ""
        if skip_if_exists and hier_path and os.path.exists(hier_path):
            chunk_dhiers.append(dhier_io.load_dhier(hier_path))
            centers.append(chunk.center)
            continue
        try:
            # chunk-LOCAL exposure slots: the chunk state sizes its exposure
            # table to len(cams), so the views' global exposure indices must
            # be remapped or distinct images silently alias one slot
            cams = [dataclasses.replace(views_all[info_to_idx[id(ci)]],
                                        exposure_idx=j)
                    for j, ci in enumerate(chunk.cameras)]
            clock = _Clock(device, on=logger is not None)
            dd, stats = _train_chunk(chunk, cams, scene, ts_coarse, clock,
                                     pcfg=pcfg, opt=opt, post=post, cfg=cfg,
                                     mcfg=mcfg, bg=bg, logger=logger,
                                     device=device)
            # merged even if writing its artifacts fails, as in the JAX
            # package
            chunk_dhiers.append(dd)
            centers.append(chunk.center)
            if cd:
                _write_chunk(cd, chunk, dd, cams, post, clock, device)
            if logger:
                logger.log(stage=f"chunk{chunk.index}", **stats,
                           **clock.seconds(("train_s", "build_s", "post_s",
                                            "save_s", "anchors_s")))
        except Exception as e:
            if not keep_running:
                raise
            traceback.print_exc()
            if logger:
                logger.log(stage=f"chunk{chunk.index}", error=1,
                           message=f"{type(e).__name__}: {e}")
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()

    if n_ranks > 1:
        pdist.barrier()                                  # "chunks_done"
        if pdist.rank() != 0:
            return None
        # consolidate from the shared filesystem: every rank's chunks
        chunk_dhiers, centers = [], []
        for chunk in chunks:
            hp = os.path.join(output_dir,
                              f"chunk_{chunk.index[0]}_{chunk.index[1]}",
                              "hierarchy.dhier_opt")
            if os.path.exists(hp):
                chunk_dhiers.append(dhier_io.load_dhier(hp))
                centers.append(chunk.center)

    if not chunk_dhiers:
        raise RuntimeError(
            "no chunk hierarchies to merge — every chunk failed or no "
            "hierarchy.dhier_opt artifacts exist (see the per-chunk error "
            "log entries above)")
    t0 = time.perf_counter()
    merged = merge.merge_hierarchies(chunk_dhiers, np.stack(centers))
    if output_dir:
        dhier_io.save_dhier(os.path.join(output_dir, "merged.dhier"), merged)
    if logger:
        logger.log(stage="merge", n_chunks=len(chunk_dhiers),
                   n_nodes=int(merged.nodes.shape[0]),
                   seconds=time.perf_counter() - t0)
    return merged


class _Clock:
    """Stage marks on the host clock after a device sync, taken only when
    ``on`` (a logger reads them): otherwise no sync is added."""

    def __init__(self, device, on: bool):
        self.device, self.on, self.marks = device, on, []
        self.mark()

    def mark(self) -> None:
        if self.on:
            self.marks.append(_sync(self.device))

    def seconds(self, names) -> dict:
        return {k: b - a for k, a, b in zip(names, self.marks,
                                            self.marks[1:])}


def _train_chunk(chunk, cams, scene, ts_coarse, clock, *, pcfg, opt, post,
                 cfg, mcfg, bg, logger, device):
    """One chunk of `run_pipeline`: scaffold-conditioned training, the
    hierarchy and post-optimization. Returns the post-optimized hierarchy
    and the chunk's trained rows, tree nodes and post capacity; its states
    are dropped on return."""
    pts = scene.points[chunk.point_mask]
    cols = scene.colors[chunk.point_mask]
    # scaffold conditioning (gaussian_model.py:866-919): ring-select
    # the trained scaffold around this chunk and prepend it
    init_state = gm.create_with_scaffold(
        ts_coarse.gaussians, chunk.center, float(chunk.extent[0]),
        pts, cols, pcfg.chunk_capacity, sh_degree=mcfg.sh_degree,
        n_exposures=_exposure_bucket(len(cams)),
        # dense synthetic scaffolds can put more ring rows around a
        # chunk than its whole capacity; cap with headroom for the
        # chunk's own points (+pad), evenly subsampled
        max_scaffold_rows=max(0, pcfg.chunk_capacity - len(pts) - 4096),
        device=device)
    ts_chunk = train_flat_scene(
        cams, pts, cols, scene.extent, pcfg.chunk_iters,
        pcfg.chunk_capacity, opt=opt, cfg=cfg, pcfg=pcfg,
        sh_degree=mcfg.sh_degree, logger=logger,
        stage=f"chunk{chunk.index}", initial_state=init_state,
        scale_big_gauss=not mcfg.skip_scale_big_gauss, bg=bg, device=device)
    del init_state
    clock.mark()
    n_rows = int(torch.sum(ts_chunk.gaussians.alive))
    d = state_to_hierarchy(ts_chunk)
    del ts_chunk
    clock.mark()
    # the merge hierarchy has ~2n-1 nodes for n trained leaves, so a chunk
    # trained past half capacity would not fit the chunk capacity — size
    # the post stage to the actual tree
    post_cap = max(pcfg.chunk_capacity,
                   1 << int(np.ceil(np.log2(d.pos.shape[0] + 1))))
    ts_post = post_optimize(
        d, cams, scene.extent, pcfg.post_iters, post_cap,
        opt=opt, post=post, cfg=cfg, pcfg=pcfg, logger=logger, device=device)
    dd = post_mod.state_to_dhier(ts_post.gaussians)
    del ts_post
    clock.mark()
    return dd, dict(n_rows=n_rows, n_nodes=int(d.pos.shape[0]),
                    post_capacity=post_cap)


def _write_chunk(cd, chunk, dd, cams, post, clock, device) -> None:
    """A chunk's artifacts in `cd`: center.txt, extent.txt,
    hierarchy.dhier_opt and anchors.bin."""
    chunking.save_chunk_meta(cd, chunk)
    dhier_io.save_dhier(os.path.join(cd, "hierarchy.dhier_opt"), dd)
    clock.mark()
    # anchors.bin next to the hierarchy (the merger chunk path's
    # AppearanceFilter, mainHierarchyMerger.cpp:79-80)
    vps = np.stack([v.campos.cpu().numpy() for v in cams[:64]])
    anchors = flt.compute_anchors(
        dd.nodes, dd.pos, np.exp(dd.log_scale).max(1),
        np.ones(dd.nodes.shape[0], bool), vps, post.spt_target_granularity,
        device=device)
    flt.write_anchors(os.path.join(cd, "anchors.bin"), anchors)
    clock.mark()


def run_pipeline_no_chunks(
    scene: SceneInfo,
    view_loader: Callable[[object], object] = None,
    output_dir: str = "",
    *,
    pcfg: PipelineConfig = PipelineConfig(),
    opt: OptimizationConfig = OptimizationConfig(),
    post: PostConfig = PostConfig(),
    cfg: RasterizerConfig = RasterizerConfig(),
    mcfg: Optional[ModelConfig] = None,
    logger=None,
    device=torch.device("cuda"),
) -> DHier:
    """Single-scene variant without chunking (reference train_no_chunks.py:
    98-265): coarse scaffold over every view -> hierarchy built directly on
    the scaffold -> in-process post-optimization. No merge step (one root).
    ``mcfg.pretrained`` (a 3DGS .ply) replaces the coarse training stage
    with the saved point cloud (reference --pretrained,
    scene/__init__.py:82-83)."""
    mcfg = mcfg or ModelConfig()
    if view_loader is None:
        def view_loader(ci):
            return load_view(ci, device=device)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
    views_all = [view_loader(ci) for ci in scene.train_cameras]

    if mcfg.pretrained:
        from hlod_gaussians_torch.data import ply as ply_io
        g = gm.create_from_gaussian_ply(
            ply_io.load_gaussian_ply(mcfg.pretrained), pcfg.coarse_capacity,
            n_exposures=_exposure_bucket(len(views_all)), device=device)
        ts_coarse = flat.init_flat_train(g)
    else:
        ts_coarse = train_coarse_scaffold(
            views_all, scene.points, scene.colors, scene.extent,
            pcfg.coarse_iters, pcfg.coarse_capacity, opt=opt, cfg=cfg,
            pcfg=pcfg, skybox_num=pcfg.skybox_num, logger=logger,
            device=device)

    d = state_to_hierarchy(ts_coarse)
    del ts_coarse
    ts_post = post_optimize(
        d, views_all, scene.extent, pcfg.post_iters, pcfg.chunk_capacity,
        opt=opt, post=post, cfg=cfg, pcfg=pcfg,
        skybox_num=pcfg.skybox_num, logger=logger, device=device)
    out = post_mod.state_to_dhier(ts_post.gaussians)
    if output_dir:
        dhier_io.save_dhier(os.path.join(output_dir, "hierarchy.dhier_opt"),
                            out)
    return out
