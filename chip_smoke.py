#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (hlod_gaussians_torch) on one NVIDIA
GPU: builds the blend kernels, holds each to its plain PyTorch version,
serves flat and hierarchical-LOD renders, takes flat training steps, and
builds, streams, evaluates and maintains a full-size LOD tree,
post-optimizes a 4M-node tree on the card and out of core from a pinned
host store, runs the pipeline, scales out over torch.distributed worlds,
serves the live viewer, runs the eval and create-hierarchy CLIs, LPIPS,
the debug renders and the native loader through the public entry points,
runs the benchmark bench_torch.py, and prints the kernel table.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases (any failure raises and exits non-zero):
  1. card name and power limit; build both kernels with nvcc, one process
     per source, started together (build seconds; ptxas registers and
     spills of every kernel specialisation).
  2. kernel B1 (blend forward) vs its plain version on small scenes (LOD
     on/off, seen, 16x16, 32x32, 16x8, 8x128, 8x4, 8x8, 8x24, 12x8 and
     10x6 tiles, i.e. 4, 2 and 1 pixels a thread and a 60-pixel tile whose
     last warp is partial; sticky early stops past several 32-entry
     batches, at 4 and 1 pixels a thread; dense overlap with saturated
     pixels; 250x190 frames whose last tile row and column lie partly
     outside the image): images, inverse depth and final T to atol 2e-5,
     n_contrib and seen exact; then one 1080p bench frame: image to atol
     1e-4, share of pixels whose n_contrib differs <= 1e-4, and a second
     launch bitwise equal to the first.
  2b. kernel B2 (blend backward) vs its plain version on the same small
     scenes and the 1080p bench frame, on B1's final T and n_contrib and
     seeded random cotangents: per-entry gradients to atol 3e-4 times the
     largest plain magnitude; two launches bitwise equal (B2 takes tiles of
     a multiple of 32 pixels, so not the 10x6 ones). The tiles reach
     each of B2's launch shapes (4, 2 and 1 pixels a thread, one warp and
     several), the sticky cases walk 600 entries (19 batches, the entry
     ring wraps) and the ragged frames have partial tiles.
  3. flat serving: 8 requests through render.render_arrays at 1920x1080 on
     the 100k-Gaussian SH-3 bench scene (scripts/bench_scene.py), 32x32
     tiles, tight binning, max_dup 352*1024; every request untruncated and
     finite, one B1 launch each; per-frame median and the stage split.
  4. LOD serving: the oracle hierarchy (tests/fixtures/oracle/
     hierarchy.dhier.gz) with a 100k-point skybox, render.render_lod at
     1080p for tau 0, 3 and 15; one view against the plain (xla) path.
  5. training: one train.flat.train_step on a small scene on the card
     against the same step on the CPU (plain versions); then 8 steps at
     full width (the bench scene perturbed, fit toward its own 1080p
     render, SH 3, the serving config): every step untruncated with a
     finite loss and exactly one B1 and one B2 launch, the last loss below
     the first, exactly one train_preprocess forward and backward launch a
     step; step median and the forward / backward / Adam split.
  6. full-size hierarchical LOD: hierarchy.build.build_hierarchy on the
     card over the JAX package's LOD bench leaves (2^19 points, bench.py
     :168-176, SH widened to degree 3): the 1,048,575-node tree passes
     sanity_check_hierarchy and round-trips through a .dhier file into a
     state (build and file seconds); parent cache and interp table.
  7. viewer stream: render.render_lod_stream at 1920x1080 over the 26
     yawing bench cameras at tau 0 and 15, 6 warm-up and 20 timed frames
     each: frame median (CUDA events) and host wall, the path, budget, md
     and truncated frames of the regulation, exactly one B1 launch a frame.
  8. the kernel path against the plain (xla) path at the stream's last
     camera: render_lod at tau 15 (the settled stream's budget) and
     render_lod_masked at tau 3 (n_selected equal, image to 1e-4).
  9. eval.eval_views: the tau sweep (0, 3, 6, 15) on the box metric over 4
     cameras, against the leaves' flat render: PSNR at tau 0 >= at tau 15,
     mean_rendered never rising and lower at tau 15 than at tau 0, no
     truncated or capped view.
  10. viewer maintenance at tau 3: 30 frames of incremental_cut_step (the
     camera walks in for 10, then stands), each a proper cut rendered with
     render_lod(cut_mask) and fed to ActiveRowCache (fetched and evicted
     rows a frame); the still frames outnumber the tree's height and end at
     the size rule's cut read from the root down.
  11. kernel B1 at the tau-0 stream frame: against its plain version, the
     bare launch and the wrapper timed, the bound from the frame's
     evaluated, candidate and applied pairs with the LOD alpha's operations.
  11b. kernel lod_preprocess at the tau-0 serving cell's size (8,388,607
     heap-ordered rows at SH 3, 4,179,253 leaves drawn, drawn from a seed
     on the card) against its plain version on the card: valid and radius
     equal but for boundary rows (at most 1e-5 of the drawn), feature rows
     to 2e-5; the kernel's time over 20 back-to-back launches, the plain
     chain's, the byte bound. Phases 5 and 7-10 count its launches by path
     (one a masked stream or auto frame, none on train_step and the
     budgeted render_lod).
  11c. kernel sparse_adam at the train and post cells' states (2,959,677
     rows, all in the mask; 4,194,304 rows, 42 % in it; 59 floats a row
     and the exposure table) against the plain chain on the card, p, m
     and v bit for bit; the kernel's time over 20 back-to-back launches,
     the chain's and its kernel count (the profiler), the byte bound (28
     bytes a float of a row in the mask, 24 outside it). Phases 5 and 12 time both at their own steps; the kernel table counts
     its launches by path.
  11d. kernels train_preprocess_forward and train_preprocess_backward at
     the train and post cells' states (2,959,677 rows at SH 3, all in the
     mask, the screen-space offset; 4,194,304 rows at SH 1 of SH 3 stored,
     42 % in it), drawn from a seed on the card, against the plain chain
     and its autograd gradient on the card: valid and radius equal but for
     boundary rows, feature rows to 2e-5, each leaf's gradient within 1e-4
     of the larger of its norm and the median leaf's; each kernel's time
     over 20 back-to-back launches beside its byte bound, the plain chain's
     forward and backward and its device kernel count (the profiler).
     Phase 5 holds every step to one launch of each; the kernel table counts
     the forward's launches by path.
  12. hierarchy post-optimization at the JAX package's post bench point
     (scripts/offload_bench3.py): build_hierarchy on the card over 2^21
     leaves (4,194,303 nodes, SH 1), the SPT forest, a 40-view 1080p orbit
     whose targets are the unperturbed tree rendered at each view's SPT
     cut; the tree perturbed (f_dc + 0.3, 3 x 4,096 leaves dead);
     pipeline.full_train.post_optimize for 40 steps with an MCMC round
     every 10 (three rounds, each relocating rows, the tree proper after
     each): every step untruncated and finite with one B1 and one B2
     launch, camera 0's L1 falling; step median (CUDA events), host wall,
     the cut / render + loss / backward / Adam split, densify_round and
     rebuild_spt seconds; B1 (1e-4, n_contrib exact) and B2 (3e-4 scaled)
     against their plain versions at a post frame, bare launch, wrapper and
     bound; then 4 steps with the occlusion cull (two B1 launches a step)
     on the state exported to a .dhier and resumed.
  13. out-of-core post-optimization at the JAX package's operating point
     (scripts/offload_bench3.py): first train.offload.DeviceResidentTrainer
     on a 48-point scene (budget 64), prefetch bitwise equal to no
     prefetch and the sequential packed step matched; then the post bench
     tree rebuilt (151 SPTs), packed into a 50,000,000-row pinned host
     store (13.8 GB; the rows past the tree copies of its rows; allocation
     and fill seconds, MemTotal); the orbit written as a COLMAP model by
     data.colmap and read back through data.scene.load_colmap_scene (its
     matrices within 1e-5 of make_camera's); CachedCutter's working sets
     (1,701,479 / 2,062,953 / 1,864,463 rows min / max / mean, the budget
     2,166,272, every cut within it); the trainer's first step, 8
     resident steps and three orbit laps with the next view prefetched,
     each untruncated and finite with one B1 and one B2 launch: step
     times (CUDA events and wall), vs_resident, host prepare and apply
     ms, fetched rows a steady step (511 / 49,152 / 14,105 at p50 / p90 /
     mean), peak host RSS and device memory; after flush every row no
     working set named, the ballast included, bitwise unchanged; B1 and B2
     against their plain versions at an offload frame with bare launch,
     wrapper and bound; then post_optimize_offloaded for 10 iterations
     over the loaded views.
  14. the pipeline at the JAX package's pipeline point
     (scripts/tpu_pipeline_scale3.py): 9 shells of 250,000 points,
     ground truth rendered at 512x512, 72 train and 36 ring test views;
     pipeline.full_train.run_pipeline with coarse / chunk / post steps 60 /
     200 / 100 and one MCMC round a chunk (PIPE): 9 chunks; one B1 and one
     B2 launch a step, none truncated, every loss finite; the scaffold's
     ring-test PSNR above its initial state's; every chunk's loss falling
     on the views it trained again; the device memory in use as each chunk
     starts not growing by a chunk state; every artifact written, anchors
     inside their trees, the merged tree proper; a resume that touches no
     artifact and writes a byte-equal merge; B1 and B2 against their plain
     versions at a chunk-training frame; the tau sweep on the merged tree
     over the ring test views (mean_rendered falling, PSNR at tau 0 at
     least at tau 15) and over the JAX run's 4 orbit views, which no chunk
     trained on (mean_rendered falling, tau-0 PSNR PIPE_ORBIT_DB above an
     all-black image's), one B1 launch a render; the ground truth's kNN
     scale init under PIPE_KNN_MAX. 14b: the
     full-train CLI in a subprocess on a small COLMAP scene.
  15. data-parallel: an NCCL world of one process on the card;
     parallel.data_parallel.dp_train_step at 1920x1080 on the bench scene,
     B = 4 views a step, 8 steps (losses falling, 4 B1 + 4 B2 launches a
     step, step median); 4 identical views against one train_step (loss
     rtol 1e-5, xyz atol 1e-5); the pallas backend against the xla one at
     480x270 on every 10th Gaussian (the train step's tolerance; the plain
     path's autograd at 1080p would keep tens of GB); then, in a Gloo
     world of two processes on the card, one view a rank against the
     one-rank two-view step (within 1e-5).
  16. tile-parallel: B1 at each band of the 1080p bench frame split in two
     (render_arrays' band=: band-local bins, max_dup / 2) against its
     plain version, its launch and bound beside the whole frame's, the
     band imbalance; in
     the Gloo world render_tile_parallel against render_arrays and
     render_lod_tile_parallel of the 1,048,575-node tree at tau 3 against
     render_lod_masked, whose lod_preprocess kernel each rank launches
     once (n_selected equal, 1e-4, untruncated).
  17. chunk-parallel: two chunk states of 2^19 rows (250,000 points each)
     at 512x512 step through chunk_parallel_step, each held to its own
     train_step (bitwise, as two runs of one train_step are); in the Gloo
     world K = 4 over two ranks and chunk_parallel_densify.
  18. the multi-process pipeline: run_pipeline at PIPE_MP's cut of phase
     [14]'s point (4 chunks, 20 / 30 / 10 steps) twice in this process
     and, at the same time on the same card, over the Gloo ranks into one
     shared directory, all in PyTorch's default (non-deterministic) mode:
     the three merged.dhier files byte-equal, rank 1 returns None, each
     rank trains exactly its block.
  19. the viewer: cli.make_viewer on the phase-[6] tree saved as a .dhier;
     a client thread sends 30 SIBR requests at 1920x1080 along
     lod_bench_camera's poses and a keepalive: every reply's bytes and
     status, frame 1 equal to an in-process render_lod at the same cut,
     bucket and sampling, B1 at the first and the last served frame (the
     1920x1440 bucket, 16x16 tiles, the LOD alpha) against its plain
     version with the last one's launch and bound, p50 / p90 latency on
     the client's clock; then
     `python -m hlod_gaussians_torch.cli viewer` in a subprocess serves 3
     requests and exits on SIGINT.
  20. the periphery on the phase-[6] tree: `cli.main(["create-hierarchy",
     ...])` on the card and with --native from its 2^19 leaves written as
     a PLY (both 1,048,575 nodes, proper, a .gdf each, the roots within
     tests/test_native.py's bounds, the leaves equal as sets); a COLMAP
     scene of 16 lod_bench_camera poses at 1920x1080 (4 test views,
     loaded at 1600x900) whose images are the leaves' render; `eval --tau
     --debug --lpips_weights` (seeded VGG16 weights) in process on the
     .dhier and on the tree as an upstream .hier at tau 0 (capped by the
     default 2^18 budget, the JAX package's warning) and the two smallest
     of EVAL_CLI's taus the budget holds (the CLI's fixed max_dup of 2^19
     entries truncates every level of this tree; the warning counts it):
     finite PSNR / SSIM / GMSD / LPIPS, mean_rendered not rising, one B1
     launch a level and view, the same node counts on both routes; the
     entries the eval frame needs; the CLI in a subprocess at one
     level; the debug renders at 1080p (the depth-0 slice equal to the
     leaves' flat render, level slices falling from 524,288, one B1 launch
     a render, gaussians_per_limit not rising); LPIPS on the card within
     1e-4 of the CPU on a 256x256 crop and its 1080p time; the native
     image loader against PIL; B1 at an eval frame against its plain
     version, its launch and bound.
  21. the bench: `python3 bench_torch.py` (the twin of bench.py) in a
     subprocess with the kernels phase [1] built, under a deadline: exit 0,
     its last line bench.py's six keys with no null, B1 and B2 launched.
  22. the {"kernels": [...]} line, then the device line.

Without a CUDA device it exits 1 before printing any result.
"""

import dataclasses
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SMALL_ATOL = 2e-5
FRAME_ATOL = 1e-4
FRAME_NC_SHARE = 1e-4
# H100 SXM published peaks (NVIDIA data sheet): HBM3 and f32 outside the
# tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# f32 operations of the kernel's loop (csrc/blend_forward.cu): per evaluated
# (entry, pixel) pair dx, dy, power (7), the power test, exp, op*G, min, the
# alpha_min test, 1-alpha, T*(1-alpha) and the t_eps test; per applied pair
# also w and four FMAs (the bench frame has no LOD)
OPS_EVAL, OPS_APPLY = 18, 9
# kernel B2 (csrc/blend_backward.cu): per needed (entry, pixel) pair, i.e.
# every entry before the pixel's n_contrib, the n_contrib test, dx, dy,
# power (7), the power test, exp, op*G, min and the alpha_min test; per
# applied pair 1-alpha, the T division, contrib, cdotg (4), dL/dalpha (4),
# the suffix update, the clip test, dpower, u, v, the three second moments
# and the four colour products (the warp reductions are not counted)
B2_OPS_NEED, B2_OPS_APPLY = 14, 24
# with LOD, per candidate pair (power <= 0 and above the kernel's exp-free
# reject, log(alpha_min / opacity) - 0.05) also 1-alpha, the max, log,
# (1/kids)*log, exp, t*alpha, 1-t, 1-pw, their product and the sum: ten more,
# two of them transcendental
OPS_LOD = 10
B1_BATCH = 32        # entries per shared-memory batch of kernel B1
# kernel lod_preprocess (csrc/lod_preprocess.cu) at the tau-0 serving cell's
# size (benchmark/configs/lod-8M-sh3.json): 2^22 leaves in 8,388,607
# heap-ordered nodes at SH 3, 4,179,253 leaves drawn (the cell's mean). f32
# operations a drawn row: the lerp (3 x 59), the quaternion's two
# normalisations and cov3d (about 80), the projection with the EWA
# covariance, conic, radius and extents (about 200), SH 3 (direction and
# basis about 55, the sums 2 x 48)
LODPRE_LEAVES, LODPRE_DRAWN = 1 << 22, 4_179_253
OPS_LODPRE = 177 + 80 + 200 + 55 + 96
# kernel sparse_adam (csrc/sparse_adam.cu) at the training cells' states
# (benchmark/configs/): rows and the share of them in the step's mask, the
# train cell's every row and the post cell's working set (ws_useful.post);
# 59 floats a row at SH 3. A masked float reads p, g, m, v and writes p, m,
# v (28 bytes), an unmasked one skips g (24); a row adds its mask byte.
# f32 operations an updated float: the moments (6), the bias corrections,
# lr, sqrt, eps, the quotient and the difference (7)
ADAM_CELLS = {"train": (2_959_677, 1.0), "post": (4_194_304, 0.42)}
ADAM_ROW_FLOATS = 59
OPS_ADAM = 13
# kernels train_preprocess_forward / _backward (csrc/train_preprocess.cu)
# at the training cells' states (benchmark/configs/): rows, the share in the
# step's mask, the step's SH degree and whether the screen-space offset is
# given; f_rest stores 15 coefficients in both. f32 operations a row in the
# mask at SH 3: the activations and cov3d (about 100), the projection
# (about 200), SH 3 (about 150), the feature row; the backward recomputes
# them and runs their reverse (about 1,000 more)
TRAINPRE_CELLS = {"train": (2_959_677, 1.0, 3, True),
                  "post": (4_194_304, 0.42, 1, False)}
OPS_TRAINPRE = (600, 1600)
GRAD_SCALED_ATOL = 3e-4
TRAIN_STEPS = 8
# the JAX package's LOD bench tree (bench.py:145-253): 2^19 leaves, a
# 1,048,575-node tree, 26 yawing 1080p cameras, 6 warm-up and 20 timed
# stream frames a granularity
LOD_LEAVES = 1 << 19
STREAM_TAUS = (0.0, 15.0)
STREAM_WARM, STREAM_TIMED = 6, 20
EVAL_TAUS = (0.0, 3.0, 6.0, 15.0)
MAINT_FRAMES, MAINT_MOVING = 30, 10
# the JAX package's post-optimization operating point
# (scripts/offload_bench3.py:47-119): 2^21 leaves, a 4,194,303-node tree, a
# 40-view 1080p orbit; 40 post steps with an MCMC round every 10, then 4
# with the occlusion cull; 3 x 4,096 leaves start dead, a full relocation
# budget a round
POST_LEAVES = 1 << 21
POST_VIEWS, POST_ITERS, POST_DENSIFY, POST_OCC_ITERS = 40, 40, 10, 4
POST_DEAD = 3 * 4096
POST_FREE_ROWS = 1 << 16       # densify_round adds <= 2 x 4,096 rows a round
ORBIT_FOV = (1.2, 0.8)
# the JAX package's out-of-core operating point (scripts/offload_bench3.py
# :85-245): the post bench tree packed into a 50M-row host store (the rows
# past the tree copies of its rows), cut with CachedCutter at distance
# multiplier 1.0 over the orbit, a budget of 1.05 x the largest working
# set; the first step, 8 on view 0, then three laps of the orbit with the
# next view prefetched. OFFLOAD_r05.json's structural counts at this point:
# working sets min / max / mean, the budget, and the fetched rows of the
# steady laps' steps at p50 / p90 / mean
OFFLOAD_STORE_ROWS = 50_000_000
OFFLOAD_RESIDENT, OFFLOAD_LAPS, OFFLOAD_LOOP_ITERS = 8, 3, 10
OFFLOAD_WS = (1_701_479, 2_062_953, 1_864_463)
OFFLOAD_BUDGET = 2_166_272
OFFLOAD_CHURN = (511, 49_152, 14_105)
OFFLOAD_SPTS = 151
# the JAX package's pipeline operating point (scripts/tpu_pipeline_scale3.py
# :53-137, PIPELINE_r05.json): 9 shells of 250,000 points on a 3x3 grid,
# 512x512 views (72 train, 36 ring test, 4 orbit), coarse capacity 2^22,
# chunk capacity 2^19, 16x16 tiles with max_dup 2^22 (2^23 for the ground
# truth and the eval). Only the step counts are cut: 600 / 1500 / 800 ->
# 60 / 200 / 100, a round every 400 -> 50, one MCMC round a chunk as
# there; scripts/torch_pipeline_full_steps.py runs the JAX run's counts
PIPE = dict(per=250_000, ring=12, width=512, coarse_capacity=1 << 22,
            chunk_capacity=1 << 19, max_dup=1 << 22, gt_max_dup=1 << 23,
            coarse_iters=60, chunk_iters=200, post_iters=100, post_densify=50,
            eval_budget=1 << 20)
PIPE_CENTERS = np.array([[x, y, 5.0] for y in (-3.0, 0.0, 3.0)
                         for x in (-3.0, 0.0, 3.0)], np.float32)
# the JAX run's structural counts and its two tau tables (tau, PSNR, SSIM,
# GMSD, mean rendered), copied from PIPELINE_r05.json: over the 36 ring
# test views, and over the 4 orbit views that no chunk trained on
PIPE_JAX = dict(
    nodes=4_480_899, depth=22, iters=(600, 1500, 800, 400),
    tau_sweep_ring_heldout=[
        dict(tau=0.0, psnr=40.861, ssim=0.9927, gmsd=0.02819,
             mean_rendered=959929.4),
        dict(tau=3.0, psnr=27.107, ssim=0.9343, gmsd=0.11577,
             mean_rendered=7209.4),
        dict(tau=6.0, psnr=22.574, ssim=0.8884, gmsd=0.18404,
             mean_rendered=2120.4),
        dict(tau=15.0, psnr=16.684, ssim=0.7057, gmsd=0.23087,
             mean_rendered=620.1)],
    tau_sweep_global_orbit=[
        dict(tau=0.0, psnr=34.448, ssim=0.9861, gmsd=0.02792,
             mean_rendered=350092.5),
        dict(tau=3.0, psnr=19.684, ssim=0.7668, gmsd=0.25497,
             mean_rendered=2711.0),
        dict(tau=6.0, psnr=15.686, ssim=0.6175, gmsd=0.33166,
             mean_rendered=1027.8),
        dict(tau=15.0, psnr=10.064, ssim=0.1381, gmsd=0.26702,
             mean_rendered=504.0)])
# phase [14]'s check on its own inputs: the kNN scale init of the
# ground-truth points stays under PIPE_KNN_MAX world units (their median is
# 0.0074; a kNN that wraps each axis maximum to the far end of its Morton
# curves starts those points at 1.4-6.3, Gaussians that cover the frame)
PIPE_KNN_MAX = 0.1
# [14]'s orbit views at tau 0 score at least this many dB above black
PIPE_ORBIT_DB = 5.0
CLI_VIEWS, CLI_W, CLI_H = 8, 128, 96


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_lines(build_log):
    """(kernel specialisation, registers or spills line) pairs from nvcc's
    -Xptxas -v output, e.g. ("blend_backward_kernel<0, 4>", "Used 80
    registers, ...") for the flat kernel at 4 pixels a thread."""
    kernel_name = "?"
    for line in build_log.splitlines():
        m = re.search(r"((?:blend|train_preprocess)_(?:forward|backward)"
                      r"_kernel)I(\w*?)EEv", line)
        if m:
            args = re.findall(r"L[bi](\d+)E", m.group(2) + "E")
            kernel_name = f"{m.group(1)}<{', '.join(args)}>"
        elif "sparse_adam_kernel" in line:
            kernel_name = "sparse_adam_kernel"
        elif "registers" in line or "spill" in line:
            yield kernel_name, line.replace("ptxas info    :", "").strip()


def cuda_time_ms(fn, reps, warmup=1):
    """Median of `reps` CUDA-event timings of fn() on the current stream."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def load_bench_scene():
    spec = importlib.util.spec_from_file_location(
        "bench_scene", os.path.join(ROOT, "scripts", "bench_scene.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # float32, as jnp.asarray makes them in bench.py (its log_scale comes
    # out of numpy as float64)
    return {k: v.astype(np.float32)
            for k, v in mod.make_bench_scene().items()}


def small_scene(dev, n, seed, width, height, big=False, lod=False,
                stacked=False):
    """Projected Gaussians for a kernel-vs-plain case (the shapes of the
    JAX package's blend tests, scaled up)."""
    import torch
    from hlod_gaussians_torch.ops import gaussian_math
    from hlod_gaussians_torch.utils.camera import make_camera

    rng = np.random.default_rng(seed)
    if stacked:
        xyz = np.zeros((n, 3), np.float32)
        xyz[:, :2] = rng.uniform(-0.02, 0.02, (n, 2))
        xyz[:, 2] = np.linspace(3.0, 5.0, n)
        scales = np.full((n, 3), 0.08, np.float32)
        quats = np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))
        ops = np.full((n,), 0.035, np.float32)
    else:
        xyz = rng.normal(size=(n, 3)).astype(np.float32) * 1.2
        xyz[:, 2] = 4.0 + rng.uniform(-1, 1, n)
        scales = np.exp(rng.normal(size=(n, 3)) * 0.4
                        - (1.5 if big else 2.5)).astype(np.float32)
        quats = rng.normal(size=(n, 4)).astype(np.float32)
        ops = rng.uniform(0.2, 0.95, n).astype(np.float32)
    cam = make_camera(np.eye(3), np.zeros(3), 0.9, 0.7, width, height,
                      device=dev)
    t = lambda a: torch.as_tensor(a, device=dev)
    p = gaussian_math.project_gaussians(
        t(xyz), gaussian_math.compute_cov3d(t(scales), t(quats)), t(ops),
        cam.world_view, cam.full_proj, width, height, cam.focal_x,
        cam.focal_y, cam.tan_fovx, cam.tan_fovy)
    color = t(rng.uniform(0, 1, (n, 3)).astype(np.float32))
    ts = t(rng.uniform(0, 1, n).astype(np.float32)) if lod else None
    kids = t(rng.integers(0, 4, n).astype(np.int32)) if lod else None
    return p, color, ts, kids


def blend_inputs(p, color, ts, kids, width, height, tile_w, tile_h, max_dup,
                 tight):
    from hlod_gaussians_torch.ops.binning import bin_gaussians
    from hlod_gaussians_torch.ops.rasterize_xla import blend_features
    import torch
    bins = bin_gaussians(p.xy, p.depth, p.radius, p.valid, width, height,
                         tile_w, tile_h, max_dup,
                         ext=p.ext if tight else None,
                         reff2=p.reff2 if tight else None)
    feats = blend_features(p.xy, p.conic, p.opacity, color,
                           1.0 / torch.clamp_min(p.depth, 1e-6), ts, kids)
    return bins, feats


def compare(name, got, ref, atol, nc_share=0.0):
    """Kernel outputs vs plain outputs; returns the max abs error."""
    import torch
    img_err = float((got[0] - ref[0]).abs().max())
    ft_err = float((got[1] - ref[1]).abs().max())
    nc_diff = int((got[2] != ref[2]).sum())
    share = nc_diff / got[2].numel()
    seen_diff = (None if got[3] is None
                 else int((got[3] != ref[3]).sum()))
    log(f"  {name}: max|d img4| {img_err:.3e}  max|d final_t| {ft_err:.3e}"
        f"  n_contrib diffs {nc_diff} ({share:.2e})  seen diffs {seen_diff}"
        f"  max n_contrib {int(ref[2].max())}")
    if not (img_err <= atol and ft_err <= atol and share <= nc_share
            and seen_diff in (None, 0)):
        raise AssertionError(f"kernel disagrees with its plain version: {name}")
    if not bool(torch.isfinite(got[0]).all()):
        raise AssertionError(f"non-finite kernel output: {name}")
    return max(img_err, ft_err)


def work_of_frame(feats, sorted_gid, tile_starts, tile_counts, width,
                  height, tile_w, tile_h, t_eps, alpha_min, use_lod=False):
    """(evaluated, applied, candidate) (entry, pixel) pairs of the serial
    loop on these inputs, and the entries each tile reads: a replay of the
    plain version's control flow that counts, per pixel, the entries it
    evaluates up to its stop (a tile reads an entry while one of its pixels
    is live); candidates are the evaluated pairs with power <= 0 above the
    kernel's exp-free reject, which alone take the (LOD) alpha."""
    import math

    import torch
    from hlod_gaussians_torch.ops.rasterize_xla import F_OP
    from hlod_gaussians_torch.ops.rasterize_xla import (entry_alpha,
                                                        tile_pixels)
    px, py, inside = tile_pixels(width, height, tile_w, tile_h, feats.device)
    pxf, pyf = px.float(), py.float()
    t_run = torch.ones(px.shape, device=feats.device)
    done = ~inside
    evaluated = torch.zeros((), dtype=torch.int64, device=feats.device)
    applied = torch.zeros_like(evaluated)
    candidates = torch.zeros_like(evaluated)
    read = torch.zeros_like(tile_counts)
    log_amin = math.log(alpha_min) - 0.05
    for k in range(int(tile_counts.max())):
        live = (k < tile_counts)[:, None] & ~done
        evaluated += live.sum()
        read += live.any(1)
        f = feats[sorted_gid[torch.clamp(tile_starts + k, 0,
                                         sorted_gid.shape[0] - 1)].long()]
        alpha, power = entry_alpha(f, pxf, pyf, use_lod=use_lod)
        candidates += (live & (power <= 0.0) & (
            power >= log_amin - torch.log(f[:, F_OP:F_OP + 1]))).sum()
        pre = live & (power <= 0.0) & (alpha >= alpha_min)
        test_t = t_run * (1.0 - alpha)
        trigger = pre & (test_t < t_eps)
        apply = pre & ~trigger
        applied += apply.sum()
        t_run = torch.where(apply, test_t, t_run)
        done = done | trigger
    return int(evaluated), int(applied), int(candidates), read


def frame_bytes(fargs, per_tile, width, height, pixel_bytes, entry_bytes=0):
    """(bytes, entries, feature rows) a blend kernel must move on a frame:
    the first per_tile[t] entries of each tile (a 4-byte id each, plus
    `entry_bytes` written), the distinct feature rows those entries point at
    (48 bytes each: a row that no such entry names is never fetched), the
    tile ranges, and `pixel_bytes` a pixel."""
    import torch
    _, sorted_gid, tile_starts, _ = fargs
    per_tile = per_tile.long()
    n = int(per_tile.sum())
    tile = torch.repeat_interleave(
        torch.arange(per_tile.numel(), device=per_tile.device), per_tile)
    first = torch.cumsum(per_tile, 0) - per_tile
    pos = (tile_starts.long()[tile] - first[tile]
           + torch.arange(n, device=per_tile.device))
    rows = int(torch.unique(sorted_gid[pos]).numel())
    n_bytes = (rows * 12 * 4 + n * (4 + entry_bytes)
               + 2 * tile_starts.numel() * 4 + width * height * pixel_bytes)
    return n_bytes, n, rows


def check_backward(name, args, opts, fwd, gen):
    """Kernel B2 against its plain version on B1's final T and n_contrib
    (fwd) and seeded random cotangents; two launches must give the same
    bits. Returns (max abs error, the B2 inputs)."""
    import torch
    from hlod_gaussians_torch.ops import rasterize_cuda
    from hlod_gaussians_torch.ops.rasterize_xla import blend_backward_plain
    _, final_t, n_contrib, _ = fwd
    h, w = final_t.shape
    g_img4 = torch.randn((4, h, w), generator=gen, device=final_t.device)
    g_ft = torch.randn((h, w), generator=gen, device=final_t.device)
    bargs = tuple(args) + (final_t, n_contrib, g_img4, g_ft)
    bopts = {k: opts[k] for k in ("width", "height", "tile_w", "tile_h",
                                  "use_lod")}
    got = rasterize_cuda.blend_backward(*bargs, **bopts)
    again = rasterize_cuda.blend_backward(*bargs, **bopts)
    torch.cuda.synchronize()
    ref = blend_backward_plain(*bargs, **bopts)
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    same = torch.equal(got, again)
    log(f"  {name}: max|d egrads| {err:.3e} of max|egrads| {scale:.3e}"
        f"  ({err / max(scale, 1e-30):.2e} scaled)  bitwise repeat {same}")
    if not (scale > 0 and err <= GRAD_SCALED_ATOL * scale and same
            and bool(torch.isfinite(got).all())):
        raise AssertionError(f"kernel B2 disagrees with its plain version: "
                             f"{name}")
    return err, (bargs, bopts)


def small_train_state(dev, n=64, cap=96, seed=0):
    """A capacity-padded SH-1 state of n Gaussians 4 units in front of the
    camera (the JAX package's flat-training test scene, test_train_flat.py)."""
    from hlod_gaussians_torch import convert
    rng = np.random.default_rng(seed)
    xyz = np.zeros((cap, 3), np.float32)
    xyz[:n] = rng.normal(size=(n, 3)) * 0.5
    xyz[:n, 2] += 4.0
    f_dc = np.zeros((cap, 1, 3), np.float32)
    f_dc[:n, 0] = (rng.random((n, 3)) - 0.5) / 0.28209479177387814 + 0.3
    quat = np.zeros((cap, 4), np.float32)
    quat[:, 0] = 1.0
    arrays = dict(
        xyz=xyz, f_dc=f_dc, f_rest=np.zeros((cap, 3, 3), np.float32),
        log_scale=np.full((cap, 3), np.log(0.12), np.float32), quat=quat,
        opacity_logit=np.zeros((cap, 1), np.float32),
        exposure=np.eye(3, 4, dtype=np.float32)[None],
        alive=np.arange(cap) < n, nodes=np.full((cap, 6), -1, np.int32))
    return convert.state_from_numpy(arrays, n_skybox=0, device=dev)


def check_small_train_step(dev):
    """One train_step on the card (B1, B2, the CUDA reduction) against the
    same step on the CPU (plain versions): Adam moments (m = 0.1 g from zero
    moments) scaled to 3e-4, parameters to 1e-6 where |g| > 1e-3 max|g| and
    within 2 lr elsewhere, visibility statistics exactly."""
    import torch
    from hlod_gaussians_torch import optim
    from hlod_gaussians_torch.config import (OptimizationConfig,
                                             RasterizerConfig)
    from hlod_gaussians_torch.train import flat
    from hlod_gaussians_torch.utils.camera import make_camera
    cfg = RasterizerConfig(backend="pallas", tile_w=16, tile_h=16,
                           max_dup=4096)
    gt = np.random.default_rng(2).uniform(0, 1, (3, 64, 64)).astype(
        np.float32)
    new = {}
    for d in (torch.device("cpu"), dev):
        cam = make_camera(np.eye(3), np.zeros(3), 0.8, 0.8, 64, 64, device=d)
        ts = flat.init_flat_train(small_train_state(d))
        new[d.type], _ = flat.train_step(
            ts, cam.world_view, cam.full_proj, cam.campos, cam.tan_fovx,
            cam.tan_fovy, torch.as_tensor(gt, device=d),
            torch.tensor([0.1, 0.2, 0.3], device=d), exposure_idx=0,
            scene_extent=5.0, opt=OptimizationConfig(), cfg=cfg, width=64,
            height=64, sh_degree=1)
    ref, got = new["cpu"], new[dev.type]
    lrs = optim.param_lrs(OptimizationConfig(), 0, 5.0)
    worst = 0.0
    for k, m_ref in ref.adam.m.items():
        for part in ("m", "v"):
            r = getattr(ref.adam, part)[k]
            err = float((getattr(got.adam, part)[k].cpu() - r).abs().max())
            worst = max(worst, err / max(float(r.abs().max()), 1e-30))
        gabs = m_ref.abs()
        big = gabs > 1e-3 * gabs.max()
        diff = (getattr(got.gaussians, k).cpu()
                - getattr(ref.gaussians, k)).abs()
        if (diff[big].max() > 1e-6 if big.any() else False) or \
                diff.max() > 2 * lrs[k] + 1e-6:
            raise AssertionError(f"small train step: parameter {k} differs "
                                 "between the card and the CPU")
    same_stats = (torch.equal(got.denom.cpu(), ref.denom)
                  and torch.equal(got.max_radii.cpu(), ref.max_radii))
    accum_err = float((got.xyz_grad_accum.cpu() - ref.xyz_grad_accum)
                      .abs().max()) / float(ref.xyz_grad_accum.abs().max())
    log(f"  small train step, card vs CPU: Adam moments {worst:.2e} scaled, "
        f"xyz_grad_accum {accum_err:.2e} scaled, denom/max_radii equal "
        f"{same_stats}, {int(ref.denom.sum())} visible rows")
    if not (worst <= GRAD_SCALED_ATOL and accum_err <= GRAD_SCALED_ATOL
            and same_stats and int(ref.denom.sum()) > 0):
        raise AssertionError("small train step differs between the card and "
                             "the CPU")


def train_phase(ts, cam_args, gt, bg, cfg, width, height, extent=8.0):
    """TRAIN_STEPS train_step calls, each checked (untruncated, finite loss,
    exactly one B1 and one B2 launch), then the step's split timed on the
    final state: forward (render + loss), backward, Adam. `extent`: the
    bench cloud is N(0, 2) around z = 8, a radius of ~8 units."""
    import torch
    from hlod_gaussians_torch import optim
    from hlod_gaussians_torch.config import OptimizationConfig
    from hlod_gaussians_torch.ops import rasterize_cuda
    from hlod_gaussians_torch.ops import train_preprocess as tp
    from hlod_gaussians_torch.train import flat
    b1, b2 = rasterize_cuda.blend_forward, rasterize_cuda.blend_backward
    tpf, tpb = tp.train_preprocess_forward, tp.train_preprocess_backward
    opt = OptimizationConfig()
    step_kw = dict(exposure_idx=0, scene_extent=extent, opt=opt, cfg=cfg,
                   width=width, height=height, sh_degree=3)
    losses, step_ms, host_ms = [], [], []
    for i in range(TRAIN_STEPS):
        before = (b1.launches, b2.launches, tpf.launches, tpb.launches)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        ts, aux = flat.train_step(ts, *cam_args, gt, bg, **step_kw)
        b.record()
        b.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        step_ms.append(a.elapsed_time(b))
        losses.append(float(aux.loss))
        delta = (b1.launches - before[0], b2.launches - before[1],
                 tpf.launches - before[2], tpb.launches - before[3])
        if (bool(aux.truncated) or not np.isfinite(losses[-1])
                or delta != (1, 1, 1, 1)):
            raise AssertionError(f"train step {i}: truncated "
                                 f"{bool(aux.truncated)}, loss {losses[-1]}, "
                                 f"(B1, B2, train_preprocess forward, "
                                 f"backward) launches {delta}")
    launches = (b1.launches, b2.launches)      # before the split's runs
    if not losses[-1] < losses[0]:
        raise AssertionError(f"training did not lower the loss: {losses}")
    for k, v in ts.gaussians.params().items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"non-finite parameter {k} after training")

    g = ts.gaussians
    n = g.capacity

    def forward():
        params = {k: p.detach().requires_grad_(True)
                  for k, p in g.params().items()}
        xy_off = torch.zeros((n, 2), device=g.xyz.device, requires_grad=True)
        loss, (out, *_) = flat.step_loss(
            g, params, xy_off, *cam_args, gt, bg, exposure_idx=0, opt=opt,
            cfg=cfg, width=width, height=height, k_max=1024, sh_degree=3,
            use_exposure=True, antialiasing=False)
        return loss, params, xy_off, out

    fwd_ms = cuda_time_ms(forward, 5)
    bwd_times, adam_times, plain_times = [], [], []
    lrs = optim.param_lrs(opt, ts.step, extent)
    for _ in range(5):
        loss, params, xy_off, out = forward()
        torch.cuda.synchronize()
        grads = {}

        def backward():
            got = torch.autograd.grad(loss, list(params.values()) + [xy_off])
            grads.update(zip(params, got))
        bwd_times.append(cuda_time_ms(backward, 1, warmup=0))
        detached = {k: p.detach() for k, p in params.items()}
        kernel_ms, plain_ms = adam_times_ms(detached, grads, ts.adam, lrs,
                                            out.visible)
        adam_times.append(kernel_ms)
        plain_times.append(plain_ms)
    return dict(launches=launches, losses=[round(x, 6) for x in losses],
                step_ms=step_ms,
                host_ms=host_ms, n_visible=int(aux.n_visible), fwd_ms=fwd_ms,
                bwd_ms=statistics.median(bwd_times),
                adam_ms=statistics.median(adam_times),
                adam_plain_ms=statistics.median(plain_times))


def adam_times_ms(params, grads, state, lrs, visible):
    """One step's Adam on the card, CUDA events: (kernel sparse_adam through
    optim.sparse_adam_update, the plain chain optim.sparse_adam_plain)."""
    from hlod_gaussians_torch import optim
    return (cuda_time_ms(lambda: optim.sparse_adam_update(
                params, grads, state, lrs, visible=visible), 1, warmup=0),
            cuda_time_ms(lambda: optim.sparse_adam_plain(
                params, grads, state, lrs, visible=visible), 1, warmup=0))


def lod_bench_leaves(n=LOD_LEAVES):
    """The leaves of the JAX package's LOD bench tree (bench.py:168-176):
    positions N(0, 10) shifted +30 in z, log-normal scales, random unit
    quaternions, opacity U(0.3, 0.9), from default_rng(0); the SH widened to
    degree 3, the DC drawn there and 15 rest coefficients N(0, 0.05) after
    it from the same generator."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 10.0
    pts[:, 2] += 30.0
    scales = np.exp(rng.normal(size=(n, 3)) * 0.3 - 3.2).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    ops = rng.uniform(0.3, 0.9, n).astype(np.float32)
    dc = rng.normal(size=(n, 1, 3)).astype(np.float32) * 0.3
    rest = rng.normal(size=(n, 15, 3)).astype(np.float32) * 0.05
    return pts, scales, quats, ops, np.concatenate([dc, rest], axis=1)


def lod_bench_tree(dev, n=LOD_LEAVES):
    """Build the bench tree on `dev`, check it, and round-trip it through a
    .dhier file as a user would (the conversion of pipeline/full_train.py
    :157-163). Returns (state, hierarchy, build seconds, (file seconds,
    file bytes))."""
    import tempfile

    import torch
    from hlod_gaussians_torch.data import dhier as dhier_io
    from hlod_gaussians_torch.hierarchy import build as hb
    from hlod_gaussians_torch.hierarchy.cut import sanity_check_hierarchy
    from hlod_gaussians_torch.train.post import create_from_dhier
    leaves = lod_bench_leaves(n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = hb.build_hierarchy(*leaves, device=dev)
    build_s = time.perf_counter() - t0
    m = h.nodes.shape[0]
    sanity_check_hierarchy(h.nodes, np.ones(m, bool))
    d = bench_dhier(h)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bench.dhier")
        dhier_io.save_dhier(path, d)
        loaded = dhier_io.load_dhier(path)
        file_bytes = os.path.getsize(path)
    file_s = time.perf_counter() - t0
    for k in d._fields:
        if not np.array_equal(np.asarray(getattr(loaded, k)),
                              np.asarray(getattr(d, k))):
            raise AssertionError(f".dhier round trip changed {k}")
    state = create_from_dhier(loaded, capacity=m, device=dev)
    return state, h, build_s, (file_s, file_bytes)


def bench_dhier(h):
    """A built hierarchy as the .dhier the pipeline writes
    (pipeline/full_train.py's state_to_hierarchy conversion), SH 3."""
    from hlod_gaussians_torch.data import dhier as dhier_io
    return dhier_io.DHier(
        sh_degree=3, pos=h.pos, quat=h.quat,
        log_scale=np.log(np.maximum(h.scale, 1e-12)).astype(np.float32),
        opacity=np.clip(h.opacity, 1e-4, 1.0 - 1e-6).astype(np.float32),
        shs=h.sh.astype(np.float32), nodes=h.nodes)


def lod_bench_camera(i, width, height, dev):
    """The JAX package's LOD bench cameras (bench.py:200-207): at the
    origin, yawed 0.02 rad a step."""
    from hlod_gaussians_torch.utils.camera import make_camera
    a = 0.02 * i
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]], np.float32)
    return make_camera(R, np.zeros(3), 1.2, 0.8, width, height, device=dev)


def lod_target(tau, cam, width):
    from hlod_gaussians_torch import render
    return max(float(render.tau_to_threshold(tau, float(cam.tan_fovx),
                                             width)), 1e-9)


def stream_frames(lod, cams, tau, frames, kernel):
    """`frames` frames of render_lod_stream over the cameras in turn from a
    fresh state. Returns (state, per-frame (CUDA-event ms, host ms, B1
    launches), the last frame's (image, n_selected, truncated))."""
    import torch
    from hlod_gaussians_torch import render
    act, state = lod["act"], lod["state"]
    st, rows, events = {}, [], []
    target = lod_target(tau, cams[0], lod["width"])
    for i in range(frames):
        cam = cams[i % len(cams)]
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        before = kernel.launches
        t0 = time.perf_counter()
        a.record()
        with torch.no_grad():
            out, n_sel = render.render_lod_stream(
                act.means3d, act.scales, act.quats, act.opacities, act.shs,
                state.nodes, state.alive, cam.world_view, cam.full_proj,
                cam.campos, cam.tan_fovx, cam.tan_fovy, lod["bg"], target,
                st, pcache=lod["pcache"], interp_table=lod["itab"],
                sh_degree=3, width=lod["width"], height=lod["height"],
                cfg=lod["cfg"], k_max=512, use_frustum=False)
        b.record()
        rows.append([(time.perf_counter() - t0) * 1e3,
                     kernel.launches - before])
        events.append((a, b))
    torch.cuda.synchronize()
    for (a, b), row in zip(events, rows):
        row.insert(0, a.elapsed_time(b))
    return st, rows, (out.image, int(n_sel), bool(out.truncated))


def lod_frame(lod, cam, tau, cfg, budget=None, k_max=512):
    """One frame of the LOD bench tree: render_lod at ``budget``, or
    render_lod_masked where it is None. Returns (RenderResult,
    n_selected)."""
    import torch
    from hlod_gaussians_torch import render
    act, state = lod["act"], lod["state"]
    args = (act.means3d, act.scales, act.quats, act.opacities, act.shs,
            state.nodes, state.alive, cam.world_view, cam.full_proj,
            cam.campos, cam.tan_fovx, cam.tan_fovy, lod["bg"],
            lod_target(tau, cam, lod["width"]))
    kw = dict(pcache=lod["pcache"], interp_table=lod["itab"], sh_degree=3,
              width=lod["width"], height=lod["height"], cfg=cfg,
              k_max=k_max, use_frustum=False)
    with torch.no_grad():
        if budget is None:
            out, n_sel = render.render_lod_masked(*args, **kw)
        else:
            out, n_sel = render.render_lod(*args, budget=budget, **kw)
    return out, int(n_sel)


def top_down_cut(nodes, size, target):
    """The size rule read from the root down: a node is in the cut when it
    is below the target (or a leaf) and every ancestor is at or above it.
    Where a child projects larger than its parent the per-node rule
    (expand_to_size_dynamic) is no proper cut; this one always is, and it is
    where incremental_cut_step settles from the root."""
    import torch
    from hlod_gaussians_torch.models.gaussians import (NODE_CHILD_COUNT,
                                                       NODE_DEPTH,
                                                       NODE_PARENT)
    parent = nodes[:, NODE_PARENT].long().clamp_min(0)
    depth = nodes[:, NODE_DEPTH]
    open_path = nodes[:, NODE_PARENT] < 0
    for d in range(1, int(depth.max()) + 1):
        open_path = torch.where(
            depth == d, open_path[parent] & (size[parent] >= target),
            open_path)
    return open_path & ((size < target) | (nodes[:, NODE_CHILD_COUNT] == 0))


def capture_b1_inputs(run):
    """B1's inputs as the render hands them to the kernel's wrapper, with
    the render stopped there (run() renders one frame)."""
    from hlod_gaussians_torch.ops import rasterize_cuda
    calls, kernel = [], rasterize_cuda.blend_forward

    class Captured(Exception):
        pass

    def record(*a, **kw):
        calls.append((a, kw))
        raise Captured

    rasterize_cuda.blend_forward = record
    try:
        run()
    except Captured:
        pass
    finally:
        rasterize_cuda.blend_forward = kernel
    (fargs, kw), = calls
    return fargs, {k: kw[k] for k in ("width", "height", "tile_w", "tile_h",
                                      "t_eps", "alpha_min", "use_lod")}


def bare_launch_ms(fargs, opts, reps=20):
    """B1's bare launch (the C entry point into preallocated outputs), the
    median of `reps` CUDA-event timings."""
    import torch
    from hlod_gaussians_torch.ops import rasterize_cuda
    feats = fargs[0]
    h, w = opts["height"], opts["width"]
    img4 = torch.empty((4, h, w), device=feats.device)
    final_t = torch.empty((h, w), device=feats.device)
    n_contrib = torch.empty((h, w), dtype=torch.int32, device=feats.device)
    return cuda_time_ms(lambda: rasterize_cuda.launch_blend_forward(
        *fargs, img4, final_t, n_contrib, None, **opts), reps, warmup=3)


def bare_b2_launch_ms(bargs, bopts, reps=20):
    """B2's bare launch (the C entry point into a preallocated gradient
    buffer), the median of `reps` CUDA-event timings."""
    import torch
    from hlod_gaussians_torch.ops import rasterize_cuda
    from hlod_gaussians_torch.ops.rasterize_xla import N_FEATS
    feats, sorted_gid = bargs[:2]
    egrads = torch.zeros((sorted_gid.shape[0], N_FEATS), device=feats.device)
    return cuda_time_ms(lambda: rasterize_cuda.launch_blend_backward(
        *bargs, egrads, alpha_min=1.0 / 255.0, **bopts), reps, warmup=3)


def b2_work(fargs, fwd, applied, width, height, tile_w=32, tile_h=32):
    """(needed pairs, bytes, f32 ops, entries walked, feature rows) of B2 on
    a frame of tile_w x tile_h tiles: every entry before a pixel's n_contrib
    decides whether it was applied, and the applied pairs carry the gradient
    (phase [2b]'s count); a tile walks its entries up to its largest
    n_contrib, reads each one's feature row and writes its 48-byte gradient
    row."""
    from hlod_gaussians_torch.ops.rasterize_xla import tile_image
    needed = int(fwd[2].sum())
    walk = tile_image(fwd[2], width, height, tile_w, tile_h).amax(1)
    n_bytes, n, rows = frame_bytes(fargs, walk, width, height,
                                   4 + 4 + 4 * 4 + 4, entry_bytes=12 * 4)
    return (needed, n_bytes, B2_OPS_NEED * needed + B2_OPS_APPLY * applied,
            n, rows)


def bound(n_bytes, ops):
    """The least time the card could take for this work: (ms, what bounds
    it, "bytes x ms, ops y ms")."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", f"bytes {t_bytes:.4f} ms, ops {t_ops:.4f} ms")


def frame_kernels(captured, dev, width, height, where, smi):
    """B1 and B2 at a frame, from its B1 inputs as capture_b1_inputs gives
    them (its tiles): B1 against its plain version to 1e-4 with n_contrib
    exact, B2 to 3e-4 scaled; the bare launch, the wrapper, the plain
    version and the bound of each -> (B1's numbers, B2's numbers, B1's
    error, B2's error)."""
    import torch
    from hlod_gaussians_torch.ops import rasterize_cuda
    from hlod_gaussians_torch.ops.rasterize_xla import (blend_backward_plain,
                                                        blend_forward_plain)
    kernel = rasterize_cuda.blend_forward
    kernel_b2 = rasterize_cuda.blend_backward
    fargs, fopts = captured
    fargs = tuple(a.detach() for a in fargs)
    got = kernel(*fargs, **fopts)
    torch.cuda.synchronize()
    ref = blend_forward_plain(*fargs, **fopts)
    b1_err = compare(where, got, ref, FRAME_ATOL)
    del ref
    b1 = dict(ms=bare_launch_ms(fargs, fopts),
              wrapper_ms=cuda_time_ms(lambda: kernel(*fargs, **fopts), 20,
                                      warmup=3),
              plain_ms=cuda_time_ms(lambda: blend_forward_plain(
                  *fargs, **fopts), 2))
    feats, sorted_gid, _, counts = fargs
    n_entries = int(counts.sum())
    evaluated, applied, _, read = work_of_frame(
        *fargs, width, height, fopts["tile_w"], fopts["tile_h"],
        fopts["t_eps"], fopts["alpha_min"])
    b1_bytes, b1_read, b1_rows = frame_bytes(fargs, read, width, height,
                                             4 * 4 + 4 + 4)
    b1["bound_ms"], b1["bound_by"], b1_parts = bound(
        b1_bytes, OPS_EVAL * evaluated + OPS_APPLY * applied)
    gen = torch.Generator(device=dev).manual_seed(1)
    b2_err, (bargs, bopts) = check_backward(
        where, fargs, dict(fopts, use_lod=False), got, gen)
    needed, b2_bytes, b2_ops, b2_walk, b2_rows = b2_work(
        fargs, got, applied, width, height, fopts["tile_w"],
        fopts["tile_h"])
    b2 = dict(ms=bare_b2_launch_ms(bargs, bopts),
              wrapper_ms=cuda_time_ms(lambda: kernel_b2(*bargs, **bopts), 20,
                                      warmup=3),
              plain_ms=cuda_time_ms(lambda: blend_backward_plain(
                  *bargs, **bopts), 2))
    b2["bound_ms"], b2["bound_by"], b2_parts = bound(b2_bytes, b2_ops)
    log(f"  {where}: {feats.shape[0]} rows, {n_entries} entries of "
        f"max_dup {sorted_gid.shape[0]}; B1 reads {b1_read} entries naming "
        f"{b1_rows} rows ({b1_bytes} bytes), B2 walks {b2_walk} naming "
        f"{b2_rows} ({b2_bytes} bytes); {evaluated} evaluated, {applied} "
        f"applied and {needed} B2-needed (entry, pixel) pairs")
    for name, k, parts in (("blend_forward", b1, b1_parts),
                            ("blend_backward", b2, b2_parts)):
        log(f"  {name} at the {where}: launch {k['ms']:.4f} ms, wrapper "
            f"{k['wrapper_ms']:.4f} ms, plain version {k['plain_ms']:.2f} ms, "
            f"bound {k['bound_ms']:.4f} ms ({k['bound_by']}; {parts}) "
            f"[{smi}]")
    return b1, b2, b1_err, b2_err


def post_bench_leaves(n=POST_LEAVES):
    """The leaves of the JAX package's post-optimization bench tree
    (scripts/offload_bench3.py:47-66): half on a shell of radius ~20, half
    in an N(0, 12) volume, scales exp(N(0, 0.3) - 3.4), unit quaternions,
    opacity U(0.2, 0.9), SH degree 1 (DC N(0, 0.4), rest N(0, 0.05)), from
    default_rng(11)."""
    rng = np.random.default_rng(11)
    n_shell = n // 2
    sph = rng.normal(size=(n_shell, 3)).astype(np.float32)
    sph /= np.linalg.norm(sph, axis=-1, keepdims=True)
    shell = sph * (20.0 + rng.normal(size=(n_shell, 1)).astype(np.float32))
    vol = rng.normal(size=(n - n_shell, 3)).astype(np.float32) * 12.0
    pts = np.concatenate([shell, vol]).astype(np.float32)
    scales = np.exp(rng.normal(size=(n, 3)) * 0.3 - 3.4).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    ops = rng.uniform(0.2, 0.9, n).astype(np.float32)
    shs = np.concatenate([
        rng.normal(size=(n, 1, 3)).astype(np.float32) * 0.4,
        rng.normal(size=(n, 3, 3)).astype(np.float32) * 0.05], axis=1)
    return pts, scales, quats, ops, shs


def orbit_poses(n=POST_VIEWS):
    """The 40-view orbit (offload_bench3.py:107-119) as (R, t) pairs for
    make_camera: yaw 2 pi i / 40, the ring point of radius 8 passed as the
    translation, as there."""
    poses = []
    for i in range(n):
        a = 2 * np.pi * i / n
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]], np.float32)
        campos = np.array([8.0 * np.sin(a), 0.0, -8.0 * np.cos(a)],
                          np.float32)
        poses.append((R, campos))
    return poses


def post_bench_cameras(width, height, dev, n=POST_VIEWS):
    """The orbit's cameras (fov 1.2 x 0.8) at width x height on `dev`."""
    from hlod_gaussians_torch.utils.camera import make_camera
    return [make_camera(R, t, ORBIT_FOV[0], ORBIT_FOV[1], width, height,
                        device=dev) for R, t in orbit_poses(n)]


def post_bench_dhier(dev, n=POST_LEAVES):
    """The post bench tree built on `dev` as a .dhier (offload_bench3.py
    :75-79); returns (DHier, build seconds)."""
    import torch
    from hlod_gaussians_torch.data.dhier import DHier
    from hlod_gaussians_torch.hierarchy import build as hb
    leaves = post_bench_leaves(n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = hb.build_hierarchy(*leaves, device=dev)
    build_s = time.perf_counter() - t0
    return DHier(
        sh_degree=1, pos=h.pos, quat=h.quat,
        log_scale=np.log(np.maximum(h.scale, 1e-12)).astype(np.float32),
        opacity=np.clip(h.opacity, 1e-4, 1 - 1e-6).astype(np.float32),
        shs=h.sh.astype(np.float32), nodes=h.nodes), build_s


def perturb_post_dhier(d, n_dead=POST_DEAD, seed=12):
    """f_dc + 0.3, and `n_dead` seeded random leaves at opacity 0.001 (below
    relocate_gs's 0.005)."""
    shs = d.shs.copy()
    shs[:, 0] += np.float32(0.3)
    opacity = d.opacity.copy()
    leaves = np.where(d.nodes[:, 2] == 0)[0]
    dead = np.random.default_rng(seed).choice(leaves, n_dead, replace=False)
    opacity[dead] = np.float32(0.001)
    return d._replace(shs=shs, opacity=opacity)


def tree_invariants(g):
    """The node table of the alive rows is a proper tree (test_mcmc.py
    :71-85 on the card, plus depths): an interior node's two children are
    alive and point back at it, a child's parent is an alive interior node
    one level up, and there is one root."""
    import torch
    from hlod_gaussians_torch.models.gaussians import (NODE_CHILD_COUNT,
                                                       NODE_DEPTH,
                                                       NODE_FIRST_CHILD,
                                                       NODE_NEXT_SIBLING,
                                                       NODE_PARENT)
    nodes, alive = g.nodes, g.alive
    c = nodes.shape[0]
    idx = torch.arange(c, device=nodes.device)
    clip = lambda v: v.long().clamp(0, c - 1)
    c0 = clip(nodes[:, NODE_FIRST_CHILD])
    c1 = clip(nodes[c0, NODE_NEXT_SIBLING])
    interior = alive & (nodes[:, NODE_CHILD_COUNT] == 2)
    ok = ~interior | (alive[c0] & alive[c1] & (nodes[c0, NODE_PARENT] == idx)
                      & (nodes[c1, NODE_PARENT] == idx))
    p = clip(nodes[:, NODE_PARENT])
    child = alive & (nodes[:, NODE_PARENT] >= 0)
    ok &= ~child | (alive[p] & (nodes[p, NODE_CHILD_COUNT] == 2)
                    & (nodes[:, NODE_DEPTH] == nodes[p, NODE_DEPTH] + 1))
    roots = alive & (nodes[:, NODE_PARENT] < 0) & (nodes[:, NODE_DEPTH] >= 0)
    return bool(ok.all()) and int(roots.sum()) == 1


def post_targets(d, cap, cams, dev, width, height, n_leaves=POST_LEAVES):
    """The post phase's targets: the unperturbed tree at each view's SPT
    cut, rendered as a post step renders (antialiasing on) with a generous
    capacity (16 entries a leaf). Returns the views with their images, the
    forest and its rebuild seconds, camera 0's working set, the rows and
    entries of each view, and the training's max_dup: 1.25 times the most
    entries a view needs, in MiB-entry steps."""
    import torch
    from hlod_gaussians_torch import render
    from hlod_gaussians_torch.config import PostConfig, RasterizerConfig
    from hlod_gaussians_torch.hierarchy import spt as spt_mod
    from hlod_gaussians_torch.models import gaussians as gm
    from hlod_gaussians_torch.train import post
    pcfg = PostConfig()
    bg = torch.zeros(3, device=dev)
    clean = post.create_from_dhier(d, cap, scene_radius=25.0, device=dev)
    t0 = time.perf_counter()
    forest = post.rebuild_spt(clean, post=pcfg)
    torch.cuda.synchronize()
    out = dict(forest=forest, rebuild_s=time.perf_counter() - t0, views=[],
               ws_rows=[], entries=[])
    act = gm.activate(clean)
    probe = RasterizerConfig(backend="pallas", tile_w=32, tile_h=32,
                             max_dup=16 * n_leaves, tight_binning=True)
    for i, cam in enumerate(cams):
        cut = spt_mod.spt_cut_budgeted(
            forest, cap, cam.campos, cam.full_proj, pcfg.max_gaussian_budget,
            grow=pcfg.distance_multiplier_until_budget,
            use_frustum=pcfg.use_frustum_culling)
        with torch.no_grad():
            r = render.render_arrays(
                act.means3d, act.scales, act.quats, act.opacities, act.shs,
                act.valid & cut.gaussian_mask, cam.world_view, cam.full_proj,
                cam.campos, cam.tan_fovx, cam.tan_fovy, bg, sh_degree=1,
                width=width, height=height, cfg=probe, antialiasing=True)
        if bool(r.truncated):
            raise AssertionError(f"target {i} truncated at {probe.max_dup} "
                                 "entries")
        out["views"].append(dataclasses.replace(cam, image=r.image))
        out["ws_rows"].append(int(cut.n_selected))
        out["entries"].append(int(r.n_dup))
        if i == 0:
            out["mask0"] = cut.gaussian_mask
    out["max_dup"] = -(-int(1.25 * max(out["entries"])) // (1 << 20)) \
        * (1 << 20)
    return out


def post_phase(dev, width, height, smi, n_leaves=POST_LEAVES):
    """Phase 12: hierarchy post-optimization on the post bench tree; returns
    the B1 and B2 launches of the post path, both kernels' numbers at one
    post frame and the largest kernel-vs-plain errors."""
    import torch
    from hlod_gaussians_torch import optim, render
    from hlod_gaussians_torch.config import (OptimizationConfig, PostConfig,
                                             RasterizerConfig)
    from hlod_gaussians_torch.hierarchy import spt as spt_mod
    from hlod_gaussians_torch.models import gaussians as gm
    from hlod_gaussians_torch.models import reorder
    from hlod_gaussians_torch.ops import rasterize_cuda
    from hlod_gaussians_torch.pipeline import full_train
    from hlod_gaussians_torch.train import post
    kernel = rasterize_cuda.blend_forward
    kernel_b2 = rasterize_cuda.blend_backward
    pcfg = PostConfig()
    extent = 25.0
    bg = torch.zeros(3, device=dev)

    log(f"[12] post-optimization: {n_leaves} leaves (the JAX package's "
        f"post bench tree, SH 1), {POST_VIEWS}-view {width}x{height} orbit, "
        f"post_optimize {POST_ITERS} steps with an MCMC round every "
        f"{POST_DENSIFY}, then {POST_OCC_ITERS} with the occlusion cull")
    d, build_s = post_bench_dhier(dev, n_leaves)
    m = d.nodes.shape[0]
    cap = m + POST_FREE_ROWS
    cams = post_bench_cameras(width, height, dev)

    t = post_targets(d, cap, cams, dev, width, height, n_leaves)
    views, forest, max_dup = t["views"], t["forest"], t["max_dup"]
    ws_rows, entries, mask0 = t["ws_rows"], t["entries"], t["mask0"]
    cfg = RasterizerConfig(backend="pallas", tile_w=32, tile_h=32,
                           max_dup=max_dup, tight_binning=True)
    log(f"  {m} nodes, built on the card in {build_s:.2f} s; capacity {cap}; "
        f"forest {forest.n_spts} SPTs, {forest.entry_gid.shape[0]} entries, "
        f"{forest.ut_nodes.shape[0]} upper-tree nodes, rebuild_spt "
        f"{t['rebuild_s']:.2f} s (host sweep)")
    log(f"  working-set rows per view: min {min(ws_rows)}, max "
        f"{max(ws_rows)}, mean {np.mean(ws_rows):.0f}; target entries min "
        f"{min(entries)}, max {max(entries)} -> max_dup {max_dup}")

    # camera 0's L1 before: the perturbed state at its cut
    pert_d = perturb_post_dhier(d, min(POST_DEAD, n_leaves // 16))
    del forest, d, t

    def l1_at_cam0(g, mask):
        a = gm.activate(g, mask)
        with torch.no_grad():
            out = render.render_arrays(
                a.means3d, a.scales, a.quats, a.opacities, a.shs, a.valid,
                cams[0].world_view, cams[0].full_proj, cams[0].campos,
                cams[0].tan_fovx, cams[0].tan_fovy, bg, sh_degree=1,
                width=width, height=height, cfg=cfg, antialiasing=True)
        return float((out.image - views[0].image).abs().mean())

    pert = post.create_from_dhier(pert_d, cap, scene_radius=extent,
                                  device=dev)
    l1_before = l1_at_cam0(pert, mask0)
    del pert, mask0

    # the loop: its logger records an event after every step (after the
    # MCMC round and rebuild where one ran), and holds the tree that each
    # round's surgery left to its invariants
    rec, rounds, surgery = [], [], []

    class Record:
        def log(self, **kv):
            if kv["stage"] == "post_densify":
                if not tree_invariants(surgery.pop().gaussians):
                    raise AssertionError(f"MCMC round at step {kv['it']} "
                                         "broke the tree")
                rounds.append(kv)
                return
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            rec.append(dict(kv, ev=ev, host=time.perf_counter(),
                            launches=(kernel.launches, kernel_b2.launches)))

    densify_round = post.densify_round

    def observed_round(*a, **kw):
        out = densify_round(*a, **kw)
        surgery.append(out[0])
        return out

    torch.cuda.synchronize()
    kernel.launches = kernel_b2.launches = 0
    post.densify_round = observed_round
    t0 = time.perf_counter()
    try:
        ts = full_train.post_optimize(
            pert_d, views, extent, POST_ITERS, cap, post=pcfg, cfg=cfg,
            pcfg=full_train.PipelineConfig(
                post_densify_interval=POST_DENSIFY),
            logger=Record(), log_every=1, device=dev)
    finally:
        post.densify_round = densify_round
    loop_s = time.perf_counter() - t0
    post_launches = (kernel.launches, kernel_b2.launches)
    prev = (0, 0)
    step_ms, host_ms = [], []
    for i, r in enumerate(rec):
        delta = (r["launches"][0] - prev[0], r["launches"][1] - prev[1])
        prev = r["launches"]
        if r["truncated"] or not np.isfinite(r["loss"]) or delta != (1, 1):
            raise AssertionError(f"post step {r['it']}: truncated "
                                 f"{r['truncated']}, loss {r['loss']}, "
                                 f"(B1, B2) launches {delta}")
        if i > 0 and r["it"] % POST_DENSIFY:
            step_ms.append(rec[i - 1]["ev"].elapsed_time(r["ev"]))
            host_ms.append((r["host"] - rec[i - 1]["host"]) * 1e3)
    losses = [r["loss"] for r in rec]
    log(f"  {len(rec)} steps in {loop_s:.1f} s (setup, rounds and rebuilds "
        f"included); working-set rows per step {[r['n_cut'] for r in rec]}"
        f"; rendered (visible) rows median "
        f"{statistics.median([r['n_rendered'] for r in rec])}")
    log(f"  step median {statistics.median(step_ms):.3f} ms on the card (CUDA "
        f"events, {len(step_ms)} steps without a round; min "
        f"{min(step_ms):.3f}, max {max(step_ms):.3f}), host wall median "
        f"{statistics.median(host_ms):.3f} ms; one B1 and one B2 launch a "
        f"step; losses {[round(x, 5) for x in losses[::8]]} [{smi}]")
    for r in rounds:
        log(f"  MCMC round at step {r['it']}: {r['n_added_pairs']} pairs "
            f"added, {r['n_relocated']} rows relocated, size {r['size']}; "
            f"densify_round {r['densify_s']:.3f} s, rebuild_spt "
            f"{r['rebuild_s']:.2f} s")
    if (len(rounds) != len(range(POST_DENSIFY, POST_ITERS, POST_DENSIFY))
            or any(r["n_relocated"] <= 0 for r in rounds)):
        raise AssertionError(f"MCMC rounds {rounds}")

    # camera 0's L1 after, at the cut of the final tree
    t0 = time.perf_counter()
    forest = post.rebuild_spt(ts.gaussians, post=pcfg)
    rebuild_end_s = time.perf_counter() - t0
    cut0 = spt_mod.spt_cut_budgeted(
        forest, cap, cams[0].campos, cams[0].full_proj,
        pcfg.max_gaussian_budget, grow=pcfg.distance_multiplier_until_budget)
    l1_after = l1_at_cam0(ts.gaussians, cut0.gaussian_mask)
    log(f"  camera 0 L1 against its target: {l1_before:.6f} before, "
        f"{l1_after:.6f} after; final tree {int(ts.gaussians.alive.sum())} "
        f"rows, invariants hold {tree_invariants(ts.gaussians)}, "
        f"rebuild_spt {rebuild_end_s:.2f} s")
    if not (l1_after < l1_before and tree_invariants(ts.gaussians)):
        raise AssertionError("post-optimization did not lower camera 0's L1")

    # the split of one step on the final state (camera 0)
    g = ts.gaussians
    cam_args = (cams[0].world_view, cams[0].full_proj, cams[0].campos,
                cams[0].tan_fovx, cams[0].tan_fovy)
    split = dict(cut=cuda_time_ms(lambda: spt_mod.spt_cut_budgeted(
        forest, cap, cams[0].campos, cams[0].full_proj,
        pcfg.max_gaussian_budget), 5))
    loss_kw = dict(opt=OptimizationConfig(), post=pcfg, cfg=cfg,
                   width=width, height=height, k_max=1024, sh_degree=1,
                   antialiasing=True)

    def forward():
        params = {k: p.detach().requires_grad_(True)
                  for k, p in g.params().items()}
        loss, (out, *_) = post.post_loss(
            g, params, cut0.gaussian_mask, *cam_args, views[0].image, bg,
            **loss_kw)
        return loss, params, out

    split["render + loss"] = cuda_time_ms(forward, 3)
    bwd, adam, adam_plain = [], [], []
    lrs = optim.param_lrs(OptimizationConfig(), ts.step, extent)
    for _ in range(3):
        loss, params, out = forward()
        torch.cuda.synchronize()
        grads = {}

        def backward():
            got = torch.autograd.grad(loss, list(params.values()),
                                      allow_unused=True)
            grads.update((k, torch.zeros_like(params[k]) if v is None else v)
                         for k, v in zip(params, got))
        bwd.append(cuda_time_ms(backward, 1, warmup=0))
        detached = {k: p.detach() for k, p in params.items()}
        kernel_ms, plain_ms = adam_times_ms(detached, grads, ts.adam, lrs,
                                            out.visible)
        adam.append(kernel_ms)
        adam_plain.append(plain_ms)
    split["backward"] = statistics.median(bwd)
    split["Adam"] = statistics.median(adam)
    split["Adam's plain chain"] = statistics.median(adam_plain)
    del loss, params, out, grads, detached
    log("  split of one step (camera 0, CUDA events): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()) + f" [{smi}]")

    # B1 and B2 at this post frame
    b1, b2, b1_err, b2_err = frame_kernels(capture_b1_inputs(forward), dev,
                                           width, height, "post frame", smi)

    # 4 more steps with the occlusion cull: the state exported to a .dhier
    # and post-optimized again, as a resumed run would
    occ = []

    class OccRecord:
        def log(self, **kv):
            occ.append((kernel.launches, kernel_b2.launches, kv["loss"],
                        kv["truncated"], kv["n_rendered"]))

    resumed = post.state_to_dhier(ts.gaussians)
    del ts, g
    torch.cuda.empty_cache()
    kernel.launches = kernel_b2.launches = 0
    ts2 = full_train.post_optimize(
        resumed, views, extent, POST_OCC_ITERS, cap,
        post=dataclasses.replace(pcfg, use_occlusion_culling=True), cfg=cfg,
        pcfg=full_train.PipelineConfig(post_densify_interval=POST_DENSIFY),
        logger=OccRecord(), log_every=1, device=dev)
    occ_launches = (kernel.launches, kernel_b2.launches)
    prev = (0, 0)
    for i, (l1_, l2_, loss, trunc, rendered) in enumerate(occ):
        delta = (l1_ - prev[0], l2_ - prev[1])
        prev = (l1_, l2_)
        if trunc or not np.isfinite(loss) or delta != (2, 1):
            raise AssertionError(f"occlusion step {i}: truncated {trunc}, "
                                 f"loss {loss}, (B1, B2) launches {delta}")
    forest = post.rebuild_spt(ts2.gaussians, post=pcfg)
    cut0 = spt_mod.spt_cut(forest, cap, cams[0].campos, cams[0].full_proj)
    occ_out = reorder.occlusion_render(ts2.gaussians, cut0.gaussian_mask,
                                       *cam_args)
    kept = int((occ_out.seen & cut0.gaussian_mask).sum())
    log(f"  occlusion cull: {POST_OCC_ITERS} steps of two B1 and one B2 "
        f"launch each, losses {[round(o[2], 5) for o in occ]}, rendered rows "
        f"{[o[4] for o in occ]}; at camera 0 it keeps {kept} of "
        f"{int(cut0.n_selected)} rows; its 256x256 render needs "
        f"{int(occ_out.n_dup)} of 2^17 entries, truncated "
        f"{bool(occ_out.truncated)}")
    return dict(b1=post_launches[0] + occ_launches[0],
                b2=post_launches[1] + occ_launches[1],
                b1_frame=b1, b2_frame=b2, b1_err=b1_err, b2_err=b2_err,
                max_dup=max_dup)


def write_orbit_colmap(sparse, width, height, points, n=POST_VIEWS):
    """The orbit as a COLMAP model in `sparse`, written by the port's
    writers: one PINHOLE camera of fov 1.2 x 0.8, image i's world-to-camera
    rotation the transpose of the orbit's camera-to-world R and its
    translation the ring point, `points` as points3D."""
    from hlod_gaussians_torch.data import colmap as cm
    os.makedirs(sparse)
    fx = width / (2.0 * np.tan(ORBIT_FOV[0] / 2))
    fy = height / (2.0 * np.tan(ORBIT_FOV[1] / 2))
    cams = {1: cm.ColmapCamera(1, "PINHOLE", width, height,
                               np.array([fx, fy, width / 2, height / 2]))}
    images = {
        i + 1: cm.ColmapImage(
            i + 1, cm.rotmat2qvec(R.T.astype(np.float64)),
            t.astype(np.float64), 1, f"view_{i:03d}.png", np.zeros((0, 2)),
            np.zeros((0,), np.int64))
        for i, (R, t) in enumerate(orbit_poses(n))}
    cm.write_cameras_bin(os.path.join(sparse, "cameras.bin"), cams)
    cm.write_images_bin(os.path.join(sparse, "images.bin"), images)
    cm.write_points3d_bin(os.path.join(sparse, "points3D.bin"), cm.ColmapPoints(
        points.astype(np.float32), np.full((len(points), 3), 128, np.uint8),
        np.zeros(len(points), np.float32)))


def loaded_orbit_views(width, height, dev, points):
    """The orbit written as a COLMAP model and read back through
    data.scene.load_colmap_scene; each view's camera is built from its
    CameraInfo as load_view builds it (the model names no image files, so
    nothing is read from disk). Returns the views and the largest
    difference of their world_view, full_proj and campos from
    make_camera's."""
    import tempfile

    import torch
    from hlod_gaussians_torch.data import scene
    from hlod_gaussians_torch.utils.camera import make_camera
    with tempfile.TemporaryDirectory() as root:
        write_orbit_colmap(os.path.join(root, "sparse", "0"), width, height,
                           points)
        info = scene.load_colmap_scene(root)
    if len(info.train_cameras) != POST_VIEWS or info.test_cameras:
        raise AssertionError("the orbit's COLMAP model did not load")
    views = [make_camera(c.R, c.T, c.fovx, c.fovy, c.width, c.height,
                         primx=c.primx, primy=c.primy, device=dev)
             for c in info.train_cameras]
    ref = post_bench_cameras(width, height, dev)
    diff = max(float((getattr(a, f) - getattr(b, f)).abs().max())
               for a, b in zip(views, ref)
               for f in ("world_view", "full_proj", "campos"))
    del ref
    torch.cuda.synchronize()
    return views, diff


def small_offload_check(dev):
    """The out-of-core trainer on tests/test_offload.py's toy scene (48
    points, budget 64, overlapping working sets) on the card: with the next
    view prefetched it gives the unpipelined run bit for bit, and its
    flushed store is the sequential packed step's to that test's tolerance
    (rtol 2e-5; atol 2e-6 parameters, 1e-7 moments)."""
    import torch
    from hlod_gaussians_torch.config import RasterizerConfig
    from hlod_gaussians_torch.models import gaussians as gm
    from hlod_gaussians_torch.train import offload
    from hlod_gaussians_torch.utils.camera import make_camera
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(48, 3)).astype(np.float32) * 0.5
    pts[:, 2] += 4.0
    state = gm.create_from_points(pts, rng.random((48, 3)).astype(np.float32),
                                  capacity=256, sh_degree=1,
                                  opacity_init=0.7, device=dev)
    cam = make_camera(np.eye(3), np.zeros(3), 0.9, 0.9, 48, 48, device=dev)
    cam_args = (cam.world_view, cam.full_proj, cam.campos, cam.tan_fovx,
                cam.tan_fovy, torch.full((3, 48, 48), 0.35, device=dev),
                torch.zeros(3, device=dev))
    cfg = RasterizerConfig(backend="pallas", tile_w=16, tile_h=16,
                           max_dup=4096)
    kw = dict(width=48, height=48, k_max=128, scene_extent=2.0)
    sets = [np.arange(0, 32), np.arange(16, 40), np.arange(8, 36),
            np.arange(0, 24)]
    runs = []
    for prefetch in (False, True):
        tr = offload.DeviceResidentTrainer(
            offload.PackedStore.from_state(state), budget=64, cfg=cfg,
            device=dev, **kw)
        fetched = []
        for i, rows in enumerate(sets):
            nxt = sets[i + 1] if prefetch and i + 1 < len(sets) else None
            tr.step(rows, *cam_args, prefetch_rows=nxt)
            fetched.append(tr.last_fetch)
        tr.flush()
        runs.append((tr.store.data, fetched))
    seq = offload.PackedStore.from_state(state)
    dispatch, writeback = offload.make_packed_offloaded_step(
        cfg=cfg, sh_degree=1, **kw)
    for rows in sets:
        writeback(seq, dispatch(seq, rows.astype(np.int32), *cam_args))
    (plain, f_plain), (pre, f_pre) = runs
    bitwise = torch.equal(plain.view(torch.int32), pre.view(torch.int32))
    p, m, _ = offload.unpack_rows(plain, 1)
    sp, sm, _ = offload.unpack_rows(seq.data, 1)
    errs = {k: float(((p[k] - sp[k]).abs()
                      - 2e-5 * sp[k].abs()).max())
            for k in ("xyz", "opacity_logit", "f_dc")}
    m_err = float(((m["xyz"] - sm["xyz"]).abs()
                   - 2e-5 * sm["xyz"].abs()).max())
    log(f"  small scene (budget 64): fetched {f_plain} without prefetch, "
        f"{f_pre} with; prefetch bitwise equal {bitwise}; against the "
        f"sequential packed step |d| - 2e-5 |ref| at most "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f", m xyz {m_err:.2e}")
    if (not bitwise or f_plain != f_pre or f_plain != [32, 8, 8, 8]
            or max(errs.values()) > 2e-6 or m_err > 1e-7):
        raise AssertionError("the small out-of-core check failed")


def offload_phase(dev, width, height, smi, max_dup, n_leaves=POST_LEAVES,
                  store_rows=OFFLOAD_STORE_ROWS):
    """Phase 13: out-of-core post-optimization at the JAX package's
    operating point (scripts/offload_bench3.py); returns the B1 and B2
    launches of the path, both kernels' numbers at one offload frame and
    their largest errors."""
    import resource

    import torch
    from hlod_gaussians_torch.config import PostConfig, RasterizerConfig
    from hlod_gaussians_torch.ops import rasterize_cuda
    from hlod_gaussians_torch.train import offload, post
    kernel = rasterize_cuda.blend_forward
    kernel_b2 = rasterize_cuda.blend_backward
    full = n_leaves == POST_LEAVES
    pcfg = PostConfig()
    extent = 25.0
    bg = torch.zeros(3, device=dev)
    gt = torch.full((3, height, width), 0.35, device=dev)
    log(f"[13] out-of-core post-optimization: the {n_leaves}-leaf post "
        f"bench tree in a {store_rows}-row pinned host store, the "
        f"{POST_VIEWS}-view orbit through a COLMAP model, "
        f"DeviceResidentTrainer and post_optimize_offloaded")
    small_offload_check(dev)

    # the tree, its forest and the packed rows
    d, build_s = post_bench_dhier(dev, n_leaves)
    m = d.nodes.shape[0]
    state = post.create_from_dhier(d, m, skybox_num=0, scene_radius=extent,
                                   n_exposures=1, device=dev)
    t0 = time.perf_counter()
    forest = post.rebuild_spt(state, post=pcfg)
    rebuild_s = time.perf_counter() - t0
    packed = offload.pack_store(state)
    del state
    points = d.pos[d.nodes[:, 2] == 0][::4096]
    del d
    torch.cuda.empty_cache()
    log(f"  {m} nodes (built in {build_s:.2f} s), {forest.n_spts} SPTs "
        f"(rebuild_spt {rebuild_s:.2f} s); packed rows {tuple(packed.shape)}"
        f", pinned {packed.is_pinned()}")
    if full and forest.n_spts != OFFLOAD_SPTS:
        raise AssertionError(f"{forest.n_spts} SPTs, not {OFFLOAD_SPTS}")

    # the store: every page touched, rows past the tree copies of its rows
    with open("/proc/meminfo") as f:
        mem_total = next(line for line in f if line.startswith("MemTotal"))
    d_row = packed.shape[1]
    t0 = time.perf_counter()
    data = offload.host_empty((store_rows, d_row), dev)
    pin_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for off in range(0, store_rows, m):
        k = min(m, store_rows - off)
        data[off:off + k] = packed[:k]
    fill_s = time.perf_counter() - t0
    store = offload.PackedStore(data, sh_degree=1)
    log(f"  store {store_rows} x {d_row} float32 = "
        f"{store_rows * d_row * 4 / 1e9:.2f} GB, pinned {data.is_pinned()}: "
        f"allocated in {pin_s:.2f} s, filled in {fill_s:.2f} s; host "
        f"{' '.join(mem_total.split()[1:])} MemTotal")

    # the orbit through the loaders, and its cut sequence
    views, cam_diff = loaded_orbit_views(width, height, dev, points)
    log(f"  {len(views)} views read back through load_colmap_scene: "
        f"world_view, full_proj and campos within {cam_diff:.2e} of "
        f"make_camera's")
    if cam_diff > 1e-5:
        raise AssertionError("the loaded orbit differs from make_camera's")
    cutter = offload.CachedCutter(forest, m, pcfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    masks = [cutter.cut(v.campos, v.full_proj, 1.0).gaussian_mask
             for v in views]
    ws = [int(mk.sum()) for mk in masks]
    cut_s = time.perf_counter() - t0
    budget = int(max(ws) * 1.05) // 256 * 256 + 256
    row_sets = []
    for mk in masks:
        idx, valid = offload.cut_to_indices(mk, budget)
        row_sets.append(idx[valid].cpu().numpy())
    del masks
    ws_stats = (min(ws), max(ws), int(np.mean(ws)))
    log(f"  CachedCutter at multiplier 1.0: working sets min / max / mean "
        f"{ws_stats[0]} / {ws_stats[1]} / {ws_stats[2]} ({cut_s:.2f} s for "
        f"{len(views)} cuts); budget {budget}")
    if (any(len(r) != w or w > budget for r, w in zip(row_sets, ws))
            or (full and (ws_stats != OFFLOAD_WS
                          or budget != OFFLOAD_BUDGET))):
        raise AssertionError(f"working sets {ws_stats}, budget {budget}")

    # the trainer as the bench drives it
    cfg = RasterizerConfig(backend="pallas", tile_w=32, tile_h=32,
                           max_dup=max_dup, tight_binning=True)
    torch.cuda.reset_peak_memory_stats()
    tr = offload.DeviceResidentTrainer(
        store, budget, cfg=cfg, width=width, height=height, k_max=512,
        scene_extent=extent, device=dev)
    host_ms = {"prepare": [], "apply": []}

    def timed(name, fn):
        def call(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            host_ms[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    tr.prepare = timed("prepare", tr.prepare)
    tr.apply = timed("apply", tr.apply)

    def step(i, prefetch=None):
        v = views[i % POST_VIEWS]
        before = (kernel.launches, kernel_b2.launches)
        n_host = len(host_ms["prepare"])
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        loss, _ = tr.step(
            row_sets[i % POST_VIEWS], v.world_view, v.full_proj, v.campos,
            v.tan_fovx, v.tan_fovy, gt, bg,
            prefetch_rows=(None if prefetch is None
                           else row_sets[prefetch % POST_VIEWS]))
        dispatch = (time.perf_counter() - t0) * 1e3
        b.record()
        b.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        delta = (kernel.launches - before[0], kernel_b2.launches - before[1])
        loss = float(loss)
        if (delta != (1, 1) or not np.isfinite(loss)
                or bool(tr.last_truncated)):
            raise AssertionError(f"offload step {i}: (B1, B2) launches "
                                 f"{delta}, loss {loss}, truncated "
                                 f"{bool(tr.last_truncated)}")
        return dict(ms=a.elapsed_time(b), wall=wall, dispatch=dispatch,
                    fetch=tr.last_fetch, evict=tr.last_evict, loss=loss,
                    prepare=sum(host_ms["prepare"][n_host:]))

    torch.cuda.synchronize()
    kernel.launches = kernel_b2.launches = 0
    first = step(0)
    resident = [step(0) for _ in range(OFFLOAD_RESIDENT)]
    # the same, with view 0's rows "prefetched": prepare's bookkeeping
    # overlaps the card as in the orbit laps
    resident_pf = [step(0, 0) for _ in range(OFFLOAD_RESIDENT)]
    lap1 = [step(i, i + 1) for i in range(POST_VIEWS)]
    steady = [step(i, i + 1)
              for i in range(POST_VIEWS, OFFLOAD_LAPS * POST_VIEWS)]
    n_steady = len(steady)
    apply_steady = host_ms["apply"][-n_steady:]
    tr.flush()
    trainer_launches = (kernel.launches, kernel_b2.launches)

    def pct(xs, q):
        return float(np.percentile(xs, q))

    res_ms = statistics.median(r["ms"] for r in resident)
    res_wall = statistics.median(r["wall"] for r in resident)
    pf_ms = statistics.median(r["ms"] for r in resident_pf)
    ms = [s["ms"] for s in steady]
    wall = [s["wall"] for s in steady]
    fetch = np.array([s["fetch"] for s in steady])
    evict = np.array([s["evict"] for s in steady])
    churn = (int(np.percentile(fetch, 50)), int(np.percentile(fetch, 90)),
             int(fetch.mean()))
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    dev_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  first step (full fetch of {first['fetch']} rows): "
        f"{first['wall']:.1f} ms wall, prepare {first['prepare']:.1f} ms")
    log(f"  resident (view 0, {OFFLOAD_RESIDENT} steps): median "
        f"{res_ms:.3f} ms on the card (CUDA events), {res_wall:.3f} ms wall, "
        f"prepare p50 {pct([r['prepare'] for r in resident], 50):.3f} ms; "
        f"with view 0 prefetched {pf_ms:.3f} ms, "
        f"{statistics.median(r['wall'] for r in resident_pf):.3f} ms wall")
    log(f"  lap 1 (cache filling, prefetch): p50 "
        f"{pct([s['ms'] for s in lap1], 50):.3f} ms on the card, "
        f"{pct([s['wall'] for s in lap1], 50):.3f} ms wall")
    log(f"  laps 2-3 ({n_steady} steps, prefetch): p50 / p90 / mean "
        f"{pct(ms, 50):.3f} / {pct(ms, 90):.3f} / {np.mean(ms):.3f} ms on "
        f"the card, {pct(wall, 50):.3f} / {pct(wall, 90):.3f} / "
        f"{np.mean(wall):.3f} ms wall; vs_resident {pct(ms, 50) / res_ms:.3f}"
        f" (card) {pct(wall, 50) / res_wall:.3f} (wall), against the "
        f"prefetched resident step {pct(ms, 50) / pf_ms:.3f}; step() returns "
        f"after {pct([s['dispatch'] for s in steady], 50):.3f} ms (p50) "
        f"[{smi}]")
    log(f"  host per steady step: prepare p50 / max "
        f"{pct([s['prepare'] for s in steady], 50):.3f} / "
        f"{max(s['prepare'] for s in steady):.3f} ms, apply p50 / max "
        f"{pct(apply_steady, 50):.3f} / {max(apply_steady):.3f} ms")
    log(f"  fetched rows a steady step p50 / p90 / mean {churn[0]} / "
        f"{churn[1]} / {churn[2]} (max {int(fetch.max())}), evicted p50 / "
        f"mean {int(np.percentile(evict, 50))} / {int(evict.mean())}; peak "
        f"host RSS {rss_gb:.2f} GB, peak device memory {dev_gb:.2f} GB; "
        f"losses {[round(s['loss'], 5) for s in steady[::20]]}")
    if full and churn != OFFLOAD_CHURN:
        raise AssertionError(f"churn {churn}, not {OFFLOAD_CHURN}")

    # (a) rows no working set named, the ballast included, are unchanged
    t0 = time.perf_counter()
    named = np.zeros(m, bool)
    for r in row_sets:
        named[r] = True
    as_int = lambda t: t.view(torch.int32)
    unnamed = torch.from_numpy(np.where(~named)[0])
    same = torch.equal(as_int(data.index_select(0, unnamed)),
                       as_int(packed.index_select(0, unnamed)))
    for off in range(m, store_rows, m):
        k = min(m, store_rows - off)
        same = same and torch.equal(as_int(data[off:off + k]),
                                    as_int(packed[:k]))
    trained = torch.from_numpy(row_sets[0][:1024].astype(np.int64))
    moved = not torch.equal(data.index_select(0, trained),
                            packed.index_select(0, trained))
    log(f"  after flush: the {int((~named).sum())} rows no working set "
        f"named and the {store_rows - m} ballast rows bitwise unchanged "
        f"{same}, trained rows changed {moved} ({time.perf_counter() - t0:.1f}"
        f" s to check)")
    if not (same and moved):
        raise AssertionError("the store changed outside the working sets")

    # (c) B1 and B2 at an offload frame: the last view over the slot buffer
    v = views[(OFFLOAD_LAPS * POST_VIEWS - 1) % POST_VIEWS]

    def frame():
        rows, m_rows, v_rows = offload.unpack_rows(tr.buf, 1)
        offload._compute_phase(
            rows, m_rows, v_rows, tr.store.step, tr.valid, v.world_view,
            v.full_proj, v.campos, v.tan_fovx, v.tan_fovy, gt, bg, **tr._kw)

    b1, b2, b1_err, b2_err = frame_kernels(capture_b1_inputs(frame), dev,
                                           width, height, "offload frame",
                                           smi)
    del tr, packed
    torch.cuda.empty_cache()

    # the public entry point over the loaded views
    views = [dataclasses.replace(v, image=gt) for v in views]
    kernel.launches = kernel_b2.launches = 0
    t0 = time.perf_counter()
    tr, losses = offload.post_optimize_offloaded(
        store, forest, views, budget=budget, post=pcfg, cfg=cfg,
        width=width, height=height, k_max=512, scene_extent=extent,
        n_iters=OFFLOAD_LOOP_ITERS, device=dev)
    losses = [float(x) for x in losses]
    tr.flush()
    loop_s = time.perf_counter() - t0
    loop_launches = (kernel.launches, kernel_b2.launches)
    log(f"  post_optimize_offloaded: {OFFLOAD_LOOP_ITERS} iterations in "
        f"{loop_s:.2f} s (cuts and the final flush included), losses "
        f"{[round(x, 5) for x in losses]}, last fetch {tr.last_fetch}; "
        f"(B1, B2) launches {loop_launches}")
    if (not np.isfinite(losses).all()
            or loop_launches != (OFFLOAD_LOOP_ITERS,) * 2):
        raise AssertionError("post_optimize_offloaded failed")
    del tr, store, data, forest
    torch.cuda.empty_cache()
    return dict(b1=trainer_launches[0] + loop_launches[0],
                b2=trainer_launches[1] + loop_launches[1],
                b1_frame=b1, b2_frame=b2, b1_err=b1_err, b2_err=b2_err)


def full_lod_phases(dev, width, height, bg, smi, n_leaves=LOD_LEAVES):
    """Phases 6-11 on the full-size LOD bench tree; returns the B1 and B2
    launches of each path, B1's numbers at the tau-0 stream frame and the
    largest kernel-vs-plain error."""
    import torch
    from hlod_gaussians_torch import eval as eval_mod
    from hlod_gaussians_torch import render
    from hlod_gaussians_torch.config import RasterizerConfig
    from hlod_gaussians_torch.hierarchy import cut as cut_mod
    from hlod_gaussians_torch.models import gaussians as gm
    from hlod_gaussians_torch.ops import rasterize_cuda
    from hlod_gaussians_torch.ops.lod_preprocess import lod_preprocess
    from hlod_gaussians_torch.ops.rasterize_xla import blend_forward_plain
    from hlod_gaussians_torch.utils.camera import make_camera
    from hlod_gaussians_torch.viewer import maintenance as maint
    kernel = rasterize_cuda.blend_forward
    kernel_b2 = rasterize_cuda.blend_backward
    fused = {}     # lod_preprocess launches by path
    max_err = 0.0

    # ---- 6. full-size LOD: build and round trip ---------------------------
    log(f"[6] hierarchy build on the card: {n_leaves} leaves (the LOD "
        "bench tree, SH 3), .dhier round trip")
    lstate, tree, build_s, (file_s, file_bytes) = lod_bench_tree(
        dev, n_leaves)
    m = tree.nodes.shape[0]
    if m != 2 * n_leaves - 1:
        raise AssertionError(f"{m} nodes for {n_leaves} leaves")
    lact = gm.activate(lstate)
    lod = dict(state=lstate, act=lact, width=width, height=height, bg=bg,
               cfg=RasterizerConfig(backend="pallas", tile_w=32, tile_h=32,
                                    max_dup=1 << 20, tight_binning=True))
    t0 = time.perf_counter()
    lod["pcache"] = cut_mod.build_parent_cache(
        lstate.nodes, lact.means3d, torch.max(lact.scales, dim=1).values)
    lod["itab"] = cut_mod.build_interp_table(
        dict(means3d=lact.means3d, scales=lact.scales, quats=lact.quats,
             opacities=lact.opacities, shs=lact.shs), lstate.nodes)
    torch.cuda.synchronize()
    tables_s = time.perf_counter() - t0
    log(f"  {m} nodes, height {int(tree.nodes[:, 0].max())}; build "
        f"{build_s:.2f} s on the card (kd split, merge, alignment and the "
        f"host compaction), .dhier of {file_bytes} bytes saved + loaded in "
        f"{file_s:.2f} s, parent cache "
        f"+ interp table {tables_s:.3f} s [{smi}]")

    # ---- 7. viewer stream ----------------------------------------------------
    log(f"[7] viewer stream: render_lod_stream {width}x{height}, "
        f"{STREAM_WARM} "
        f"warm-up + {STREAM_TIMED} timed frames a tau over 26 cameras")
    lod_cams = [lod_bench_camera(i, width, height, dev) for i in range(26)]
    frames = STREAM_WARM + STREAM_TIMED
    kernel.launches = kernel_b2.launches = lod_preprocess.launches = 0
    streams = {tau: stream_frames(lod, lod_cams, tau, frames, kernel)
               for tau in STREAM_TAUS}
    stream_launches, stream_b2 = kernel.launches, kernel_b2.launches
    fused["lod_stream"] = lod_preprocess.launches
    stream_ms = {}
    for tau, (st, rows, (img, n_sel, trunc)) in streams.items():
        ev = [r[0] for r in rows[STREAM_WARM:]]
        host = [r[1] for r in rows[STREAM_WARM:]]
        per_frame = [r[2] for r in rows]
        path = st["pending"][1]
        stream_ms[tau] = statistics.median(ev)
        log(f"  tau {tau:4.1f}: frame median {statistics.median(ev):.3f} ms "
            f"(CUDA events; min {min(ev):.3f}, max {max(ev):.3f}), host "
            f"wall median {statistics.median(host):.3f} ms; path "
            f"{'masked' if path == 'MASKED' else 'budgeted'}, budget "
            f"{st['budget']}, md {st['md']}, n_truncated_frames "
            f"{st.get('n_truncated_frames', 0)}; last frame n_selected "
            f"{n_sel}, truncated {trunc}; B1 launches a frame {per_frame} "
            f"[{smi}]")
        if (per_frame != [1] * frames or trunc
                or not bool(torch.isfinite(img).all())
                or tuple(img.shape) != (3, height, width)):
            raise AssertionError(f"stream tau {tau}: launches {per_frame}, "
                                 f"last frame truncated {trunc}")
    if stream_b2 != 0:
        raise AssertionError(f"{stream_b2} B2 launches while streaming")
    log(f"  lod_preprocess launches {fused['lod_stream']} (the masked "
        "frames)")
    if fused["lod_stream"] == 0:
        raise AssertionError("the tau-0 stream never took the masked path")

    # ---- 8. the plain path ---------------------------------------------------
    log("[8] the kernel path against the plain (xla) path: render_lod at "
        "tau 15, render_lod_masked at tau 3")
    kernel.launches = kernel_b2.launches = lod_preprocess.launches = 0
    last_cam = lod_cams[(frames - 1) % len(lod_cams)]
    plain_cfg = RasterizerConfig(backend="xla", tile_w=32, tile_h=32,
                                 max_dup=1 << 22)
    for tau, budget in ((15.0, streams[15.0][0]["budget"]), (3.0, None)):
        out, n_sel = lod_frame(lod, last_cam, tau, lod["cfg"], budget)
        t0 = time.perf_counter()
        p_out, p_n = lod_frame(lod, last_cam, tau, plain_cfg, budget,
                               k_max=8192)
        torch.cuda.synchronize()
        err = float((p_out.image - out.image).abs().max())
        log(f"  tau {tau:4.1f} ({'masked' if budget is None else 'budget '}"
            f"{budget or ''}) vs plain: n_selected {n_sel} vs {p_n}, "
            f"max|d image| {err:.3e}, truncated {bool(out.truncated)}, "
            f"plain truncated {bool(p_out.truncated)} "
            f"({time.perf_counter() - t0:.1f} s)")
        if (err > FRAME_ATOL or n_sel != p_n or bool(out.truncated)
                or bool(p_out.truncated)):
            raise AssertionError(f"LOD tau {tau} disagrees with the plain "
                                 "path")
        max_err = max(max_err, err)
    plain_launches, plain_b2 = kernel.launches, kernel_b2.launches
    fused["lod_vs_plain"] = lod_preprocess.launches
    log(f"  B1 launches {plain_launches}, lod_preprocess "
        f"{fused['lod_vs_plain']}")
    del out, p_out

    # ---- 9. eval: the tau sweep ---------------------------------------------
    eval_cams = lod_cams[::8][:4]
    log(f"[9] eval_views: level_is_tau, box metric, taus {EVAL_TAUS}, "
        f"{len(eval_cams)} cameras, ground truth the leaves' flat render")
    eval_cfg = RasterizerConfig(backend="pallas", tile_w=32, tile_h=32,
                                max_dup=1 << 21, tight_binning=True)
    leaf = lstate.alive & (lstate.nodes[:, gm.NODE_CHILD_COUNT] == 0)
    gts = []
    for cam in eval_cams:
        with torch.no_grad():
            out = render.render_arrays(
                lact.means3d, lact.scales, lact.quats, lact.opacities,
                lact.shs, leaf, cam.world_view, cam.full_proj, cam.campos,
                cam.tan_fovx, cam.tan_fovy, bg, sh_degree=3, width=width,
                height=height, cfg=eval_cfg)
        if bool(out.truncated):
            raise AssertionError("ground-truth render truncated")
        gts.append(torch.clamp(out.image, 0.0, 1.0))
    warned = []
    kernel.launches = kernel_b2.launches = lod_preprocess.launches = 0
    t0 = time.perf_counter()
    table = eval_mod.eval_views(
        lstate, eval_cams, gts, EVAL_TAUS, level_is_tau=True,
        boxes=(tree.box_lo, tree.box_hi, tree.max_side), budget=1 << 20,
        cfg=eval_cfg, warn=warned.append)
    eval_s = time.perf_counter() - t0
    eval_launches, eval_b2 = kernel.launches, kernel_b2.launches
    fused["eval"] = lod_preprocess.launches
    for r in table:
        log(f"  tau {r.level:4.1f}: PSNR {r.psnr:.3f}  SSIM {r.ssim:.4f}  "
            f"GMSD {r.gmsd:.5f}  LPIPS {r.lpips}  mean rendered "
            f"{r.mean_rendered:.1f}")
    log(f"  {eval_s:.1f} s for {len(EVAL_TAUS) * len(eval_cams)} renders; "
        f"B1 launches {eval_launches}; warnings {warned}")
    # on the box metric a leaf projects 6 max_scale / distance, about 0.01
    # here, above the tau-3 threshold (0.005): taus 0 and 3 may both select
    # every leaf, so the count falls with tau but not at every step
    rendered = [r.mean_rendered for r in table]
    if (table[0].psnr < table[-1].psnr or rendered[0] <= rendered[-1]
            or any(a < b for a, b in zip(rendered, rendered[1:]))
            or len(warned) != 1 or "LPIPS" not in warned[0]):
        raise AssertionError("the tau sweep is not monotone, or a view was "
                             "truncated or capped")
    del gts

    # ---- 10. viewer maintenance ---------------------------------------------
    log(f"[10] viewer maintenance at tau 3: {MAINT_FRAMES} frames of "
        f"incremental_cut_step, the camera walking in for {MAINT_MOVING}, "
        "then still; render_lod(cut_mask) and ActiveRowCache each frame")
    nodes, alive = lstate.nodes, lstate.alive
    max_scale = torch.max(lact.scales, dim=1).values
    target = lod_target(3.0, lod_cams[0], width)
    height_of_tree = int(tree.nodes[:, 0].max())
    cache = maint.ActiveRowCache(
        {k: getattr(lact, k).cpu().numpy() for k in
         ("means3d", "scales", "quats", "opacities", "shs")},
        budget=1 << 19, device=dev)
    active = torch.as_tensor(maint.initial_cut(nodes, alive), device=dev)
    moves, sizes = [], []
    kernel.launches = kernel_b2.launches = lod_preprocess.launches = 0
    for f in range(MAINT_FRAMES):
        z = 0.5 * min(f, MAINT_MOVING - 1)
        cam = make_camera(np.eye(3), np.array([0.0, 0.0, -z]), 1.2, 0.8, width,
                     height, device=dev)
        active, n_s, n_c = maint.incremental_cut_step(
            nodes, lact.means3d, max_scale, alive, active, cam.campos,
            target)
        if not bool(cut_mod.is_hierarchy_cut(nodes, active, alive)):
            raise AssertionError(f"maintenance frame {f}: not a proper cut")
        with torch.no_grad():
            out, n_sel = render.render_lod(
                lact.means3d, lact.scales, lact.quats, lact.opacities,
                lact.shs, nodes, alive, cam.world_view, cam.full_proj,
                cam.campos, cam.tan_fovx, cam.tan_fovy, bg, target, None,
                active, lod["pcache"], None, lod["itab"], sh_degree=3,
                width=width, height=height, budget=cache.budget,
                cfg=lod["cfg"], use_frustum=False)
        fetched, evicted = cache.update(active)
        moves.append((int(n_s), int(n_c), fetched, evicted))
        sizes.append(int(n_sel))
        if bool(out.truncated) or int(n_sel) > cache.budget:
            raise AssertionError(f"maintenance frame {f}: truncated or over "
                                 "the budget")
    maint_launches, maint_b2 = kernel.launches, kernel_b2.launches
    fused["maintenance"] = lod_preprocess.launches
    if fused["eval"] or fused["maintenance"]:
        raise AssertionError(f"the budgeted path launched lod_preprocess: "
                             f"{fused}")
    rule = cut_mod.expand_to_size_dynamic(
        nodes, lact.means3d, max_scale, alive, cam.campos,
        cam.world_view[:3, 2], target, use_frustum=False)
    top_down = top_down_cut(nodes, rule.size, target)
    converged = bool(torch.equal(active, top_down))
    log("  frames (split, collapse, fetched, evicted): "
        + " ".join(f"{a}/{b}/{c}/{d}" for a, b, c, d in moves))
    log(f"  cut sizes {sizes}; tree height {height_of_tree}; after "
        f"{MAINT_FRAMES - MAINT_MOVING} still frames equal to the size "
        f"rule's cut read top-down: {converged}; the per-node rule "
        f"(expand_to_size_dynamic) selects {int(rule.render_mask.sum())} "
        f"nodes, {int((rule.render_mask != active).sum())} of them "
        "different, where a child projects larger than its parent; B1 "
        f"launches {maint_launches}")
    if (not converged or moves[-1][:2] != (0, 0)
            or MAINT_FRAMES - MAINT_MOVING <= height_of_tree
            or maint_launches != MAINT_FRAMES):
        raise AssertionError("maintenance did not reach the size rule's cut")
    del cache

    # ---- 11. kernel B1 at the tau-0 stream frame ---------------------------
    log("[11] kernel B1 at the tau-0 stream frame (camera 0)")
    st0 = streams[0.0][0]
    st_copy = dict(st0, md=dict(st0["md"]))
    st_copy.pop("pending")
    cam = lod_cams[0]

    def tau0_frame():
        with torch.no_grad():
            render.render_lod_stream(
                lact.means3d, lact.scales, lact.quats, lact.opacities,
                lact.shs, nodes, alive, cam.world_view, cam.full_proj,
                cam.campos, cam.tan_fovx, cam.tan_fovy, bg,
                lod_target(0.0, cam, width), st_copy, pcache=lod["pcache"],
                interp_table=lod["itab"], sh_degree=3, width=width,
                height=height, cfg=lod["cfg"], k_max=512, use_frustum=False)

    lod_args, lod_opts = capture_b1_inputs(tau0_frame)
    got = kernel(*lod_args, **lod_opts)
    torch.cuda.synchronize()
    ref = blend_forward_plain(*lod_args, **lod_opts)
    max_err = max(max_err, compare("tau-0 stream frame", got, ref,
                                   FRAME_ATOL, FRAME_NC_SHARE))
    del got, ref
    lod_wrap_ms = cuda_time_ms(lambda: kernel(*lod_args, **lod_opts), 20,
                               warmup=3)
    lod_launch_ms = bare_launch_ms(lod_args, lod_opts)
    lod_plain_ms = cuda_time_ms(lambda: blend_forward_plain(
        *lod_args, **lod_opts), 2)
    feats_l, _, _, counts_l = lod_args
    l_eval, l_applied, l_cand, l_read = work_of_frame(
        *lod_args, width, height, 32, 32, lod_opts["t_eps"],
        lod_opts["alpha_min"], use_lod=True)
    l_entries = int(counts_l.sum())
    l_bytes, l_nread, l_rows = frame_bytes(lod_args, l_read, width, height,
                                           4 * 4 + 4 + 4)
    l_ops = OPS_EVAL * l_eval + OPS_APPLY * l_applied + OPS_LOD * l_cand
    lod_bound_ms, lod_bound_by, lod_parts = bound(l_bytes, l_ops)
    log(f"  {feats_l.shape[0]} rows, {l_entries} entries ({l_nread} read, "
        f"naming {l_rows} rows), {l_eval} evaluated, "
        f"{l_cand} candidate and {l_applied} applied (entry, pixel) pairs; "
        f"ops {OPS_EVAL}/eval + {OPS_APPLY}/applied + {OPS_LOD}/candidate "
        f"(LOD) = {l_ops:.4e} f32 ops, {l_bytes} bytes")
    log(f"  blend_forward LOD: launch {lod_launch_ms:.4f} ms, wrapper "
        f"{lod_wrap_ms:.4f} ms, plain version {lod_plain_ms:.2f} ms, bound "
        f"{lod_bound_ms:.4f} ms ({lod_bound_by}; {lod_parts}) [{smi}]")
    return dict(
        max_err=max_err,
        b1={"lod_stream": stream_launches, "lod_vs_plain": plain_launches,
            "eval": eval_launches, "maintenance": maint_launches},
        b2={"lod_stream": stream_b2, "lod_vs_plain": plain_b2,
            "eval": eval_b2, "maintenance": maint_b2},
        lod_preprocess=fused,
        tau0={"ms": lod_launch_ms, "wrapper_ms": lod_wrap_ms,
              "plain_ms": lod_plain_ms, "bound_ms": lod_bound_ms,
              "bound_by": lod_bound_by})


def lod_preprocess_phase(dev, smi):
    """Phase [11b]: kernel lod_preprocess at the tau-0 cell's size against
    its plain version (the chain as separate PyTorch kernels) on the card:
    valid and radius equal but for a share of boundary rows, the valid
    rows' feature rows to rounding; the kernel's time (CUDA events over 20
    back-to-back launches), the plain chain's, and the byte bound."""
    import torch
    from hlod_gaussians_torch.hierarchy import cut as cut_mod
    from hlod_gaussians_torch.models.gaussians import NODE_PARENT
    from hlod_gaussians_torch.ops import lod_preprocess as lp
    from hlod_gaussians_torch.utils.camera import make_camera
    n = LODPRE_LEAVES
    c = 2 * n - 1
    log(f"[11b] kernel lod_preprocess at the tau-0 cell's size: {c} rows "
        f"at SH 3, about {LODPRE_DRAWN} drawn")
    g = torch.Generator(device=dev).manual_seed(17)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    pos = randn(c, 3) * 10.0
    pos[:, 2] += 30.0
    sh = randn(c, 16, 3) * 0.05
    sh[:, 0] *= 6.0
    params = dict(means3d=pos, scales=torch.exp(randn(c, 3) * 0.3 - 4.24),
                  quats=randn(c, 4),
                  opacities=torch.rand((c,), generator=g, device=dev) * 0.6
                  + 0.3, shs=sh)
    nodes = torch.zeros((c, 6), dtype=torch.int32, device=dev)
    nodes[:, NODE_PARENT] = (torch.arange(c, device=dev) - 1) // 2
    table = cut_mod.build_interp_table(params, nodes)
    del params, pos, sh
    leaf = torch.arange(c, device=dev) >= n - 1
    mask = leaf & (torch.rand((c,), generator=g, device=dev)
                   < LODPRE_DRAWN / n)
    ts = torch.rand((c,), generator=g, device=dev)
    kids = torch.full((c,), 2, dtype=torch.int32, device=dev)
    alive = torch.ones((c,), dtype=torch.bool, device=dev)
    cam = make_camera(np.eye(3), np.zeros(3), 1.2, 0.8, 1920, 1080,
                      device=dev)
    args = (table, mask, ts, kids, alive, cam.world_view, cam.full_proj,
            cam.campos, cam.tan_fovx, cam.tan_fovy)
    kw = dict(width=1920, height=1080, sh_degree=3)
    before = lp.lod_preprocess.launches
    got = lp.lod_preprocess(*args, **kw)
    torch.cuda.synchronize()
    if lp.lod_preprocess.launches != before + 1:
        raise AssertionError("lod_preprocess did not launch")
    ref = lp.lod_preprocess_plain(*args, **kw)
    torch.cuda.synchronize()
    drawn = int(mask.sum())
    both = got.valid & ref.valid
    valid_diff = int((got.valid != ref.valid).sum())
    radius_diff = int((got.radius != ref.radius).sum())
    err = float(((got.feats - ref.feats)[both].abs()
                 / ref.feats[both].abs().clamp_min(1.0)).max())
    log(f"  {drawn} drawn, {int(ref.valid.sum())} valid; rows whose valid "
        f"differs {valid_diff}, radius {radius_diff}; largest feature "
        f"error on valid rows {err:.3e} (relative above 1)")
    if (valid_diff + radius_diff > 1e-5 * drawn or err > 2e-5
            or not bool(torch.isfinite(got.feats).all())):
        raise AssertionError("lod_preprocess disagrees with its plain "
                             "version")
    del got, ref

    def launches(reps):
        for _ in range(reps):
            lp.lod_preprocess(*args, **kw)

    reps = 20
    ms = cuda_time_ms(lambda: launches(reps), 3, warmup=1) / reps
    plain_ms = cuda_time_ms(lambda: lp.lod_preprocess_plain(*args, **kw), 3)
    m = c
    n_bytes = (drawn * table.feats.shape[1] * 4 + c * (1 + 4) + drawn * 4
               + m * (48 + 4 + 4 + 1 + 8 + 4))
    bound_ms, bound_by, parts = bound(n_bytes, OPS_LODPRE * drawn)
    log(f"  lod_preprocess {ms:.4f} ms ({ms / bound_ms:.2f}x its bound), "
        f"plain chain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}; {parts}; {n_bytes} bytes, "
        f"{OPS_LODPRE} ops a drawn row) [{smi}]")
    del table
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_rel_err=err, valid_diff=valid_diff,
                radius_diff=radius_diff,
                launches=lp.lod_preprocess.launches - before)


def sparse_adam_phase(dev, smi):
    """Phase [11c]: kernel sparse_adam against the plain chain on the card
    at the training cells' states, f_dc's and f_rest's gradients views of
    one tensor as in a step: p, m and v bit for bit; the kernel's
    time (CUDA events over 20 back-to-back launches), the chain's, the
    device kernels each launches (the profiler) and the byte bound: 28
    bytes a float of a row in the mask, 24 of one outside it (g is not
    read there). The bound as if every row were in the mask is kept as a
    note."""
    import torch
    from hlod_gaussians_torch import optim
    from hlod_gaussians_torch.config import OptimizationConfig
    launches = optim.sparse_adam_cuda.launches
    out = {}
    for cell, (rows, share) in ADAM_CELLS.items():
        log(f"[11c] kernel sparse_adam at the {cell} cell's state: {rows} "
            f"rows, {share:.0%} in the mask")
        g = torch.Generator(device=dev).manual_seed(rows)

        def draw(shape, scale):
            return torch.randn(shape, generator=g, device=dev) * scale

        shapes = dict(xyz=(rows, 3), f_dc=(rows, 1, 3), f_rest=(rows, 15, 3),
                      log_scale=(rows, 3), quat=(rows, 4),
                      opacity_logit=(rows, 1), exposure=(1, 3, 4))
        params = {k: draw(s, 1.0) for k, s in shapes.items()}
        grads = {k: draw(s, 1e-3) for k, s in shapes.items()}
        # as autograd hands them over: rows of one [C, 16, 3] tensor
        sh = draw((rows, 16, 3), 1e-3)
        grads["f_dc"], grads["f_rest"] = sh[:, :1], sh[:, 1:]
        state = optim.AdamState(
            m={k: draw(s, 1e-3) for k, s in shapes.items()},
            v={k: draw(s, 1e-6).abs() for k, s in shapes.items()}, step=99)
        visible = torch.rand((rows,), generator=g, device=dev) < share
        lrs = optim.param_lrs(OptimizationConfig(), 99, 5.0)
        args = (params, grads, state, lrs, visible)
        got = optim.sparse_adam_update(*args)
        ref = optim.sparse_adam_plain(*args)
        torch.cuda.synchronize()
        bits = lambda t: t.view(torch.int32)
        err = 0.0
        for k in shapes:
            for part, a, b in (("p", got[0], ref[0]), ("m", got[1].m,
                                ref[1].m), ("v", got[1].v, ref[1].v)):
                err = max(err, float((a[k] - b[k]).abs().max()))
                if not torch.equal(bits(a[k]), bits(b[k])):
                    raise AssertionError(f"sparse_adam {part} {k} differs "
                                         f"from the plain chain")
        del got, ref
        reps = 20

        def kernel_runs():
            for _ in range(reps):
                optim.sparse_adam_update(*args)

        ms = cuda_time_ms(kernel_runs, 3, warmup=1) / reps
        plain_ms = cuda_time_ms(lambda: optim.sparse_adam_plain(*args), 3)
        counts = {}
        for name, fn in (("kernel", optim.sparse_adam_update),
                         ("plain", optim.sparse_adam_plain)):
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                fn(*args)
                torch.cuda.synchronize()
            counts[name] = sum(
                1 for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
        n_in = int(visible.sum())
        f = ADAM_ROW_FLOATS
        n_bytes = n_in * (28 * f + 1) + (rows - n_in) * (24 * f + 1)
        bound_ms, bound_by, parts = bound(n_bytes, OPS_ADAM * f * n_in)
        every_row_ms = bound(rows * (28 * f + 1), OPS_ADAM * f * n_in)[0]
        log(f"  sparse_adam {ms:.4f} ms ({ms / bound_ms:.2f}x its bound), "
            f"plain chain {plain_ms:.3f} ms, device kernels a call "
            f"{counts['kernel']} / {counts['plain']}, max abs err {err}; "
            f"bound {bound_ms:.4f} ms ({bound_by}; {parts}; {n_bytes} "
            f"bytes; {every_row_ms:.4f} ms were every row in the mask) "
            f"[{smi}]")
        out[cell] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, every_row_bound_ms=every_row_ms,
                         max_abs_err=err, kernels=counts["kernel"],
                         plain_kernels=counts["plain"])
        del args, params, grads, state, visible
        torch.cuda.empty_cache()
    out["launches"] = optim.sparse_adam_cuda.launches - launches
    return out


def sparse_adam_entry(adr, launches_by_path):
    """The kernel table's line for sparse_adam: the paths' launches and
    [11c]'s own, its numbers at both training cells' states."""
    return {"name": "sparse_adam", "route": "cuda",
            "source": "hlod_gaussians_torch/csrc/sparse_adam.cu",
            "replaces": None,
            "launches": sum(launches_by_path.values()) + adr["launches"],
            "launches_by_path": dict(launches_by_path,
                                     kernel_check=adr["launches"]),
            "max_abs_err": max(adr[c]["max_abs_err"] for c in ADAM_CELLS),
            "ms": adr["train"]["ms"],
            "plain_ms": adr["train"]["plain_ms"],
            "bound_ms": adr["train"]["bound_ms"],
            "bound_by": adr["train"]["bound_by"], "library_ms": None,
            "post_state": adr["post"]}


def train_preprocess_phase(dev, smi):
    """Phase [11d]: the train_preprocess kernels against the plain chain
    and its autograd gradient on the card at the training cells' states
    (parameters drawn from a seed, the 1080p bench camera, a gradient of
    the feature rows on the rows in the mask): valid and radius equal but
    for a share of boundary rows, the feature rows of the rows valid in
    both to 2e-5, every leaf's gradient gap (the benchmark's grad_gap) to
    1e-4; each kernel's time (CUDA events over 20 back-to-back launches)
    beside its byte bound, the plain chain's forward and backward times
    and its device kernels (the profiler)."""
    import torch
    from hlod_gaussians_torch.ops import train_preprocess as tp
    from hlod_gaussians_torch.utils.camera import make_camera
    fwd0 = tp.train_preprocess_forward.launches
    bwd0 = tp.train_preprocess_backward.launches
    cam = make_camera(np.eye(3), np.zeros(3), 1.2, 0.8, 1920, 1080,
                      device=dev)
    out = {}
    for cell, (rows, share, deg, offset) in TRAINPRE_CELLS.items():
        log(f"[11d] kernels train_preprocess at the {cell} cell's state: "
            f"{rows} rows at SH {deg} of SH 3 stored, {share:.0%} in the "
            f"mask, offset {offset}")
        g = torch.Generator(device=dev).manual_seed(rows)

        def randn(*shape):
            return torch.randn(shape, generator=g, device=dev)

        xyz = randn(rows, 3) * 10.0
        xyz[:, 2] += 30.0
        p = [xyz, randn(rows, 3) * 0.3 - 4.24, randn(rows, 4),
             randn(rows, 1) * 1.5, randn(rows, 1, 3) * 0.3,
             randn(rows, 15, 3) * 0.05]
        mask = torch.rand((rows,), generator=g, device=dev) < share
        xy = torch.zeros((rows, 2), device=dev) if offset else None
        g_feats = randn(rows, 12) * 1e-3 * mask[:, None]
        args = (mask, cam.world_view, cam.full_proj, cam.campos,
                cam.tan_fovx, cam.tan_fovy)
        kw = dict(width=1920, height=1080, sh_degree=deg, dilation=0.3,
                  near=0.2, big_limit=float("inf"), antialiasing=False,
                  alpha_min=1.0 / 255.0)

        def fwd_bwd(fn):
            leaves = [t.detach().requires_grad_(True) for t in p]
            xl = None if xy is None else xy.detach().requires_grad_(True)
            o = fn(*leaves, *args, xl, **kw)
            wrt = leaves + ([] if xl is None else [xl])
            return o, torch.autograd.grad(o.feats, wrt, g_feats)

        got, got_g = fwd_bwd(tp.train_preprocess)
        ref, ref_g = fwd_bwd(tp.train_preprocess_plain)
        torch.cuda.synchronize()
        n_in = int(mask.sum())
        both = got.valid & ref.valid
        valid_diff = int((got.valid != ref.valid).sum())
        radius_diff = int((got.radius != ref.radius).sum())
        err = float(((got.feats.detach() - ref.feats.detach())[both].abs()
                     / ref.feats.detach()[both].abs().clamp_min(1.0)).max())
        norms = [float(r.norm()) for r in ref_g]
        med = statistics.median(norms)
        gap = max(float((a - b).norm()) / max(nb, med, 1e-30)
                  for a, b, nb in zip(got_g, ref_g, norms))
        log(f"  {n_in} in the mask, {int(ref.valid.sum())} valid; rows whose "
            f"valid differs {valid_diff}, radius {radius_diff}; largest "
            f"feature error on valid rows {err:.3e} (relative above 1); "
            f"largest leaf gradient gap {gap:.3e}")
        if (valid_diff + radius_diff > 1e-5 * n_in or err > 2e-5
                or gap > 1e-4 or not bool(torch.isfinite(got.feats).all())):
            raise AssertionError("train_preprocess disagrees with the plain "
                                 "chain")
        del got, ref, got_g, ref_g

        pc = [t.contiguous() for t in p]
        camt = (*(t.contiguous() for t in args[1:4]), cam.tan_fovx,
                cam.tan_fovy)
        reps = 20

        def forwards():
            for _ in range(reps):
                tp.train_preprocess_forward(pc, mask, xy, camt, kw)

        def backwards():
            for _ in range(reps):
                tp.train_preprocess_backward(pc, mask, xy, camt, kw,
                                             g_feats)

        fwd_ms = cuda_time_ms(forwards, 3, warmup=1) / reps
        bwd_ms = cuda_time_ms(backwards, 3, warmup=1) / reps
        leaves = [t.detach().requires_grad_(True) for t in p]
        xl = None if xy is None else xy.detach().requires_grad_(True)
        wrt = leaves + ([] if xl is None else [xl])
        plain_fwd_ms = cuda_time_ms(
            lambda: tp.train_preprocess_plain(*leaves, *args, xl, **kw), 3)
        plain_ms = cuda_time_ms(lambda: fwd_bwd(tp.train_preprocess_plain), 3)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fwd_bwd(tp.train_preprocess_plain)
            torch.cuda.synchronize()
        plain_kernels = sum(1 for e in prof.events() if e.device_type
                            == torch.autograd.DeviceType.CUDA)
        del leaves, xl, wrt
        # bytes: a row in the mask reads its parameters (14 floats and the
        # degree's f_rest floats), every row its mask byte and, where given,
        # its offset (forward); the forward writes 69 bytes a row, the
        # backward reads the gradient row in the mask (48 bytes; x and y
        # outside it where the offset is given) and writes every gradient
        # row (14 + 45 floats, the offset's 8 bytes)
        par = 4 * (14 + 3 * ((deg + 1) ** 2 - 1))
        off = 8 if offset else 0
        fwd_bytes = n_in * par + rows * (1 + off + 69)
        bwd_bytes = (n_in * (par + 48) + (rows - n_in) * (16 if offset
                                                           else 0)
                     + rows * (1 + 4 * 59 + off))
        f_bound, f_by, f_parts = bound(fwd_bytes, OPS_TRAINPRE[0] * n_in)
        b_bound, b_by, b_parts = bound(bwd_bytes, OPS_TRAINPRE[1] * n_in)
        log(f"  forward {fwd_ms:.4f} ms ({fwd_ms / f_bound:.2f}x its bound "
            f"{f_bound:.4f} ms, {f_by}; {f_parts}; {fwd_bytes} bytes), "
            f"backward {bwd_ms:.4f} ms ({bwd_ms / b_bound:.2f}x its bound "
            f"{b_bound:.4f} ms, {b_by}; {b_parts}; {bwd_bytes} bytes); "
            f"plain chain forward {plain_fwd_ms:.3f} ms, forward + backward "
            f"{plain_ms:.3f} ms, {plain_kernels} device kernels [{smi}]")
        out[cell] = dict(fwd_ms=fwd_ms, bwd_ms=bwd_ms, fwd_bound_ms=f_bound,
                         bwd_bound_ms=b_bound, bound_by=f_by,
                         plain_fwd_ms=plain_fwd_ms, plain_ms=plain_ms,
                         plain_kernels=plain_kernels, max_rel_err=err,
                         grad_gap=gap, valid_diff=valid_diff,
                         radius_diff=radius_diff)
        del p, pc, mask, xy, g_feats, xyz
        torch.cuda.empty_cache()
    out["launches"] = tp.train_preprocess_forward.launches - fwd0
    out["bwd_launches"] = tp.train_preprocess_backward.launches - bwd0
    return out


def train_preprocess_entry(tpr, launches_by_path):
    """The kernel table's line for train_preprocess (forward and backward,
    one launch each a training step): the forward's launches by path and
    [11d]'s own, its numbers at both training cells' states."""
    return {"name": "train_preprocess", "route": "cuda",
            "source": "hlod_gaussians_torch/csrc/train_preprocess.cu",
            "replaces": None,
            "launches": sum(launches_by_path.values()) + tpr["launches"],
            "launches_by_path": dict(launches_by_path,
                                     kernel_check=tpr["launches"]),
            "max_rel_err": max(tpr[c]["max_rel_err"]
                               for c in TRAINPRE_CELLS),
            "grad_gap": max(tpr[c]["grad_gap"] for c in TRAINPRE_CELLS),
            "ms": tpr["train"]["fwd_ms"] + tpr["train"]["bwd_ms"],
            "plain_ms": tpr["train"]["plain_ms"],
            "bound_ms": (tpr["train"]["fwd_bound_ms"]
                         + tpr["train"]["bwd_bound_ms"]),
            "bound_by": tpr["train"]["bound_by"], "library_ms": None,
            "train_state": tpr["train"], "post_state": tpr["post"]}


def lod_preprocess_entry(lpr, launches_by_path):
    """The kernel table's line for lod_preprocess: the paths' launches and
    [11b]'s own (its check, warm-up and timed launches)."""
    return {"name": "lod_preprocess", "route": "cuda",
            "source": "hlod_gaussians_torch/csrc/lod_preprocess.cu",
            "replaces": None,
            "launches": sum(launches_by_path.values()) + lpr["launches"],
            "launches_by_path": dict(launches_by_path,
                                     kernel_check=lpr["launches"]),
            "max_rel_err": lpr["max_rel_err"], "ms": lpr["ms"],
            "plain_ms": lpr["plain_ms"], "bound_ms": lpr["bound_ms"],
            "bound_by": lpr["bound_by"], "library_ms": None}


def structured_colors(pts):
    """Multi-band spatial colour field (scripts/lod_fidelity_probe.py
    :26-44): a coarse hue drift plus mid and fine bands of periods 1.4 /
    0.4 / 0.11 / 0.04 world units, so that merging nodes past a few pixels
    of granularity blurs them."""
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    two_pi = 2.0 * np.pi
    r = np.stack([
        0.30 * np.sin(two_pi * x / 1.4) + 0.18 * np.sin(two_pi * (y + z) / 0.4)
        + 0.12 * np.sin(two_pi * x / 0.11) + 0.10 * np.sin(two_pi * y / 0.04),
        0.30 * np.cos(two_pi * y / 1.4) + 0.18 * np.sin(two_pi * (x - z) / 0.4)
        + 0.12 * np.sin(two_pi * z / 0.11) + 0.10 * np.sin(two_pi * x / 0.04),
        0.30 * np.sin(two_pi * z / 1.4) + 0.18 * np.cos(two_pi * (x + y) / 0.4)
        + 0.12 * np.sin(two_pi * y / 0.11) + 0.10 * np.sin(two_pi * z / 0.04),
    ], axis=-1)
    return np.clip(0.5 + 0.45 * r / 0.7, 0.02, 0.98).astype(np.float32)


def pipeline_cameras(width, dev, centers=PIPE_CENTERS):
    """The JAX pipeline run's cameras (tpu_pipeline_scale3.py:76-101): a
    ring of PIPE["ring"] around each shell center at radius 1.1, 3.5 in
    front, looking at it; then 4 global orbit views of radius 3.5. fov 1.0,
    square frames."""
    from hlod_gaussians_torch.utils.camera import make_camera

    def cam_at(pos, look):
        fwd = look - pos
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        up2 = np.cross(fwd, right)
        rwc = np.stack([right, up2, fwd], axis=0)
        return make_camera(rwc.T, -rwc @ pos, 1.0, 1.0, width, width,
                           device=dev)

    cams = []
    for c in np.asarray(centers, np.float64):
        for k in range(PIPE["ring"]):
            ang = 2 * np.pi * (k + 0.5) / PIPE["ring"]
            pos = c + np.array([1.1 * np.cos(ang), 1.1 * np.sin(ang), -3.5],
                               np.float32)
            cams.append(cam_at(pos.astype(np.float64), c))
    for k in range(4):
        ang = 2 * np.pi * k / 4
        pos = np.array([3.5 * np.cos(ang), 3.5 * np.sin(ang), -3.0])
        cams.append(cam_at(pos, np.array([0.0, 0.0, 5.0])))
    return cams


class SceneCamera:
    """A scene camera carrying its ready view; R and T place its center for
    the chunker (the JAX run's FakeInfo)."""

    def __init__(self, v):
        self.v = v
        self.R = np.eye(3)
        self.T = -v.campos.cpu().numpy().astype(np.float64)


def pipeline_scene(dev, per, centers=PIPE_CENTERS):
    """Ground truth: spherical shells of `per` points around `centers` (the
    3x3 grid of PIPE_CENTERS by default; default_rng(7)), structured
    colours, rendered at every camera by the port (SH 1, opacity 0.92,
    16x16 tiles, max_dup 2^23, none truncated). Returns (points, colours,
    views with images and exposure slots)."""
    import torch
    from hlod_gaussians_torch import render
    from hlod_gaussians_torch.config import RasterizerConfig
    from hlod_gaussians_torch.models import gaussians as gm
    rng = np.random.default_rng(7)
    parts = []
    for c in centers:
        d = rng.normal(size=(per, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True).clip(1e-9)
        r = 0.7 + rng.normal(0, 0.01, (per, 1))
        parts.append((c + d * r).astype(np.float32))
    pts = np.concatenate(parts)
    cols = structured_colors(pts)
    cap = 1 << int(np.ceil(np.log2(len(pts))))
    gt = gm.create_from_points(pts, cols, capacity=cap, sh_degree=1,
                               opacity_init=0.92, device=dev)
    act = gm.activate(gt)
    cfg = RasterizerConfig(backend="pallas", tile_w=16, tile_h=16,
                           max_dup=PIPE["gt_max_dup"], tight_binning=True)
    views = []
    for i, cam in enumerate(pipeline_cameras(PIPE["width"], dev, centers)):
        with torch.no_grad():
            out = render.render_arrays(
                act.means3d, act.scales, act.quats, act.opacities, act.shs,
                act.valid, cam.world_view, cam.full_proj, cam.campos,
                cam.tan_fovx, cam.tan_fovy, torch.zeros(3, device=dev),
                sh_degree=1, width=cam.width, height=cam.height, cfg=cfg,
                k_max=1024)
        if bool(out.truncated):
            raise AssertionError(f"ground-truth render {i} truncated")
        views.append(dataclasses.replace(cam, image=out.image,
                                         exposure_idx=i))
    return pts, cols, views


class RssSampler:
    """The process's resident set (VmRSS of /proc/self/status) read every
    `every` seconds on a thread while the block runs: its value at the
    start and the largest reading (GB)."""

    def __init__(self, every=0.05):
        import threading
        self.every, self.start, self.peak = every, 0.0, 0.0
        self.done = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)

    @staticmethod
    def read():
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1e6
        raise RuntimeError("no VmRSS in /proc/self/status")

    def _run(self):
        while not self.done.wait(self.every):
            self.peak = max(self.peak, self.read())

    def __enter__(self):
        self.start = self.peak = self.read()
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.done.set()
        self.thread.join()
        self.peak = max(self.peak, self.read())


def state_psnr(g, views, cfg):
    """Mean PSNR of the Gaussians `g` rendered at `views` (black
    background) against their images."""
    import torch
    from hlod_gaussians_torch import render
    from hlod_gaussians_torch.models import gaussians as gm
    from hlod_gaussians_torch.ops.ssim import psnr
    act = gm.activate(g)
    out = []
    with torch.no_grad():
        for v in views:
            r = render.render_arrays(
                act.means3d, act.scales, act.quats, act.opacities, act.shs,
                act.valid, v.world_view, v.full_proj, v.campos, v.tan_fovx,
                v.tan_fovy, torch.zeros(3, device=v.image.device),
                sh_degree=1, width=v.width, height=v.height, cfg=cfg,
                k_max=1024)
            if bool(r.truncated):
                raise AssertionError("a scaffold render truncated")
            out.append(float(psnr(r.image, v.image)))
    return statistics.mean(out)


def pipeline_settings(coarse_iters, chunk_iters, post_iters, post_densify):
    """run_pipeline's settings at the pipeline point (PIPE) for the given
    step counts: (PipelineConfig, OptimizationConfig, PostConfig,
    ModelConfig, RasterizerConfig)."""
    from hlod_gaussians_torch.config import (ModelConfig, OptimizationConfig,
                                             PostConfig, RasterizerConfig)
    from hlod_gaussians_torch.pipeline import full_train
    pcfg = full_train.PipelineConfig(
        coarse_iters=coarse_iters, chunk_iters=chunk_iters,
        post_iters=post_iters, skybox_num=1024,
        coarse_capacity=PIPE["coarse_capacity"],
        chunk_capacity=PIPE["chunk_capacity"], k_max=1024, mh_walk=True,
        densification_interval=10_000, densify_from_iter=10_000,
        opacity_reset_interval=100_000,
        post_densify_interval=post_densify, chunk_size=2.9,
        chunk_point_padding=0.15)
    opt = OptimizationConfig(iterations=1500, densify_until_iter=0,
                             densify_grad_threshold=1e8)
    pconf = PostConfig(spt_root_volume=1e-3, min_spt_size=64,
                       lambda_opacity=0.0, grow_fraction=0.005,
                       max_sh_degree=1)
    cfg = RasterizerConfig(backend="pallas", tile_w=16, tile_h=16,
                           max_dup=PIPE["max_dup"], tight_binning=True)
    return pcfg, opt, pconf, ModelConfig(sh_degree=1), cfg


def pipeline_phase(dev, smi, per=None):
    """Phase 14: pipeline.full_train.run_pipeline at the JAX package's
    pipeline operating point (PIPE); returns the B1 and B2 launches of the
    pipeline path, both kernels' numbers at a chunk-training frame and
    their largest errors against the plain versions."""
    import tempfile

    import torch
    from hlod_gaussians_torch import eval as eval_mod
    from hlod_gaussians_torch.config import RasterizerConfig
    from hlod_gaussians_torch.data import dhier as dhier_io
    from hlod_gaussians_torch.data.scene import SceneInfo
    from hlod_gaussians_torch.hierarchy import filter as flt
    from hlod_gaussians_torch.hierarchy.cut import sanity_check_hierarchy
    from hlod_gaussians_torch.models.gaussians import (NODE_CHILD_COUNT,
                                                       NODE_DEPTH)
    from hlod_gaussians_torch.ops import knn as knn_ops
    from hlod_gaussians_torch.ops import rasterize_cuda
    from hlod_gaussians_torch.pipeline import chunking, full_train
    from hlod_gaussians_torch.train import flat, post
    kernel = rasterize_cuda.blend_forward
    kernel_b2 = rasterize_cuda.blend_backward
    per = per or PIPE["per"]
    width = PIPE["width"]

    log(f"[14] pipeline: run_pipeline at the JAX package's pipeline point "
        f"(scripts/tpu_pipeline_scale3.py): 9 shells x {per} points, "
        f"{width}x{width}, steps coarse / chunk / post "
        f"{PIPE['coarse_iters']} / {PIPE['chunk_iters']} / "
        f"{PIPE['post_iters']} (the JAX run's {PIPE_JAX['iters']}), an MCMC "
        f"round every {PIPE['post_densify']}")
    t0 = time.perf_counter()
    pts, cols, views = pipeline_scene(dev, per)
    torch.cuda.empty_cache()
    n_ring = len(PIPE_CENTERS) * PIPE["ring"]
    train_views = [v for i, v in enumerate(views[:n_ring]) if i % 3 != 0]
    test_views = [v for i, v in enumerate(views[:n_ring]) if i % 3 == 0]
    log(f"  scene: {len(pts)} ground-truth leaves, {len(views)} views "
        f"rendered ({len(train_views)} train, {len(test_views)} ring test, "
        f"{len(views) - n_ring} orbit) in {time.perf_counter() - t0:.1f} s")
    knn_scale = torch.sqrt(knn_ops.knn_mean_sq_dist(
        torch.as_tensor(pts, device=dev))).cpu().numpy()
    knn_bad = knn_scale.max() >= PIPE_KNN_MAX
    log(f"  the ground truth's kNN scale init: median {np.median(knn_scale):.4f}"
        f", largest {knn_scale.max():.4f} at rows "
        f"{np.argsort(-knn_scale)[:3].tolist()} (each axis maximum at "
        f"{np.unique(pts.argmax(axis=0)).tolist()}; bound {PIPE_KNN_MAX})"
        + (" FAILS" if knn_bad else ""))
    del knn_scale
    scene = SceneInfo(points=pts, colors=cols,
                      train_cameras=[SceneCamera(v) for v in train_views],
                      test_cameras=[], extent=9.0,
                      center=np.zeros(3, np.float32))
    pcfg, opt, pconf, mcfg, cfg = pipeline_settings(
        PIPE["coarse_iters"], PIPE["chunk_iters"], PIPE["post_iters"],
        PIPE["post_densify"])
    chunks = chunking.make_chunks(scene, chunk_size=pcfg.chunk_size,
                                  point_padding=pcfg.chunk_point_padding,
                                  min_n_cams=1, min_points=1)
    if len(chunks) != 9:
        raise AssertionError(f"make_chunks gave {len(chunks)} chunks, not 9")

    entries = []
    t_run = [0.0]

    class Record:
        """Keeps the run's log and echoes it as it comes."""

        def log(self, **kv):
            entries.append(kv)
            log(f"    +{time.perf_counter() - t_run[0]:.1f} s "
                + json.dumps(kv, default=float))

    steps, stage, frame = [], ["coarse"], {}
    orig = dict(train_step=flat.train_step,
                post_train_step=post.post_train_step,
                coarse=full_train.train_coarse_scaffold,
                chunk=full_train.train_flat_scene,
                post=full_train.post_optimize)

    chunk_start_bytes = []

    def staged(name, fn):
        def run(*a, **kw):
            stage[0] = name
            if name == "chunk":
                chunk_start_bytes.append(torch.cuda.memory_allocated(dev))
            return fn(*a, **kw)
        return run

    def counted(fn, image_arg):
        def step(*a, **kw):
            # one chunk-training frame (the middle chunk's middle step): its
            # B1 inputs, taken by a render stopped at B1's wrapper (no
            # launch), are copied to hold B1 and B2 against their plain
            # versions after the run
            if stage[0] == "chunk":
                frame["n"] = frame.get("n", 0) + 1
                if frame["n"] == 4 * pcfg.chunk_iters + pcfg.chunk_iters // 2:
                    fargs, fopts = capture_b1_inputs(lambda: fn(*a, **kw))
                    frame["inputs"] = (tuple(x.detach().clone()
                                             for x in fargs), fopts)
            before = (kernel.launches, kernel_b2.launches)
            ts, aux = fn(*a, **kw)
            # the view a step trained on is its target image's tensor
            steps.append((stage[0], (kernel.launches - before[0],
                                     kernel_b2.launches - before[1]),
                          aux.loss, aux.truncated, id(a[image_arg])))
            return ts, aux
        return step

    out_root = tempfile.mkdtemp(prefix="pipeline_")
    out = os.path.join(out_root, "run")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rss = RssSampler()
    flat.train_step = counted(orig["train_step"], 6)
    post.post_train_step = counted(orig["post_train_step"], 7)
    full_train.train_coarse_scaffold = staged("coarse", orig["coarse"])
    full_train.train_flat_scene = staged("chunk", orig["chunk"])
    full_train.post_optimize = staged("post", orig["post"])
    kernel.launches = kernel_b2.launches = 0
    try:
        with rss:
            t0 = t_run[0] = time.perf_counter()
            merged = full_train.run_pipeline(
                scene, view_loader=lambda ci: ci.v, output_dir=out,
                pcfg=pcfg, opt=opt, post=pconf, cfg=cfg, mcfg=mcfg,
                logger=Record(), device=dev)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
    finally:
        flat.train_step = orig["train_step"]
        post.post_train_step = orig["post_train_step"]
        full_train.train_coarse_scaffold = orig["coarse"]
        full_train.train_flat_scene = orig["chunk"]
        full_train.post_optimize = orig["post"]
    launches = (kernel.launches, kernel_b2.launches)
    peak_dev_gb = torch.cuda.max_memory_allocated() / 1e9

    # every step: one B1 and one B2 launch, finite, untruncated
    want = {"coarse": pcfg.coarse_iters, "chunk": 9 * pcfg.chunk_iters,
            "post": 9 * pcfg.post_iters}
    got = {k: sum(s[0] == k for s in steps) for k in want}
    bad = [(i, s[0], s[1]) for i, s in enumerate(steps) if s[1] != (1, 1)]
    losses = torch.stack([s[2] for s in steps]).cpu()
    # each chunk's loss on the views it trained more than once, at their
    # first and last visit: the logged losses are of two views, 50 steps
    # apart, and differ by view more than by 50 steps of training
    chunk_steps = [(float(losses[i]), s[4]) for i, s in enumerate(steps)
                   if s[0] == "chunk"]
    revisits = []
    for j in range(9):
        run = chunk_steps[j * pcfg.chunk_iters:(j + 1) * pcfg.chunk_iters]
        first, last = {}, {}
        for k, (_, view) in enumerate(run):
            first.setdefault(view, k)
            last[view] = k
        pairs = np.array([(run[first[v]][0], run[last[v]][0])
                          for v in first if last[v] > first[v]]).reshape(-1, 2)
        revisits.append((len(pairs),) + (tuple(pairs.mean(0)) if len(pairs)
                                         else (np.nan, np.nan)))
    trunc = torch.stack([torch.as_tensor(s[3]).reshape(()).to(losses.device)
                         for s in steps]).bool()
    log(f"  run_pipeline {run_s:.1f} s; steps {got} (want {want}); B1 / B2 "
        f"launches {launches[0]} / {launches[1]}; truncated steps "
        f"{int(trunc.sum())}; non-finite losses "
        f"{int((~torch.isfinite(losses)).sum())}")
    if (got != want or bad or launches != (len(steps), len(steps))
            or bool(trunc.any()) or not bool(torch.isfinite(losses).all())):
        raise AssertionError(f"pipeline steps: {got} vs {want}, launches "
                             f"{launches}, off-count steps {bad[:5]}")
    del steps, losses

    # the stage seconds and losses from the run's log
    by = {}
    for e in entries:
        by.setdefault(e["stage"], []).append(e)
    sc = by["scaffold"][0]
    # the scaffold against its initial state on the ring test views, on
    # the targets' black background: each coarse step draws a random
    # background, so its logged losses do not compare
    from hlod_gaussians_torch.train import coarse
    from hlod_gaussians_torch.utils import checkpoint
    gt_cfg = dataclasses.replace(cfg, max_dup=PIPE["gt_max_dup"])
    psnr_init = state_psnr(coarse.init_coarse(
        pts, cols, pcfg.coarse_capacity, scene.extent,
        skybox_num=pcfg.skybox_num,
        n_exposures=full_train._exposure_bucket(len(train_views)),
        device=dev).gaussians, test_views, gt_cfg)
    psnr_coarse = state_psnr(checkpoint.load_flat_state(
        os.path.join(out, "scaffold.npz"), device=dev).gaussians,
        test_views, gt_cfg)
    torch.cuda.empty_cache()
    coarse_logged = [e["loss"] for e in by["coarse"]]
    log(f"  coarse: {sc['seconds']:.1f} s ({sc['source']}; writing "
        f"scaffold.npz {sc['save_s']:.1f} s), logged losses "
        f"{[round(x, 5) for x in coarse_logged]}; the scaffold's PSNR on "
        f"the ring test views {psnr_init:.3f} dB initial, {psnr_coarse:.3f} "
        f"dB trained [{smi}]")
    if not (np.isfinite(coarse_logged).all() and psnr_coarse > psnr_init):
        raise AssertionError("the coarse stage did not train")
    rounds = by["post_densify"]
    if len(rounds) != 9:
        raise AssertionError(f"{len(rounds)} MCMC rounds, not one a chunk")
    post_logs = by["post"]
    for k, c in enumerate(chunks):
        name = f"chunk{c.index}"
        logged = [e for e in by[name] if "loss" in e]
        summary, = [e for e in by[name] if "train_s" in e]
        r = rounds[k]
        log(f"  {name}: {summary['n_rows']} trained rows, "
            f"{summary['n_nodes']} tree nodes, post capacity "
            f"{summary['post_capacity']}; train {summary['train_s']:.2f} s, "
            f"build {summary['build_s']:.2f} s, post {summary['post_s']:.2f}"
            f" s (round: densify {r['densify_s']:.2f} s, rebuild_spt "
            f"{r['rebuild_s']:.2f} s, {r['n_relocated']} relocated, "
            f"{r['n_added_pairs']} pairs added), save "
            f"{summary['save_s']:.2f} s, anchors "
            f"{summary['anchors_s']:.2f} s; logged losses "
            f"{[round(e['loss'], 5) for e in logged]}; on the "
            f"{revisits[k][0]} views it trained again, mean loss "
            f"{revisits[k][1]:.5f} at the first visit, {revisits[k][2]:.5f} "
            "at the last")
        if not (np.isfinite([e["loss"] for e in logged]).all()
                and revisits[k][0] > 0 and revisits[k][2] < revisits[k][1]):
            raise AssertionError(f"{name}: the chunk loss did not fall")
    if any(e["truncated"] for e in post_logs):
        raise AssertionError("a post step truncated")
    mg = by["merge"][0]
    depth = int(merged.nodes[:, NODE_DEPTH].max())
    log(f"  merge: {mg['n_nodes']} nodes from {mg['n_chunks']} chunks in "
        f"{mg['seconds']:.1f} s (host numpy, merged.dhier written); max "
        f"depth {depth} (the JAX run: {PIPE_JAX['nodes']} nodes, depth "
        f"{PIPE_JAX['depth']}, PIPELINE_r05.json, a structural count)")
    # each chunk's train and post states are freed before the next: the
    # device memory in use as a chunk starts does not grow by a chunk
    # state (2^19 rows of parameters and two Adam moments, >= 145 MB)
    growth = (max(chunk_start_bytes) - chunk_start_bytes[0]) / 1e6
    log(f"  run_pipeline's peak device memory {peak_dev_gb:.2f} GB "
        f"(max_memory_allocated), in use as each chunk starts "
        f"{[round(b / 1e9, 3) for b in chunk_start_bytes]} GB; host RSS "
        f"{rss.start:.2f} GB at its start, the largest of its readings "
        f"every {rss.every} s {rss.peak:.2f} GB [{smi}]")
    if len(chunk_start_bytes) != 9 or growth > 100:
        raise AssertionError(f"device memory grew by {growth:.1f} MB "
                             "across the chunks")

    # the artifacts
    sanity_check_hierarchy(merged.nodes, np.ones(merged.nodes.shape[0], bool))
    arts = []
    for c in chunks:
        cd = os.path.join(out, f"chunk_{c.index[0]}_{c.index[1]}")
        d = dhier_io.load_dhier(os.path.join(cd, "hierarchy.dhier_opt"))
        a = flt.read_anchors(os.path.join(cd, "anchors.bin"))
        if not (len(a) and a.min() >= 0 and a.max() < d.nodes.shape[0]):
            raise AssertionError(f"{cd}: anchors outside the tree")
        arts += [os.path.join(cd, f) for f in (
            "hierarchy.dhier_opt", "center.txt", "extent.txt", "anchors.bin")]
    arts.append(os.path.join(out, "scaffold.npz"))
    mtimes = {f: os.stat(f).st_mtime_ns for f in arts}
    with open(os.path.join(out, "merged.dhier"), "rb") as f:
        first = f.read()

    # resume: every chunk artifact untouched, the merge byte-equal
    t0 = time.perf_counter()
    full_train.run_pipeline(
        scene, view_loader=lambda ci: ci.v, output_dir=out, pcfg=pcfg,
        opt=opt, post=pconf, cfg=cfg, mcfg=mcfg, skip_if_exists=True,
        device=dev)
    resume_s = time.perf_counter() - t0
    with open(os.path.join(out, "merged.dhier"), "rb") as f:
        same = f.read() == first
    touched = [f for f in arts if os.stat(f).st_mtime_ns != mtimes[f]]
    log(f"  resume (skip_if_exists): {resume_s:.1f} s, artifacts touched "
        f"{len(touched)} of {len(arts)}, merged.dhier byte-equal {same}")
    if touched or not same:
        raise AssertionError(f"resume rewrote {touched} or changed the merge")
    del first

    # B1 and B2 at a chunk-training frame
    b1, b2, b1_err, b2_err = frame_kernels(frame.pop("inputs"), dev, width,
                                           width, "pipeline chunk frame",
                                           smi)
    torch.cuda.empty_cache()

    # the tau sweeps on the merged tree: over the ring test views, and over
    # the four orbit views of the whole grid, which no chunk trained on
    from hlod_gaussians_torch.ops.ssim import psnr
    from hlod_gaussians_torch.train.post import create_from_dhier
    cap = 1 << int(np.ceil(np.log2(merged.pos.shape[0] + 1)))
    st = create_from_dhier(merged, capacity=cap, device=dev)
    eval_cfg = RasterizerConfig(backend="pallas", tile_w=16, tile_h=16,
                                max_dup=PIPE["gt_max_dup"],
                                tight_binning=True)
    sweeps = {"ring test": test_views, "orbit": views[n_ring:]}
    warned, tables = [], {}
    kernel.launches = kernel_b2.launches = 0
    t0 = time.perf_counter()
    for key, vs in sweeps.items():
        tables[key] = eval_mod.eval_views(
            st, vs, [v.image for v in vs], EVAL_TAUS, level_is_tau=True,
            budget=PIPE["eval_budget"], cfg=eval_cfg, k_max=1024,
            warn=warned.append)
    eval_s = time.perf_counter() - t0
    eval_launches = (kernel.launches, kernel_b2.launches)
    n_renders = len(EVAL_TAUS) * sum(len(vs) for vs in sweeps.values())
    black = {}
    for key, vs in sweeps.items():
        log(f"  the {key} views ({len(vs)}):")
        for r in tables[key]:
            log(f"    tau {r.level:4.1f}: PSNR {r.psnr:.3f}  SSIM "
                f"{r.ssim:.4f}  GMSD {r.gmsd:.5f}  mean rendered "
                f"{r.mean_rendered:.1f}")
        black[key] = statistics.mean(
            float(psnr(torch.zeros_like(v.image), v.image)) for v in vs)
        log(f"    an all-black image scores PSNR {black[key]:.3f}")
    leaf = merged.nodes[:, NODE_CHILD_COUNT] == 0
    log(f"  eval {eval_s:.1f} s for {n_renders} renders (state capacity "
        f"{cap}), B1 / B2 launches {eval_launches[0]} / {eval_launches[1]}"
        f"; the leaves' mean opacity "
        f"{float(merged.opacity[leaf].mean()):.4f}; warnings {warned}")
    if knn_bad:
        raise AssertionError(f"pipeline scene: the ground truth's kNN scale "
                             f"init exceeds {PIPE_KNN_MAX}")
    if eval_launches != (n_renders, 0):
        raise AssertionError(f"the tau sweeps launched {eval_launches}, not "
                             f"({n_renders}, 0)")
    table = tables["ring test"]
    rendered = [r.mean_rendered for r in table]
    if (rendered[0] <= rendered[-1]
            or any(a < b for a, b in zip(rendered, rendered[1:]))
            or not all(np.isfinite(r.psnr) for r in table)
            or not table[0].psnr >= table[-1].psnr):
        raise AssertionError("the tau sweep on the merged tree is not "
                             "monotone")
    # the orbit at these step counts has no JAX reading to be held to: its
    # cut shrinks with tau, and at tau 0 it draws the grid well above black
    table = tables["orbit"]
    rendered = [r.mean_rendered for r in table]
    if (rendered[0] <= rendered[-1]
            or any(a < b for a, b in zip(rendered, rendered[1:]))
            or not table[0].psnr >= black["orbit"] + PIPE_ORBIT_DB):
        raise AssertionError(f"the orbit sweep: mean rendered {rendered}, "
                             f"tau-0 PSNR {table[0].psnr:.3f} against black "
                             f"{black['orbit']:.3f}")
    del st, merged
    import shutil
    shutil.rmtree(out_root)
    torch.cuda.empty_cache()
    return dict(b1=launches[0], b2=launches[1], b1_eval=eval_launches[0],
                b1_frame=b1, b2_frame=b2, b1_err=b1_err, b2_err=b2_err)


def write_png(path, img):
    """An 8-bit RGB PNG of img [H, W, 3] in [0, 1] (zlib, no filter)."""
    import struct
    import zlib
    h, w, _ = img.shape
    raw = np.round(np.clip(img, 0, 1) * 255).astype(np.uint8)
    rows = b"".join(b"\x00" + raw[y].tobytes() for y in range(h))

    def chunk(tag, data):
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows, 6))
                + chunk(b"IEND", b""))


def cli_phase(dev, smi):
    """The full-train CLI in a subprocess on the card: a small COLMAP scene
    (the orbit of phase [13] over CLI_VIEWS views, its images rendered by
    the port from 4,000 seeded points) -> merged.dhier."""
    import tempfile

    import torch
    from hlod_gaussians_torch import render
    from hlod_gaussians_torch.config import RasterizerConfig
    from hlod_gaussians_torch.data import dhier as dhier_io
    from hlod_gaussians_torch.hierarchy.cut import sanity_check_hierarchy
    from hlod_gaussians_torch.models import gaussians as gm
    rng = np.random.default_rng(21)
    pts = (rng.normal(size=(4000, 3)) * 2.0).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, pts.shape).astype(np.float32)
    st = gm.create_from_points(pts, cols, capacity=4096, sh_degree=1,
                               opacity_init=0.8, device=dev)
    act = gm.activate(st)
    cfg = RasterizerConfig(backend="pallas", tile_w=16, tile_h=8,
                           max_dup=1 << 20)
    argv = ["--coarse_iters", "4", "--chunk_iters", "4", "--post_iters",
            "2", "--skybox_num", "64"]
    with tempfile.TemporaryDirectory() as root:
        write_orbit_colmap(os.path.join(root, "sparse", "0"), CLI_W, CLI_H,
                           pts, n=CLI_VIEWS)
        os.makedirs(os.path.join(root, "images"))
        cams = post_bench_cameras(CLI_W, CLI_H, dev, n=CLI_VIEWS)
        for i, cam in enumerate(cams):
            with torch.no_grad():
                img = render.render_arrays(
                    act.means3d, act.scales, act.quats, act.opacities,
                    act.shs, act.valid, cam.world_view, cam.full_proj,
                    cam.campos, cam.tan_fovx, cam.tan_fovy,
                    torch.zeros(3, device=dev), sh_degree=1, width=CLI_W,
                    height=CLI_H, cfg=cfg).image
            write_png(os.path.join(root, "images", f"view_{i:03d}.png"),
                      img.permute(1, 2, 0).cpu().numpy())
        out = os.path.join(root, "out")
        cmd = [sys.executable, "-m", "hlod_gaussians_torch.cli",
               "full-train", "-s", root, "-o", out] + argv
        log(f"[14b] full-train CLI: {CLI_VIEWS}-view {CLI_W}x{CLI_H} COLMAP "
            f"scene, python -m hlod_gaussians_torch.cli full-train "
            f"{' '.join(argv)}")
        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=ROOT)
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        tail = (proc.stdout + proc.stderr).strip().splitlines()[-3:]
        log(f"  exit {proc.returncode} in {cli_s:.1f} s: {tail}")
        merged = os.path.join(out, "merged.dhier")
        if proc.returncode != 0 or not os.path.exists(merged):
            raise AssertionError("the full-train CLI failed:\n"
                                 + proc.stdout[-3000:] + proc.stderr[-3000:])
        d = dhier_io.load_dhier(merged)
        sanity_check_hierarchy(d.nodes, np.ones(d.nodes.shape[0], bool))
        log(f"  merged.dhier: {d.nodes.shape[0]} nodes [{smi}]")


# ---- scale-out: phases 15-19 ---------------------------------------------
# data-parallel: the phase-[5] bench scene, B = 4 of phase [3]'s views a
# step; the xla-backend check at a reduced frame (the plain path's autograd
# keeps every entry step of every tile: tens of GB at 1080p)
DP = dict(views=4, steps=8, yaws=(-3.5, -1.0, 1.0, 3.5), gloo_yaws=(-1.0, 1.0),
          xla_stride=10, xla_wh=(480, 270))
# chunk-parallel: chunk states at the pipeline's chunk capacity, a shell of
# PIPE["per"] points each, 512x512 views, 16x16 tiles
CHUNK_ROWS = 1 << 19
# the multi-process pipeline: PIPE's point cut to 4 shells (a 2x2 block of
# its grid, 4 chunks) and coarse / chunk / post steps 20 / 30 / 10 with one
# MCMC round a chunk
PIPE_MP = dict(centers=(0, 1, 3, 4), iters=(20, 30, 10), post_densify=5)
VIEWER = dict(frames=30, cli_requests=3)
FRAME = (1920, 1080)           # the serving frame of phases 3-11 and 15-19
LOD_TILE_TAU = 3.0


def bench_state(dev, scene):
    """The bench scene as a GaussianState (phase [5]'s `truth`)."""
    from hlod_gaussians_torch import convert
    n_g = scene["xyz"].shape[0]
    arrays = dict(scene, exposure=np.eye(3, 4, dtype=np.float32)[None],
                  alive=np.ones(n_g, bool),
                  nodes=np.full((n_g, 6), -1, np.int32))
    return convert.state_from_numpy(arrays, n_skybox=0, device=dev)


def bench_view(yaw_deg, dev, width=None, height=None):
    from hlod_gaussians_torch.utils.camera import make_camera
    a = np.deg2rad(yaw_deg)
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]])
    return make_camera(R, np.zeros(3), 1.2, 0.8, width or FRAME[0],
                       height or FRAME[1], device=dev)


def bench_cfg(max_dup=352 * 1024):
    from hlod_gaussians_torch.config import RasterizerConfig
    return RasterizerConfig(backend="pallas", tile_w=32, tile_h=32,
                            max_dup=max_dup, tight_binning=True)


def dp_inputs(dev, yaws, scene, width=None, height=None, stride=1):
    """Phase [5]'s training start (the bench scene, f_dc + 0.3 and xyz
    jitter from default_rng(7)) and views at `yaws` whose targets are the
    unperturbed scene's renders: (train state, stacked view tensors, gts).
    ``stride`` keeps every stride-th Gaussian."""
    import torch
    from hlod_gaussians_torch import render
    from hlod_gaussians_torch.models import gaussians as gm
    from hlod_gaussians_torch.train import flat
    width, height = width or FRAME[0], height or FRAME[1]
    scene = {k: v[::stride] for k, v in scene.items()}
    truth = bench_state(dev, scene)
    act = gm.activate(truth)
    cams = [bench_view(y, dev, width, height) for y in yaws]
    gts = []
    with torch.no_grad():
        for c in cams:
            gts.append(render.render_arrays(
                act.means3d, act.scales, act.quats, act.opacities, act.shs,
                act.valid, c.world_view, c.full_proj, c.campos, c.tan_fovx,
                c.tan_fovy, torch.zeros(3, device=dev), sh_degree=3,
                width=width, height=height, cfg=bench_cfg()).image)
    n = truth.capacity
    rng = np.random.default_rng(7)
    pert = dataclasses.replace(
        truth, f_dc=truth.f_dc + 0.3,
        xyz=truth.xyz + torch.as_tensor(
            rng.normal(size=(n, 3)).astype(np.float32) * 0.01, device=dev))
    st = lambda k: torch.stack([torch.as_tensor(getattr(c, k)) for c in cams])
    views = (st("world_view"), st("full_proj"), st("campos"),
             st("tan_fovx"), st("tan_fovy"))
    return flat.init_flat_train(pert), views, torch.stack(gts)


def dp_step(ts, views, gts, mesh, cfg, width=None, height=None, k_max=1024):
    import torch
    from hlod_gaussians_torch.parallel import data_parallel as dp
    return dp.dp_train_step(
        ts, *views, gts, torch.zeros(3, device=gts.device),
        [0] * gts.shape[0], 8.0, mesh=mesh, cfg=cfg,
        width=width or FRAME[0], height=height or FRAME[1], k_max=k_max,
        sh_degree=3)


def step_diff(a, b):
    """Largest |a - b| over the parameters and densify statistics of two
    FlatTrainStates, and whether they are bitwise equal."""
    import torch
    pairs = [(getattr(a.gaussians, k), getattr(b.gaussians, k))
             for k in ("xyz", "f_dc", "f_rest", "log_scale", "quat",
                       "opacity_logit", "exposure")]
    pairs += [(getattr(a, k).float(), getattr(b, k).float())
              for k in ("xyz_grad_accum", "denom", "max_radii")]
    err = max(float((x.float() - y.float()).abs().max()) for x, y in pairs)
    same = all(torch.equal(x, y) for x, y in pairs)
    return err, same


def assert_train_step_close(got, ref, extent, what, opt=None):
    """The train step's tolerances (tests/test_torch_train.py, card vs
    card): Adam moments scaled to 3e-4, parameters to 1e-6 where the
    reference gradient is large and within 2 lr elsewhere, visibility
    statistics exact."""
    import torch
    from hlod_gaussians_torch import optim
    from hlod_gaussians_torch.config import OptimizationConfig
    lrs = optim.param_lrs(opt or OptimizationConfig(), 0, extent)
    worst = 0.0
    for k, m_ref in ref.adam.m.items():
        for part in ("m", "v"):
            r = getattr(ref.adam, part)[k]
            e = float((getattr(got.adam, part)[k] - r).abs().max())
            worst = max(worst, e / max(float(r.abs().max()), 1e-30))
        big = m_ref.abs() > 1e-3 * m_ref.abs().max()
        diff = (getattr(got.gaussians, k) - getattr(ref.gaussians, k)).abs()
        if big.any() and float(diff[big].max()) > 1e-6:
            raise AssertionError(f"{what}: {k} off by "
                                 f"{float(diff[big].max()):.3e}")
        if float(diff.max()) > 2 * lrs[k] + 1e-6:
            raise AssertionError(f"{what}: {k} beyond 2 lr")
    same_stats = (torch.equal(got.denom, ref.denom)
                  and torch.equal(got.max_radii, ref.max_radii))
    if worst > GRAD_SCALED_ATOL or not same_stats:
        raise AssertionError(f"{what}: moments {worst:.2e} scaled, "
                             f"statistics equal {same_stats}")
    return worst


def nccl_world(dev, root):
    """The production backend as a world of one process on the card."""
    import torch
    import torch.distributed as dist
    from hlod_gaussians_torch.parallel import data_parallel as dp
    from hlod_gaussians_torch.parallel import distributed as pdist
    pdist.initialize(init_method="file://" + os.path.join(root, "nccl_rdv"),
                     world_size=1, rank=0, device=dev)
    t = torch.full((4,), 2.0, device=dev)
    dist.all_reduce(t)
    want = "nccl" if dev.type == "cuda" else "gloo"
    if dist.get_backend() != want or not bool((t == 2.0).all()):
        raise AssertionError(f"NCCL world of one: backend "
                             f"{dist.get_backend()}, all_reduce {t.tolist()}")
    return dp.make_mesh(1, 1)


def dp_phase(dev, smi, scene, mesh, root):
    """Phase 15 on the NCCL world of one; the one-rank two-view reference
    of the Gloo world's step is written to `root`."""
    import torch
    from hlod_gaussians_torch.ops import rasterize_cuda
    from hlod_gaussians_torch.ops.binning import bin_gaussians
    from hlod_gaussians_torch.ops.gaussian_math import (compute_cov3d,
                                                        project_gaussians)
    from hlod_gaussians_torch.models import gaussians as gm
    from hlod_gaussians_torch.train import flat
    kernel, kernel_b2 = (rasterize_cuda.blend_forward,
                         rasterize_cuda.blend_backward)
    cfg = bench_cfg()
    log(f"[15] data-parallel step: dp_train_step at {FRAME[0]}x{FRAME[1]} "
        f"on the bench "
        f"scene ({scene['xyz'].shape[0]} Gaussians, SH 3), B = {DP['views']}"
        f" views a step (yaws {DP['yaws']}), NCCL world of one")
    ts, views, gts = dp_inputs(dev, DP["yaws"], scene)
    step_ms, losses = [], []
    kernel.launches = kernel_b2.launches = 0
    for i in range(DP["steps"]):
        before = (kernel.launches, kernel_b2.launches)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        ts, loss = dp_step(ts, views, gts, mesh, cfg)
        b.record()
        b.synchronize()
        step_ms.append(a.elapsed_time(b))
        losses.append(float(loss))
        delta = (kernel.launches - before[0], kernel_b2.launches - before[1])
        if delta != (DP["views"],) * 2 or not np.isfinite(losses[-1]):
            raise AssertionError(f"dp step {i}: loss {losses[-1]}, (B1, B2) "
                                 f"launches {delta}")
    launches = (kernel.launches, kernel_b2.launches)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"dp steps did not lower the loss: {losses}")
    log(f"  losses {[round(x, 6) for x in losses]}; step median "
        f"{statistics.median(step_ms):.3f} ms (CUDA events, {DP['steps']} "
        f"steps of {DP['views']} views; min {min(step_ms):.3f}), "
        f"{launches[0]} B1 + {launches[1]} B2 launches [{smi}]")
    del ts

    # four identical views take the one-view step
    ts0, views0, gts0 = dp_inputs(dev, (DP["yaws"][0],) * 4, scene)
    got, loss = dp_step(ts0, views0, gts0, mesh, cfg)
    one, aux = flat.train_step(
        ts0, *(v[0] for v in views0), gts0[0], torch.zeros(3, device=dev),
        exposure_idx=0, scene_extent=8.0, cfg=cfg, width=FRAME[0], height=FRAME[1],
        sh_degree=3)
    xyz_err = float((got.gaussians.xyz - one.gaussians.xyz).abs().max())
    loss_rel = abs(float(loss) - float(aux.loss)) / abs(float(aux.loss))
    log(f"  4 identical views vs one train_step: loss rel {loss_rel:.2e}, "
        f"max|d xyz| {xyz_err:.3e}")
    if loss_rel > 1e-5 or xyz_err > 1e-5:
        raise AssertionError("dp over identical views differs from one step")
    del got, one, ts0, views0, gts0

    # the same step with the plain (xla) backend, at a reduced frame
    w, h = DP["xla_wh"]
    tsx, viewsx, gtsx = dp_inputs(dev, DP["yaws"], scene, w, h,
                                  stride=DP["xla_stride"])
    act = gm.activate(tsx.gaussians)
    k_max = 0
    for i in range(DP["views"]):
        p = project_gaussians(
            act.means3d, compute_cov3d(act.scales, act.quats), act.opacities,
            viewsx[0][i], viewsx[1][i], w, h, w / (2 * viewsx[3][i]),
            h / (2 * viewsx[4][i]), viewsx[3][i], viewsx[4][i],
            valid_in=act.valid)
        bins = bin_gaussians(p.xy, p.depth, p.radius, p.valid, w, h, 16, 16,
                             1 << 22)
        k_max = max(k_max, int(bins.tile_counts.max()))
    k_max = -(-k_max // 32) * 32
    small = dataclasses.replace(cfg, tile_w=16, tile_h=16, max_dup=1 << 22)
    px, _ = dp_step(tsx, viewsx, gtsx, None, small, w, h)
    xl, _ = dp_step(tsx, viewsx, gtsx, None,
                    dataclasses.replace(small, backend="xla"), w, h, k_max)
    worst = assert_train_step_close(px, xl, 8.0, "dp pallas vs xla")
    log(f"  one step over {DP['views']} distinct views, pallas vs xla "
        f"backend at {w}x{h} on every {DP['xla_stride']}th Gaussian "
        f"(k_max {k_max}): moments within {worst:.2e} scaled, parameters "
        "within the train step's tolerance")
    del tsx, viewsx, gtsx, px, xl

    # the reference of the Gloo world's step: one rank, both views
    tsg, viewsg, gtsg = dp_inputs(dev, DP["gloo_yaws"], scene)
    ref, ref_loss = dp_step(tsg, viewsg, gtsg, mesh, cfg)
    torch.save(dict(state=_state_dict(ref), loss=float(ref_loss)),
               os.path.join(root, "dp_ref.pt"))
    return dict(launches=launches, step_ms=statistics.median(step_ms))


def _state_dict(ts):
    g = ts.gaussians
    out = {k: getattr(g, k).cpu() for k in ("xyz", "f_dc", "f_rest",
                                            "log_scale", "quat",
                                            "opacity_logit", "exposure")}
    out.update({k: getattr(ts, k).cpu() for k in ("xyz_grad_accum", "denom",
                                                  "max_radii")})
    return out


def band_phase(dev, smi, scene):
    """Phase 16's kernel numbers, in this process: B1 at each band of the
    two-band 1080p bench frame (render_arrays with band=) against its plain
    version, its bare launch and bound, beside the whole frame's."""
    import torch
    from hlod_gaussians_torch import render
    from hlod_gaussians_torch.models import gaussians as gm
    from hlod_gaussians_torch.ops import rasterize_cuda
    from hlod_gaussians_torch.ops.rasterize_xla import blend_forward_plain
    log(f"[16] tile-parallel frames: kernel B1 at the bands of the "
        f"{FRAME[0]}x{FRAME[1]} bench frame split in two (band-local bins, "
        "max_dup / 2 a band)")
    act = gm.activate(bench_state(dev, scene))
    cam = bench_view(0.0, dev)
    cfg = bench_cfg()
    out = {}
    for n_bands in (1, 2):
        for band in range(n_bands):
            def run():
                with torch.no_grad():
                    render.render_arrays(
                        act.means3d, act.scales, act.quats, act.opacities,
                        act.shs, act.valid, cam.world_view, cam.full_proj,
                        cam.campos, cam.tan_fovx, cam.tan_fovy,
                        torch.zeros(3, device=dev), sh_degree=3,
                        width=FRAME[0], height=FRAME[1], cfg=cfg,
                        band=(band, n_bands))
            fargs, fopts = capture_b1_inputs(run)
            width, height = fopts["width"], fopts["height"]
            name = "whole frame" if n_bands == 1 else f"band {band}"
            if n_bands == 2 and band == 0:
                got = rasterize_cuda.blend_forward(*fargs, **fopts)
                torch.cuda.synchronize()
                ref = blend_forward_plain(*fargs, **fopts)
                out["b1_err"] = compare(f"band 0 of 2 ({width}x{height})",
                                        got, ref, FRAME_ATOL)
                del got, ref
            evaluated, applied, _, read = work_of_frame(
                *fargs, width, height, 32, 32, cfg.t_eps, cfg.alpha_min)
            n_bytes, n_read, _ = frame_bytes(fargs, read, width, height,
                                             4 * 4 + 4 + 4)
            b_ms, b_by, parts = bound(n_bytes, OPS_EVAL * evaluated
                                      + OPS_APPLY * applied)
            ms = bare_launch_ms(fargs, fopts)
            out[name] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by,
                             entries=int(fargs[3].sum()), height=height)
            log(f"  B1 at the {name} ({width}x{height}, "
                f"{int(fargs[3].sum())} entries, {n_read} read): launch "
                f"{ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {parts}) "
                f"[{smi}]")
    bands = [out["band 0"]["ms"], out["band 1"]["ms"]]
    out["imbalance"] = max(bands) / statistics.mean(bands)
    log(f"  bands {bands[0]:.4f} + {bands[1]:.4f} ms against the whole "
        f"frame's {out['whole frame']['ms']:.4f} ms; imbalance (max / mean) "
        f"{out['imbalance']:.3f} [{smi}]")
    return out


def chunk_inputs(dev, k):
    """k chunk states at CHUNK_ROWS rows, each shell i of the pipeline
    point's layout (PIPE["per"] points around PIPE_CENTERS[i]) with the
    first ring view of its shell at 512x512 as target: (states, stacked
    view tensors, gts)."""
    import torch
    from hlod_gaussians_torch.models import gaussians as gm
    from hlod_gaussians_torch.train import flat
    per = PIPE["per"]
    pts, cols, views = pipeline_scene(dev, per, PIPE_CENTERS[:k])
    states = [flat.init_flat_train(gm.create_from_points(
        pts[i * per:(i + 1) * per], cols[i * per:(i + 1) * per],
        capacity=CHUNK_ROWS, sh_degree=1, opacity_init=0.5, device=dev))
        for i in range(k)]
    mine = [views[i * PIPE["ring"]] for i in range(k)]
    st = lambda a: torch.stack([torch.as_tensor(getattr(v, a)) for v in mine])
    return states, (st("world_view"), st("full_proj"), st("campos"),
                    st("tan_fovx"), st("tan_fovy")), \
        torch.stack([v.image for v in mine])


def chunk_step(bts, views, gts, cfg):
    import torch
    from hlod_gaussians_torch.parallel import chunk_parallel as cpar
    return cpar.chunk_parallel_step(
        bts, *views, gts, torch.zeros(3, device=gts.device),
        [0] * gts.shape[0], 9.0, cfg=cfg, width=PIPE["width"],
        height=PIPE["width"], sh_degree=1, use_exposure=False)


def one_chunk_step(ts, views, gts, i, cfg):
    import torch
    from hlod_gaussians_torch.train import flat
    return flat.train_step(
        ts, *(v[i] for v in views), gts[i], torch.zeros(3, device=gts.device),
        exposure_idx=0, scene_extent=9.0, cfg=cfg, width=PIPE["width"],
        height=PIPE["width"], sh_degree=1, use_exposure=False)


def chunk_phase(dev, smi):
    """Phase 17 on the NCCL world of one: two chunk states step through
    chunk_parallel_step, each held to its own flat.train_step."""
    import torch
    from hlod_gaussians_torch.ops import rasterize_cuda
    from hlod_gaussians_torch.parallel import chunk_parallel as cpar
    kernel, kernel_b2 = (rasterize_cuda.blend_forward,
                         rasterize_cuda.blend_backward)
    _, _, _, _, cfg = pipeline_settings(0, 0, 0, 1)
    log(f"[17] chunk-parallel step: 2 chunk states of {CHUNK_ROWS} rows "
        f"({PIPE['per']} points each), {PIPE['width']}x{PIPE['width']}, "
        f"16x16 tiles, max_dup {cfg.max_dup}")
    states, views, gts = chunk_inputs(dev, 2)
    a, _ = one_chunk_step(states[0], views, gts, 0, cfg)
    b, _ = one_chunk_step(states[0], views, gts, 0, cfg)
    err, bitwise = step_diff(a, b)
    log(f"  two runs of one train_step: bitwise equal {bitwise} (max diff "
        f"{err:.3e})")
    del a, b
    kernel.launches = kernel_b2.launches = 0
    ev = (torch.cuda.Event(enable_timing=True),
          torch.cuda.Event(enable_timing=True))
    ev[0].record()
    bts, aux = chunk_step(cpar.stack_states(states), views, gts, cfg)
    ev[1].record()
    ev[1].synchronize()
    launches = (kernel.launches, kernel_b2.launches)
    if launches != (2, 2) or not bool(torch.isfinite(aux.loss).all()) \
            or bool(aux.truncated.any()):
        raise AssertionError(f"chunk-parallel step: launches {launches}, "
                             f"loss {aux.loss.tolist()}, truncated "
                             f"{aux.truncated.tolist()}")
    worst = 0.0
    for i, ts in enumerate(cpar.unstack_states(bts)):
        one, _ = one_chunk_step(states[i], views, gts, i, cfg)
        e, same = step_diff(ts, one)
        worst = max(worst, e)
        if bitwise and not same:
            raise AssertionError(f"chunk {i} differs from its train_step")
        if not bitwise:
            assert_train_step_close(ts, one, 9.0, f"chunk {i}")
    log(f"  each chunk vs its own train_step: "
        f"{'bitwise equal' if bitwise else f'max diff {worst:.3e}'}; losses "
        f"{[round(float(x), 6) for x in aux.loss]}; step "
        f"{ev[0].elapsed_time(ev[1]):.3f} ms for 2 chunks (CUDA events), "
        f"{launches[0]} B1 + {launches[1]} B2 launches [{smi}]")
    return dict(launches=launches, bitwise=bitwise)


def pipeline_mp_inputs(dev):
    """The multi-process pipeline's scene and settings (PIPE_MP)."""
    from hlod_gaussians_torch.data.scene import SceneInfo
    centers = PIPE_CENTERS[list(PIPE_MP["centers"])]
    pts, cols, views = pipeline_scene(dev, PIPE["per"], centers)
    n_ring = len(centers) * PIPE["ring"]
    train = [v for i, v in enumerate(views[:n_ring]) if i % 3 != 0]
    scene = SceneInfo(points=pts, colors=cols,
                      train_cameras=[SceneCamera(v) for v in train],
                      test_cameras=[], extent=9.0,
                      center=np.zeros(3, np.float32))
    return scene, pipeline_settings(*PIPE_MP["iters"],
                                    PIPE_MP["post_densify"])


def run_pipeline_mp(dev, out, logger=None):
    """run_pipeline at PIPE_MP's point into `out`, in PyTorch's default
    (non-deterministic) mode, as a user's full-train runs it."""
    from hlod_gaussians_torch.pipeline import full_train
    scene, (pcfg, opt, pconf, mcfg, cfg) = pipeline_mp_inputs(dev)
    return full_train.run_pipeline(
        scene, view_loader=lambda ci: ci.v, output_dir=out, pcfg=pcfg,
        opt=opt, post=pconf, cfg=cfg, mcfg=mcfg, logger=logger, device=dev)


class ListLogger:
    def __init__(self):
        self.rows = []

    def log(self, **kv):
        self.rows.append(kv)


def gloo_rank(rank, n, root, chunk_bitwise, device="cuda"):
    """A rank of the Gloo world of two on the card: phase [15]'s step with
    one view a rank, [16]'s banded frames, [17]'s K = 4 chunks and [18]'s
    pipeline, each with its kernel launches; results to
    root/rank<r>.json (the dp step's state to root/dp_gloo.pt)."""
    import torch
    import torch.distributed as dist
    from hlod_gaussians_torch.config import MeshConfig
    from hlod_gaussians_torch.hierarchy import cut as cut_mod
    from hlod_gaussians_torch.models import gaussians as gm
    from hlod_gaussians_torch import render
    from hlod_gaussians_torch.ops import rasterize_cuda
    from hlod_gaussians_torch.ops.lod_preprocess import lod_preprocess
    from hlod_gaussians_torch.parallel import chunk_parallel as cpar
    from hlod_gaussians_torch.parallel import data_parallel as dp
    from hlod_gaussians_torch.parallel import distributed as pdist
    from hlod_gaussians_torch.parallel import tile_parallel as tp
    from hlod_gaussians_torch.pipeline import chunking
    kernel, kernel_b2 = (rasterize_cuda.blend_forward,
                         rasterize_cuda.blend_backward)
    dev = torch.device(device)
    res = {}

    def launched(fn):
        torch.cuda.synchronize()
        kernel.launches = kernel_b2.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (kernel.launches, kernel_b2.launches), \
            time.perf_counter() - t0

    # [15] one view a rank
    scene = load_bench_scene()
    mesh = dp.make_mesh(2, 1)
    ts, views, gts = dp_inputs(dev, DP["gloo_yaws"], scene)
    mine = dp.batch_sharding(mesh)

    def step():
        return dp.dp_train_step(
            ts, *(mine(v) for v in views), mine(gts),
            torch.zeros(3, device=dev), [0], 8.0, mesh=mesh, cfg=bench_cfg(),
            width=FRAME[0], height=FRAME[1], sh_degree=3)
    step()                                  # warm-up, from the same state
    (new, loss), launches, sec = launched(step)
    if rank == 0:
        torch.save(dict(state=_state_dict(new), loss=float(loss)),
                   os.path.join(root, "dp_gloo.pt"))
    res["dp"] = dict(loss=float(loss), launches=launches, seconds=sec)
    del ts, views, gts, new

    # [16] banded frames: flat 1080p and the LOD bench tree at tau 3
    tile_mesh = dp.make_mesh_from_config(MeshConfig(data=1, tile=2))
    act = gm.activate(bench_state(dev, scene))
    cam = bench_view(0.0, dev)
    flat_args = (act.means3d, act.scales, act.quats, act.opacities, act.shs,
                 act.valid, cam.world_view, cam.full_proj, cam.campos,
                 cam.tan_fovx, cam.tan_fovy, torch.zeros(3, device=dev))
    with torch.no_grad():
        (img, trunc), launches, sec = launched(
            lambda: tp.render_tile_parallel(
                *flat_args, tile_mesh, sh_degree=3, width=FRAME[0], height=FRAME[1],
                cfg=bench_cfg()))
        one = render.render_arrays(*flat_args, sh_degree=3, width=FRAME[0],
                                   height=FRAME[1], cfg=bench_cfg())
    res["tile_flat"] = dict(err=float((img - one.image).abs().max()),
                            truncated=bool(trunc),
                            shape=list(img.shape), launches=launches,
                            seconds=sec)
    del act, img, one
    lstate, _, _, _ = lod_bench_tree(dev)
    lact = gm.activate(lstate)
    lcam = lod_bench_camera(0, *FRAME, dev)
    target = lod_target(LOD_TILE_TAU, lcam, FRAME[0])
    pcache = cut_mod.build_parent_cache(
        lstate.nodes, lact.means3d, torch.max(lact.scales, dim=1).values)
    itab = cut_mod.build_interp_table(
        dict(means3d=lact.means3d, scales=lact.scales, quats=lact.quats,
             opacities=lact.opacities, shs=lact.shs), lstate.nodes)
    largs = (lact.means3d, lact.scales, lact.quats, lact.opacities, lact.shs,
             lstate.nodes, lstate.alive, lcam.world_view, lcam.full_proj,
             lcam.campos, lcam.tan_fovx, lcam.tan_fovy,
             torch.zeros(3, device=dev), target)
    lod_cfg = bench_cfg(1 << 21)
    fused = lod_preprocess.launches
    with torch.no_grad():
        (img, n_sel, trunc), launches, sec = launched(
            lambda: tp.render_lod_tile_parallel(
                *largs, tile_mesh, None, pcache, itab, sh_degree=3,
                width=FRAME[0], height=FRAME[1], cfg=lod_cfg, use_frustum=False))
        fused = lod_preprocess.launches - fused
        one, n_one = render.render_lod_masked(
            *largs, None, pcache, None, itab, sh_degree=3, width=FRAME[0],
            height=FRAME[1], cfg=lod_cfg, use_frustum=False)
    res["tile_lod"] = dict(err=float((img - one.image).abs().max()),
                           n_selected=int(n_sel), n_one=int(n_one),
                           truncated=bool(trunc) or bool(one.truncated),
                           launches=launches, lod_preprocess=fused,
                           seconds=sec)
    del lstate, lact, pcache, itab, largs, img, one
    torch.cuda.empty_cache()

    # [17] K = 4 chunks, two a rank
    _, _, _, _, ccfg = pipeline_settings(0, 0, 0, 1)
    states, cviews, cgts = chunk_inputs(dev, 4)
    bts = cpar.shard_chunk_states(cpar.stack_states(states), mesh)
    block = dp.batch_sharding(mesh)
    cviews, cgts = tuple(block(v) for v in cviews), block(cgts)
    (stepped, aux), launches, sec = launched(
        lambda: chunk_step(bts, cviews, cgts, ccfg))
    mine_states = block(list(range(4)))
    diffs = []
    for i, ts in enumerate(cpar.unstack_states(stepped)):
        one, _ = one_chunk_step(states[mine_states[i]], cviews, cgts, i,
                                ccfg)
        e, same = step_diff(ts, one)
        if chunk_bitwise and not same:
            raise AssertionError(f"rank {rank} chunk {i}: not bitwise")
        if not chunk_bitwise:
            assert_train_step_close(ts, one, 9.0, f"chunk {i}")
        diffs.append(e)
    boosted = cpar.stack_states([dataclasses.replace(
        ts, xyz_grad_accum=torch.full_like(ts.xyz_grad_accum, 1e9),
        max_radii=torch.full_like(ts.max_radii, 100.0))
        for ts in cpar.unstack_states(stepped)])
    _, n_split = cpar.chunk_parallel_densify(boosted, 9.0)
    res["chunks"] = dict(chunks=mine_states, loss=aux.loss.tolist(),
                         truncated=bool(aux.truncated.any()), diffs=diffs,
                         n_split=n_split.tolist(), launches=launches,
                         seconds=sec)
    del states, bts, stepped, boosted, cviews, cgts
    torch.cuda.empty_cache()

    # [18] the pipeline into the shared directory
    dist.barrier()
    logger = ListLogger()
    scene_mp, (pcfg, *_) = pipeline_mp_inputs(dev)
    chunks = chunking.make_chunks(scene_mp, chunk_size=pcfg.chunk_size,
                                  point_padding=pcfg.chunk_point_padding,
                                  min_n_cams=1, min_points=1)
    block_idx = pdist.process_chunk_assignment(len(chunks))
    merged, launches, sec = launched(lambda: run_pipeline_mp(
        dev, os.path.join(root, "mp"), logger))
    trained = sorted({r["stage"] for r in logger.rows
                      if r["stage"].startswith("chunk(") and "n_rows" in r})
    res["pipeline"] = dict(
        returned=merged is not None, launches=launches, seconds=sec,
        trained=trained,
        block=sorted(f"chunk{chunks[i].index}" for i in block_idx))
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


class GlooWorld:
    """The Gloo world of two processes on the card (NCCL refuses two ranks
    on one device), run from a thread so that this process can take phase
    [18]'s one-process run meanwhile."""

    def __init__(self, dev, root, chunk_bitwise):
        import threading
        from hlod_gaussians_torch.parallel.dryrun import spawn_world
        self.error, self.t0 = None, time.perf_counter()

        def run():
            try:
                spawn_world(gloo_rank, 2, (root, chunk_bitwise, str(dev)),
                            device=dev, backend="gloo", timeout_s=900.0,
                            threads=2)
            except BaseException as e:  # raised again by join()
                self.error = e
        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def join(self):
        self.thread.join()
        self.seconds = time.perf_counter() - self.t0
        if self.error is not None:
            raise self.error


def gloo_phases(dev, smi, root, world, chunk_res):
    """Phases 15-18's parts in the Gloo world of two ranks on the card,
    each checked here once the world has ended; returns the launches of
    each path (both ranks)."""
    import torch
    from hlod_gaussians_torch.data import dhier as dhier_io
    world.join()
    world_s = world.seconds
    log("[15-18] the Gloo world of two processes on the card")
    ranks = []
    for r in range(2):
        with open(os.path.join(root, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    log(f"  world of two ran in {world_s:.1f} s (spawn, the bench scene, "
        "the LOD tree, the chunk states and the pipeline in each rank; "
        "phase [18]'s one-process run shared the card meanwhile)")
    sums = {k: tuple(sum(r[k]["launches"][j] for r in ranks)
                     for j in range(2))
            for k in ("dp", "tile_flat", "tile_lod", "chunks", "pipeline")}

    # [15] one view a rank against one rank with both views
    ref = torch.load(os.path.join(root, "dp_ref.pt"))
    got = torch.load(os.path.join(root, "dp_gloo.pt"))
    diff = max(float((got["state"][k].float() - v.float()).abs().max())
               for k, v in ref["state"].items())
    bitwise = all(torch.equal(got["state"][k], v)
                  for k, v in ref["state"].items())
    log(f"  [15] Gloo dp step, one view a rank: loss {got['loss']:.6f} vs "
        f"{ref['loss']:.6f} one rank two views; parameters and densify "
        f"statistics max |d| {diff:.3e} (bitwise {bitwise}); "
        f"{sums['dp'][0]} B1 + {sums['dp'][1]} B2 launches; rank step "
        f"{ranks[0]['dp']['seconds'] * 1e3:.1f} / "
        f"{ranks[1]['dp']['seconds'] * 1e3:.1f} ms host wall after a "
        f"warm-up step, both ranks on one card [{smi}]")
    if diff > 1e-5 or abs(got["loss"] - ref["loss"]) > 1e-5 * abs(
            ref["loss"]) or sums["dp"] != (2, 2):
        raise AssertionError("the Gloo dp step differs from the one-rank "
                             "two-view step")

    # [16] banded frames
    for r in ranks:
        tf, tl = r["tile_flat"], r["tile_lod"]
        if (tf["err"] > FRAME_ATOL or tf["truncated"]
                or tf["shape"] != [3, FRAME[1], FRAME[0]]
                or tl["err"] > FRAME_ATOL
                or tl["truncated"] or tl["n_selected"] != tl["n_one"]
                or tl["lod_preprocess"] != 1
                or tf["launches"] != [1, 0] or tl["launches"] != [1, 0]):
            raise AssertionError(f"tile-parallel frames: {r}")
    rows = -(-FRAME[1] // 32)
    log(f"  [16] render_tile_parallel {FRAME[0]}x{FRAME[1]} ({rows} tile "
        f"rows, 2 bands of {rows // 2}) vs render_arrays: max|d| "
        f"{max(r['tile_flat']['err'] for r in ranks):.3e}; "
        f"render_lod_tile_parallel of the {2 * LOD_LEAVES - 1}-node tree at "
        f"tau {LOD_TILE_TAU} vs render_lod_masked: "
        f"n_selected {ranks[0]['tile_lod']['n_selected']} (equal), max|d| "
        f"{max(r['tile_lod']['err'] for r in ranks):.3e}; one B1 and one "
        f"lod_preprocess launch a rank a frame; frame host wall flat "
        f"{ranks[0]['tile_flat']['seconds'] * 1e3:.1f} / LOD "
        f"{ranks[0]['tile_lod']['seconds'] * 1e3:.1f} ms (rank 0) [{smi}]")

    # [17] K = 4 over two ranks
    for r in ranks:
        c = r["chunks"]
        if (c["launches"] != [2, 2] or c["truncated"]
                or not all(np.isfinite(c["loss"]))
                or not all(x > 0 for x in c["n_split"])):
            raise AssertionError(f"chunk-parallel in the Gloo world: {c}")
    log(f"  [17] K = 4 chunks over two ranks: blocks "
        f"{[r['chunks']['chunks'] for r in ranks]}, each chunk equal to its "
        f"own train_step ({'bitwise' if chunk_res['bitwise'] else 'within tolerance'}"
        f"), densify splits {[r['chunks']['n_split'] for r in ranks]}; "
        f"step host wall {ranks[0]['chunks']['seconds'] * 1e3:.1f} / "
        f"{ranks[1]['chunks']['seconds'] * 1e3:.1f} ms [{smi}]")

    # [18] the pipeline
    p = [r["pipeline"] for r in ranks]
    if not p[0]["returned"] or p[1]["returned"]:
        raise AssertionError(f"run_pipeline returned {p[0]['returned']} / "
                             f"{p[1]['returned']} on ranks 0 / 1")
    for q in p:
        if q["trained"] != q["block"]:
            raise AssertionError(f"a rank trained {q['trained']}, its block "
                                 f"is {q['block']}")
    if sorted(p[0]["block"] + p[1]["block"]) != sorted(
            set(p[0]["block"] + p[1]["block"])):
        raise AssertionError("the ranks' blocks overlap")
    mp_bytes = open(os.path.join(root, "mp", "merged.dhier"), "rb").read()
    one_bytes = open(os.path.join(root, "one", "merged.dhier"), "rb").read()
    same = mp_bytes == one_bytes
    d = dhier_io.load_dhier(os.path.join(root, "mp", "merged.dhier"))
    log(f"  [18] run_pipeline over two ranks: rank 0 merged {len(d.nodes)} "
        f"nodes, rank 1 returned None; blocks {p[0]['block']} / "
        f"{p[1]['block']}, each rank trained exactly its block; merged.dhier "
        f"byte-equal to the one-process runs': {same}; ranks "
        f"{p[0]['seconds']:.1f} / {p[1]['seconds']:.1f} s host wall, "
        f"{sum(q['launches'][0] for q in p)} B1 + "
        f"{sum(q['launches'][1] for q in p)} B2 launches [{smi}]")
    if not same:
        raise AssertionError("the two-rank pipeline merged another tree than "
                             "the one-process runs")
    return dict(sums=sums, merged_equal=same, world_s=world_s,
                pipe_s=max(q["seconds"] for q in p))


def pipeline_one_phase(dev, smi, root):
    """Phase 18's one-process reference runs: run_pipeline twice in this
    process in PyTorch's default mode, into root/one and root/one_again;
    their merged.dhier files must be byte-equal."""
    import torch
    scene_msg = (f"{len(PIPE_MP['centers'])} shells x {PIPE['per']} points "
                 f"(the pipeline point's {len(PIPE_CENTERS)}), "
                 f"{PIPE['width']}x{PIPE['width']}, steps coarse / chunk / "
                 f"post {PIPE_MP['iters']} (phase [14]'s "
                 f"{(PIPE['coarse_iters'], PIPE['chunk_iters'], PIPE['post_iters'])})")
    log(f"[18] the multi-process pipeline: run_pipeline, {scene_msg}; "
        "twice in this process in PyTorch's default mode (deterministic "
        "algorithms off), while the Gloo world of phases [15]-[18] runs on "
        "the same card")
    runs = []
    for name in ("one", "one_again"):
        t0 = time.perf_counter()
        merged = run_pipeline_mp(dev, os.path.join(root, name))
        torch.cuda.synchronize()
        runs.append((len(merged.nodes), time.perf_counter() - t0))
    same = (open(os.path.join(root, "one", "merged.dhier"), "rb").read()
            == open(os.path.join(root, "one_again", "merged.dhier"),
                    "rb").read())
    log(f"  one process, twice: {runs[0][0]} / {runs[1][0]} merged nodes in "
        f"{runs[0][1]:.1f} / {runs[1][1]:.1f} s (scene and ground truth "
        f"included); merged.dhier byte-equal: {same}; deterministic "
        f"algorithms {torch.are_deterministic_algorithms_enabled()} [{smi}]")
    if not same or torch.are_deterministic_algorithms_enabled():
        raise AssertionError("two default-mode runs of run_pipeline merged "
                             "different trees")
    return runs


def sibr_request(cam, template):
    """The framed request a SIBR client sends for `cam`: its matrices with
    the Y/Z flips that decode_camera undoes."""
    wv = cam.world_view.cpu().numpy().astype(np.float64)
    fp = cam.full_proj.cpu().numpy().astype(np.float64)
    wv[:, 1:3] *= -1
    fp[:, 1] *= -1
    msg = dict(template, resolution_x=cam.width, resolution_y=cam.height,
               fov_x=1.2, fov_y=0.8, view_matrix=list(wv.flatten()),
               view_projection_matrix=list(fp.flatten()))
    payload = json.dumps(msg).encode()
    return len(payload).to_bytes(4, "little") + payload, msg


def sibr_template():
    raw = open(os.path.join(ROOT, "tests", "fixtures", "viewer",
                            "sibr_request.bin"), "rb").read()
    n = int.from_bytes(raw[:4], "little")
    return json.loads(raw[4:4 + n]), raw[4 + n:]


class SibrClient:
    """A client on a thread: sends each request, reads its reply (the
    image and the status JSON) and times it on its clock."""

    def __init__(self, port, requests, keepalive, image_bytes):
        import socket
        import threading
        self.sock = socket.create_connection(("127.0.0.1", port))
        self.requests, self.keepalive = requests, keepalive
        self.image_bytes = image_bytes
        self.replies, self.ms, self.error = [], [], None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _recv(self, n):
        buf = bytearray()
        while len(buf) < n:
            chunk = self.sock.recv(min(n - len(buf), 1 << 22))
            if not chunk:
                raise ConnectionError("server closed")
            buf += chunk
        return bytes(buf)

    def _run(self):
        try:
            for req in self.requests:
                t0 = time.perf_counter()
                self.sock.sendall(req)
                img = self._recv(self.image_bytes)
                n = int.from_bytes(self._recv(4), "little")
                status = json.loads(self._recv(n))
                self.ms.append((time.perf_counter() - t0) * 1e3)
                self.replies.append((img, status))
            if self.keepalive:
                self.sock.sendall(self.keepalive)
                self.replies.append(("keepalive",
                                     int.from_bytes(self._recv(4), "little")))
        except Exception as e:  # reported by the caller
            self.error = e
        finally:
            self.sock.close()


def viewer_phase(dev, smi, root):
    """Phase 19: make_viewer on the LOD bench tree's .dhier, 30 SIBR
    requests from a client thread, frame 1 held to an in-process render_lod,
    B1 at the served frames held to its plain version, then the viewer
    entry point in a subprocess."""
    import argparse
    import signal
    import torch
    from hlod_gaussians_torch import cli, render
    from hlod_gaussians_torch.data import dhier as dhier_io
    from hlod_gaussians_torch.hierarchy import cut as cut_mod
    from hlod_gaussians_torch.models import gaussians as gm
    from hlod_gaussians_torch.ops import rasterize_cuda
    from hlod_gaussians_torch.ops.rasterize_xla import blend_forward_plain
    from hlod_gaussians_torch.train.post import create_from_dhier
    from hlod_gaussians_torch.viewer import maintenance as maint
    from hlod_gaussians_torch.viewer.server import ViewerServer
    kernel = rasterize_cuda.blend_forward
    (w, h), frames = FRAME, VIEWER["frames"]
    log(f"[19] viewer: make_viewer on the {2 * LOD_LEAVES - 1}-node LOD bench "
        f"tree (SH 3) as a .dhier; {frames} SIBR requests at {w}x{h} along "
        "lod_bench_camera's poses, then a resolution-0 keepalive")
    _, tree, _, _ = lod_bench_tree(dev)
    path = os.path.join(root, "viewer.dhier")
    dhier_io.save_dhier(path, bench_dhier(tree))
    del tree
    args = argparse.Namespace(hierarchy=path, host="127.0.0.1", port=0,
                              backend="pallas", occlusion_cull=False)
    t0 = time.perf_counter()
    srv, render_fn = cli.make_viewer(args, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    template, keepalive = sibr_template()
    cams = [lod_bench_camera(i, w, h, dev) for i in range(frames)]
    reqs = [sibr_request(c, template) for c in cams]
    # the served frames' B1 inputs, the first and the last frame's, kept for
    # the check against the plain version below: recorded at the C launch
    # beneath the wrapper, which goes on counting its launches
    served_b1, launch = [], rasterize_cuda.launch_blend_forward

    def recording(feats, sorted_gid, tile_starts, tile_counts, *outs, **kw):
        served_b1[min(len(served_b1), 1):] = [
            ((feats, sorted_gid, tile_starts, tile_counts), kw)]
        return launch(feats, sorted_gid, tile_starts, tile_counts, *outs,
                      **kw)

    kernel.launches = 0
    client = SibrClient(srv.port, [r for r, _ in reqs], keepalive, w * h * 3)
    served, deadline = 0, time.perf_counter() + 300.0
    rasterize_cuda.launch_blend_forward = recording
    try:
        while served < frames + 1 and time.perf_counter() < deadline:
            if srv.poll_once(render_fn) is None:
                time.sleep(0.0005)
            else:
                served += 1
        client.thread.join(60.0)
    finally:
        rasterize_cuda.launch_blend_forward = launch
        srv.close()
    torch.cuda.synchronize()
    launches = kernel.launches
    if client.error is not None or len(client.replies) != frames + 1:
        raise AssertionError(f"viewer: {len(client.replies)} replies, "
                             f"error {client.error!r}")
    for i, (img, status) in enumerate(client.replies[:frames]):
        if len(img) != w * h * 3 or (
                i > 0 and "Num_Rendered" not in status["train_params"]):
            raise AssertionError(f"viewer reply {i}: {len(img)} bytes, "
                                 f"status {status}")
    if client.replies[-1] != ("keepalive", 0) or launches != frames:
        raise AssertionError(f"viewer: keepalive {client.replies[-1]}, "
                             f"{launches} B1 launches")

    # B1 at the viewer's operating point (the bucket, 16x16 tiles, the LOD
    # alpha, max_dup 2^20) against its plain version on the first and the
    # last served frame's inputs; the last frame's launch and bound
    bw, bh = cli._res_bucket(w, h)
    b1_err = 0.0
    for where, (fa, fopts) in zip(("first", "last"), served_b1):
        fargs = tuple(a.detach() for a in fa)
        got = kernel(*fargs, **fopts)
        torch.cuda.synchronize()
        ref = blend_forward_plain(*fargs, **fopts)
        b1_err = max(b1_err, compare(
            f"{where} viewer frame ({bw}x{bh}, 16x16 tiles)", got, ref,
            FRAME_ATOL, FRAME_NC_SHARE))
        del got, ref
    evaluated, applied, cand, read = work_of_frame(
        *fargs, bw, bh, fopts["tile_w"], fopts["tile_h"], fopts["t_eps"],
        fopts["alpha_min"], use_lod=fopts["use_lod"])
    n_bytes, n_read, n_rows = frame_bytes(fargs, read, bw, bh, 4 * 4 + 4 + 4)
    b_ms, b_by, parts = bound(n_bytes, OPS_EVAL * evaluated
                              + OPS_APPLY * applied + OPS_LOD * cand)
    b1_frame = dict(ms=bare_launch_ms(fargs, fopts), bound_ms=b_ms,
                    bound_by=b_by, entries=int(fargs[3].sum()))
    log(f"  B1 at the last viewer frame ({b1_frame['entries']} entries, "
        f"{n_read} read naming {n_rows} rows): launch {b1_frame['ms']:.4f} "
        f"ms, bound {b_ms:.4f} ms ({b_by}; {parts}) [{smi}]")
    del served_b1, fargs, fa

    # frame 1 in process: the first frame's cut (two incremental steps from
    # the roots at the controller's start target), render_lod at the
    # window's bucket, sampled back to the window
    d = dhier_io.load_dhier(path)
    state = create_from_dhier(d, capacity=1 << int(np.ceil(np.log2(
        d.pos.shape[0] + 1))), device=dev)
    act = gm.activate(state)
    cam, _ = ViewerServer.decode_camera(reqs[0][1])
    max_scale = torch.max(act.scales, dim=-1).values
    active = torch.as_tensor(maint.initial_cut(state.nodes, state.alive),
                             device=dev)
    target = maint.BudgetController(budget=1 << 19).target
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    for _ in range(2):
        active, _, _ = maint.incremental_cut_step(
            state.nodes, act.means3d, max_scale, state.alive, active,
            f32(cam.campos), target)
    pcache = cut_mod.build_parent_cache(state.nodes, act.means3d, max_scale)
    itab = cut_mod.build_interp_table(
        dict(means3d=act.means3d, scales=act.scales, quats=act.quats,
             opacities=act.opacities, shs=act.shs), state.nodes)
    with torch.no_grad():
        out, _ = render.render_lod(
            act.means3d, act.scales, act.quats, act.opacities, act.shs,
            state.nodes, state.alive, f32(cam.world_view),
            f32(cam.full_proj), f32(cam.campos), f32(cam.tan_fovx),
            f32(cam.tan_fovy), torch.zeros(3, device=dev), target, None,
            active, pcache, None, itab, sh_degree=3, width=bw, height=bh,
            budget=1 << 19, cfg=dataclasses.replace(
                bench_cfg(1 << 20), tile_w=16, tile_h=16))
    img = torch.clamp(out.image, 0, 1).permute(1, 2, 0).cpu().numpy()
    yi = np.clip((np.arange(h) * (bh / h)).astype(int), 0, bh - 1)
    xi = np.clip((np.arange(w) * bw / w).astype(int), 0, bw - 1)
    ref = (img[yi][:, xi] * 255).astype(np.uint8)
    got = np.frombuffer(client.replies[0][0], np.uint8).reshape(h, w, 3)
    n_diff = int((got != ref).any(-1).sum())
    del state, act, active, out, pcache, itab
    ms = client.ms
    p50, p90 = statistics.median(ms), float(np.percentile(ms, 90))
    n_rendered = [s["train_params"].get("Num_Rendered")
                  for _, s in client.replies[1:frames]]
    log(f"  setup (load, initial cut, parent cache, interp table) "
        f"{setup_s:.2f} s; {frames} frames served at bucket {bw}x{bh}, "
        f"{launches} B1 launches; frame latency on the client's clock p50 "
        f"{p50:.2f} ms, p90 {p90:.2f} ms (PERF.md's ceiling 16.7 ms); "
        f"Num_Rendered {n_rendered[0]} .. {n_rendered[-1]} [{smi}]")
    log(f"  frame 1 vs an in-process render_lod at the same cut, bucket "
        f"and sampling: {n_diff} pixels differ")
    if n_diff:
        raise AssertionError("the viewer's first frame differs from "
                             "render_lod")

    # the entry point itself, in a subprocess
    cmd = [sys.executable, "-m", "hlod_gaussians_torch.cli", "viewer",
           "--hierarchy", path, "--port", "0"]
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        port, output = _listening_port(proc, 300.0)
        start_s = time.perf_counter() - t0
        sub = SibrClient(port, [r for r, _ in reqs[:VIEWER["cli_requests"]]],
                         None, w * h * 3)
        sub.thread.join(120.0)
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(60.0)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    rest = "".join(output)
    if (sub.error is not None or len(sub.replies) != VIEWER["cli_requests"]
            or rc != 0):
        raise AssertionError(f"viewer CLI: exit {rc}, {len(sub.replies)} "
                             f"replies, error {sub.error!r}:\n{rest[-3000:]}")
    log(f"  python -m hlod_gaussians_torch.cli viewer: listening after "
        f"{start_s:.1f} s, served {len(sub.replies)} requests "
        f"({', '.join(f'{x:.1f}' for x in sub.ms)} ms), exit {rc} on SIGINT "
        f"[{smi}]")
    return dict(launches=launches, p50=p50, p90=p90, b1_err=b1_err,
                b1_frame=b1_frame)


def _listening_port(proc, timeout):
    """The port the viewer subprocess prints that it listens on, and the
    list its output lines keep arriving in (a reader thread)."""
    import queue
    import threading
    lines, seen = queue.Queue(), []

    def read():
        for x in iter(proc.stdout.readline, ""):
            seen.append(x)
            lines.put(x)
    threading.Thread(target=read, daemon=True).start()
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        try:
            line = lines.get(timeout=1.0)
        except queue.Empty:
            if proc.poll() is not None:
                break
            continue
        m = re.search(r"viewer listening on [\d.]+:(\d+)", line)
        if m:
            return int(m.group(1)), seen
    raise AssertionError("the viewer CLI did not start:\n" + "".join(seen))


# ---- the periphery: phase 20 ----------------------------------------------
# the eval CLI's scene: 16 of lod_bench_camera's poses at FRAME, 4 of them
# named in test.txt (load_view caps a view at 1600 pixels wide, as the JAX
# package's does, so the sweep renders 1600x900); the candidate taus from
# which the two smallest that the CLI's default budget (2^18 nodes) and
# max_dup (2^19 entries, 16x8 tiles) hold at every test view are taken,
# beside tau 0, which the budget caps
EVAL_CLI = dict(views=16, test=(1, 5, 9, 13),
                taus=(3.0, 6.0, 15.0, 30.0, 60.0, 120.0, 240.0))
DEBUG_LIMITS = (0.0, 0.001, 0.003, 0.01, 0.03, 0.1)
# LPIPS on the card against the CPU on a 256x256 crop: float32 sums in
# another order move the distance by ~1e-6 relative; TF32 convolutions
# (10-bit mantissas) by ~1e-3. 1e-4 lies between
LPIPS_CROP, LPIPS_RTOL = 256, 1e-4


def lpips_npz(path, seed=0):
    """A VGG16-shaped LPIPS weight set, He-scaled random values from
    default_rng(seed) (no weights are downloaded)."""
    from hlod_gaussians_torch.ops.lpips import TAPS, VGG16_CFG
    rng = np.random.default_rng(seed)
    out, cin, tap_ch = {}, 3, {}
    for item in VGG16_CFG:
        if item == "M":
            continue
        name, cout = item
        out[f"{name}_w"] = rng.normal(0, np.sqrt(2.0 / (cin * 9)), (
            cout, cin, 3, 3)).astype(np.float32)
        out[f"{name}_b"] = rng.normal(0, 0.01, (cout,)).astype(np.float32)
        tap_ch[name], cin = cout, cout
    for i, t in enumerate(TAPS):
        out[f"lin{i}_w"] = rng.uniform(0, 0.1, (1, tap_ch[t], 1, 1)).astype(
            np.float32)
    np.savez(path, **out)
    return path


def write_eval_scene(root, width, height, dev, state, cfg):
    """The eval CLI's COLMAP scene in `root`: EVAL_CLI["views"] of
    lod_bench_camera's poses as one PINHOLE camera of fov 1.2 x 0.8, the
    leaves' flat render of each view as its PNG, test.txt naming
    EVAL_CLI["test"]. Returns the image paths."""
    import torch
    from hlod_gaussians_torch import render
    from hlod_gaussians_torch.data import colmap as cm
    from hlod_gaussians_torch.models import gaussians as gm
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse)
    os.makedirs(os.path.join(root, "images"))
    fx = width / (2.0 * np.tan(0.6))
    fy = height / (2.0 * np.tan(0.4))
    cm.write_cameras_bin(os.path.join(sparse, "cameras.bin"), {
        1: cm.ColmapCamera(1, "PINHOLE", width, height,
                           np.array([fx, fy, width / 2, height / 2]))})
    act = gm.activate(state)
    leaf = state.alive & (state.nodes[:, gm.NODE_CHILD_COUNT] == 0)
    images, paths = {}, []
    for i in range(EVAL_CLI["views"]):
        cam = lod_bench_camera(i, width, height, dev)
        a = 0.02 * i
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]])
        name = f"view_{i:03d}.png"
        images[i + 1] = cm.ColmapImage(
            i + 1, cm.rotmat2qvec(R.T), np.zeros(3), 1, name,
            np.zeros((0, 2)), np.zeros((0,), np.int64))
        with torch.no_grad():
            out = render.render_arrays(
                act.means3d, act.scales, act.quats, act.opacities, act.shs,
                leaf, cam.world_view, cam.full_proj, cam.campos,
                cam.tan_fovx, cam.tan_fovy, torch.zeros(3, device=dev),
                sh_degree=state.sh_degree, width=width, height=height,
                cfg=cfg)
        if bool(out.truncated):
            raise AssertionError(f"eval scene view {i}: truncated")
        paths.append(os.path.join(root, "images", name))
        write_png(paths[-1], torch.clamp(out.image, 0, 1).permute(
            1, 2, 0).cpu().numpy())
    cm.write_images_bin(os.path.join(sparse, "images.bin"), images)
    pts = state.xyz[leaf][::512].cpu().numpy()
    cm.write_points3d_bin(os.path.join(sparse, "points3D.bin"),
                          cm.ColmapPoints(pts, np.full((len(pts), 3), 128,
                                                       np.uint8),
                                          np.zeros(len(pts), np.float32)))
    with open(os.path.join(root, "test.txt"), "w") as f:
        f.write("".join(f"view_{i:03d}\n" for i in EVAL_CLI["test"]))
    return paths


def eval_warnings(warns):
    """eval_views' warnings -> {level: (truncated views, capped views)}."""
    out = {}
    for w in warns:
        m = re.match(r"level ([-\d.e]+): (\d+) view\(s\) truncated .* and "
                     r"(\d+) over the node budget", w)
        if m:
            out[float(m.group(1))] = (int(m.group(2)), int(m.group(3)))
    return out


def run_cli(argv):
    """cli.main(argv) in this process -> (stdout, warnings, B1 and B2
    launches, seconds); the counts start from 0."""
    import contextlib
    import io
    import warnings

    import torch
    from hlod_gaussians_torch import cli
    from hlod_gaussians_torch.ops import rasterize_cuda
    kernel = rasterize_cuda.blend_forward
    kernel_b2 = rasterize_cuda.blend_backward
    buf = io.StringIO()
    kernel.launches = kernel_b2.launches = 0
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught, \
            contextlib.redirect_stdout(buf):
        warnings.simplefilter("always")
        cli.main(argv)
    torch.cuda.synchronize()
    return (buf.getvalue(), [str(w.message) for w in caught],
            (kernel.launches, kernel_b2.launches), time.perf_counter() - t0)


def b1_at_frame(captured, width, height, where, smi):
    """B1 at one frame's captured inputs against its plain version (1e-4,
    n_contrib exact): bare launch, wrapper, plain version and bound (with
    the LOD alpha's operations when the frame has them) -> (numbers,
    error)."""
    from hlod_gaussians_torch.ops import rasterize_cuda
    from hlod_gaussians_torch.ops.rasterize_xla import blend_forward_plain
    import torch
    kernel = rasterize_cuda.blend_forward
    fa, fopts = captured
    fargs = tuple(a.detach() for a in fa)
    got = kernel(*fargs, **fopts)
    torch.cuda.synchronize()
    ref = blend_forward_plain(*fargs, **fopts)
    err = compare(where, got, ref, FRAME_ATOL)
    del got, ref
    evaluated, applied, cand, read = work_of_frame(
        *fargs, width, height, fopts["tile_w"], fopts["tile_h"],
        fopts["t_eps"], fopts["alpha_min"], use_lod=fopts["use_lod"])
    n_bytes, n_read, n_rows = frame_bytes(fargs, read, width, height,
                                          4 * 4 + 4 + 4)
    ops = OPS_EVAL * evaluated + OPS_APPLY * applied + (
        OPS_LOD * cand if fopts["use_lod"] else 0)
    b_ms, b_by, parts = bound(n_bytes, ops)
    out = dict(ms=bare_launch_ms(fargs, fopts),
               wrapper_ms=cuda_time_ms(lambda: kernel(*fargs, **fopts), 20,
                                       warmup=3),
               plain_ms=cuda_time_ms(lambda: blend_forward_plain(
                   *fargs, **fopts), 2),
               bound_ms=b_ms, bound_by=b_by, entries=int(fargs[3].sum()))
    log(f"  B1 at the {where} ({width}x{height}, {fopts['tile_w']}x"
        f"{fopts['tile_h']} tiles, LOD {fopts['use_lod']}): "
        f"{out['entries']} entries ({n_read} read naming {n_rows} rows), "
        f"{evaluated} evaluated, {cand} candidate and {applied} applied "
        f"pairs; launch {out['ms']:.4f} ms, wrapper {out['wrapper_ms']:.4f} "
        f"ms, plain version {out['plain_ms']:.2f} ms, bound {b_ms:.4f} ms "
        f"({b_by}; {parts}) [{smi}]")
    return out, err


def periphery_phase(dev, smi, root, dhier_path, width=None, height=None):
    """Phase 20 on the phase-[6] tree (`dhier_path`, as phase [19] wrote
    it): (a) create-hierarchy, port and native, from its leaves as a PLY;
    (b) the eval CLI on the .dhier and on the tree as an upstream .hier,
    and in a subprocess; (d) the debug renders; (c) LPIPS on the card on
    two of them; (e) the native image loader; (f) B1 at an eval frame. Returns the B1
    launches of the eval CLI and debug paths, B1's numbers at the eval
    frame and the largest kernel-vs-plain error."""
    import torch
    from hlod_gaussians_torch import debug, native, render
    from hlod_gaussians_torch.config import RasterizerConfig
    from hlod_gaussians_torch.data import dhier as dhier_io
    from hlod_gaussians_torch.data import ply as ply_io
    from hlod_gaussians_torch.data.scene import load_colmap_scene, load_view
    from hlod_gaussians_torch.hierarchy import boxes as boxes_mod
    from hlod_gaussians_torch.hierarchy import cut as cut_mod
    from hlod_gaussians_torch.hierarchy.cut import sanity_check_hierarchy
    from hlod_gaussians_torch.models import gaussians as gm
    from hlod_gaussians_torch.ops import rasterize_cuda
    from hlod_gaussians_torch.ops.lpips import make_lpips
    from hlod_gaussians_torch.train.post import create_from_dhier
    kernel = rasterize_cuda.blend_forward
    kernel_b2 = rasterize_cuda.blend_backward
    width, height = width or FRAME[0], height or FRAME[1]
    t_phase = time.perf_counter()
    d = dhier_io.load_dhier(dhier_path)
    m = d.nodes.shape[0]
    n_leaves = int((d.nodes[:, gm.NODE_CHILD_COUNT] == 0).sum())
    out = os.path.join(root, "periphery")
    os.makedirs(out)
    log(f"[20] the periphery on the {m}-node LOD bench tree: "
        "create-hierarchy, eval, LPIPS, debug, the native loader")

    # ---- (a) create-hierarchy, the port's builder and the C++ creator ------
    pts, scales, quats, ops, shs = lod_bench_leaves(n_leaves)
    ply = os.path.join(out, "leaves.ply")
    ply_io.save_gaussian_ply(ply, ply_io.GaussianPly(
        xyz=pts, f_dc=shs[:, :1], f_rest=shs[:, 1:],
        opacity=np.log(ops / (1.0 - ops)).astype(np.float32),
        log_scale=np.log(scales).astype(np.float32), quat=quats))
    trees = {}
    for name, extra in (("port", []), ("native", ["--native"])):
        path = os.path.join(out, f"{name}.dhier")
        printed, _, launches, secs = run_cli(["create-hierarchy", ply, path]
                                             + extra)
        t = dhier_io.load_dhier(path)
        sanity_check_hierarchy(t.nodes, np.ones(t.nodes.shape[0], bool))
        gdf = os.path.splitext(path)[0] + ".gdf"
        trees[name] = t
        log(f"  create-hierarchy{' --native' if extra else ''}: "
            f"{t.nodes.shape[0]} nodes in {secs:.2f} s (build, .dhier and "
            f".gdf of {os.path.getsize(gdf)} bytes); {printed.strip()}")
        if t.nodes.shape[0] != m or launches != (0, 0):
            raise AssertionError(f"create-hierarchy {name}: "
                                 f"{t.nodes.shape[0]} nodes, launches "
                                 f"{launches}")
    roots = {k: int(np.where(t.nodes[:, gm.NODE_PARENT] == -1)[0][0])
             for k, t in trees.items()}
    tp, tn = trees["port"], trees["native"]
    rp, rn = roots["port"], roots["native"]
    lex = lambda a: a[np.lexsort(a.T[::-1])]
    leaf_sets = [lex(t.pos[t.nodes[:, gm.NODE_CHILD_COUNT] == 0])
                 for t in (tp, tn)]
    root_err = (float(np.abs(tp.pos[rp] - tn.pos[rn]).max()),
                float(np.abs(np.sort(np.exp(tp.log_scale[rp]))
                             / np.sort(np.exp(tn.log_scale[rn])) - 1).max()),
                float(abs(tp.opacity[rp] / tn.opacity[rn] - 1)))
    log(f"  roots: |d pos| {root_err[0]:.3e}, scales {root_err[1]:.3e} and "
        f"opacity {root_err[2]:.3e} relative; leaf positions equal as sets "
        f"{np.array_equal(leaf_sets[0], leaf_sets[1])}")
    if (root_err[0] > 1e-3 or root_err[1] > 1e-2 or root_err[2] > 1e-2
            or not np.array_equal(leaf_sets[0], leaf_sets[1])
            or not np.array_equal(leaf_sets[0], lex(pts))):
        raise AssertionError("the port's and the native creator's trees "
                             "disagree")
    del trees, tp, tn, leaf_sets

    # ---- (b) the eval CLI -----------------------------------------------------
    state = create_from_dhier(d, capacity=1 << int(np.ceil(np.log2(m + 1))),
                              device=dev)
    cfg = RasterizerConfig(backend="pallas", tile_w=32, tile_h=32,
                           max_dup=1 << 21, tight_binning=True)
    scene = os.path.join(out, "scene")
    t0 = time.perf_counter()
    png_paths = write_eval_scene(scene, width, height, dev, state, cfg)
    scene_s = time.perf_counter() - t0
    weights = lpips_npz(os.path.join(out, "lpips_vgg16.npz"))
    cams = [load_view(c, device=dev) for c in
            load_colmap_scene(scene, eval_split=True).test_cameras]
    ew, eh = cams[0].width, cams[0].height
    nb = boxes_mod.compute_node_boxes(
        state.nodes.cpu().numpy(), state.xyz.cpu().numpy(),
        np.exp(state.log_scale.cpu().numpy()).max(-1),
        alive=state.alive.cpu().numpy())
    boxes = tuple(torch.as_tensor(b, device=dev)
                  for b in (nb.lo, nb.hi, nb.max_side))
    eval_cfg = RasterizerConfig(backend="pallas", tile_w=16, tile_h=8)
    # the levels: the JAX package's protocol on the candidates; its warning
    # names each level with a truncated (max_dup) or capped (budget) view
    from hlod_gaussians_torch import eval as eval_mod
    warned = []
    probe = eval_mod.eval_views(state, cams, [c.image for c in cams],
                                (0.0,) + EVAL_CLI["taus"], level_is_tau=True,
                                boxes=boxes, cfg=eval_cfg, warn=warned.append)
    degraded = eval_warnings(warned)
    held = [t for t in EVAL_CLI["taus"] if degraded.get(t, (0, 0))[1] == 0]
    log(f"  {len(png_paths)} views at {width}x{height} written in "
        f"{scene_s:.1f} s; the test views load at {ew}x{eh}; (mean "
        "rendered, truncated views, capped views) at the candidate taus "
        + ", ".join(f"{r.level:g}: ({r.mean_rendered:.1f}, "
                    f"{degraded.get(r.level, (0, 0))[0]}, "
                    f"{degraded.get(r.level, (0, 0))[1]})" for r in probe))
    if degraded.get(0.0, (0, 0))[1] != len(cams) or len(held) < 2:
        raise AssertionError("no two candidate taus the default budget "
                             "holds, or tau 0 not capped")
    levels = [0.0] + held[:2]
    del probe
    argv = ["--tau", "--levels", ",".join(f"{x:g}" for x in levels),
            "--lpips_weights", weights, "--debug", "-s", scene]
    hier = os.path.join(out, "tree.hier")
    t0 = time.perf_counter()
    dhier_io.save_hier(hier, boxes_mod.dhier_to_upstream(d))
    hier_s = time.perf_counter() - t0
    routes = {}
    for route, path in ((".dhier --tau", dhier_path), (".hier", hier)):
        printed, warns, launches, secs = run_cli(
            ["eval", "--hierarchy", path] + argv)
        rows = [json.loads(x) for x in printed.splitlines()
                if x.startswith("{")]
        curve = [x for x in printed.splitlines() if x.startswith("[debug]")]
        routes[route] = (rows, curve)
        log(f"  eval {route}: {secs:.2f} s, B1 launches {launches[0]}, B2 "
            f"{launches[1]}; {curve[0] if curve else 'no [debug] line'}")
        for r in rows:
            log(f"    tau {r['level']:g}: PSNR {r['psnr']}  SSIM "
                f"{r['ssim']}  GMSD {r['gmsd']}  LPIPS {r['lpips']:.6f}  "
                f"mean rendered {r['mean_rendered']}")
        log(f"    warnings: {warns}")
        rendered = [r["mean_rendered"] for r in rows]
        capped = [lv for lv, (_, n) in eval_warnings(warns).items() if n]
        finite = all(np.isfinite([r[k] for k in ("psnr", "ssim", "gmsd",
                                                 "lpips")]).all()
                     for r in rows)
        if (len(rows) != len(levels) or not finite or len(curve) != 1
                or any(a < b for a, b in zip(rendered, rendered[1:]))
                or capped != [0.0]
                or eval_warnings(warns)[0.0][1] != len(cams)
                or launches != (len(levels) * len(cams), 0)):
            raise AssertionError(f"eval {route}: rows {rows}, warnings "
                                 f"{warns}, launches {launches}")
    if routes[".dhier --tau"][1] != routes[".hier"][1] or [
            r["mean_rendered"] for r in routes[".dhier --tau"][0]] != [
            r["mean_rendered"] for r in routes[".hier"][0]]:
        raise AssertionError("the .dhier and .hier routes select different "
                             "node counts")
    log(f"  the .hier written in {hier_s:.1f} s; both routes print the same "
        "node counts")
    eval_launches = len(levels) * len(cams) * 2
    cmd = [sys.executable, "-m", "hlod_gaussians_torch.cli", "eval",
           "--hierarchy", dhier_path, "-s", scene, "--tau", "--levels",
           f"{levels[1]:g}"]
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    rows = [json.loads(x) for x in proc.stdout.splitlines()
            if x.startswith("{")]
    log(f"  python -m hlod_gaussians_torch.cli eval --levels {levels[1]:g}: "
        f"exit {proc.returncode} in {time.perf_counter() - t0:.1f} s, "
        f"{rows}")
    if (proc.returncode != 0 or len(rows) != 1 or rows[0]["mean_rendered"]
            != routes[".dhier --tau"][0][1]["mean_rendered"]):
        raise AssertionError("the eval CLI subprocess failed:\n"
                             + proc.stdout[-3000:] + proc.stderr[-3000:])

    # ---- (d) debug --------------------------------------------------------------
    cam = lod_bench_camera(0, width, height, dev)
    act = gm.activate(state)
    leaf = state.alive & (state.nodes[:, gm.NODE_CHILD_COUNT] == 0)
    with torch.no_grad():
        flat = torch.clamp(render.render_arrays(
            act.means3d, act.scales, act.quats, act.opacities, act.shs, leaf,
            cam.world_view, cam.full_proj, cam.campos, cam.tan_fovx,
            cam.tan_fovy, torch.zeros(3, device=dev),
            sh_degree=state.sh_degree, width=width, height=height,
            cfg=cfg).image, 0, 1).cpu().numpy()
    del act
    kernel.launches = kernel_b2.launches = 0
    t0 = time.perf_counter()
    img0, n0 = debug.render_depth_slice(state, cam, 0, cfg=cfg)
    slices = debug.render_level_slices(state, cam, cfg=cfg)
    torch.cuda.synchronize()
    debug_s = time.perf_counter() - t0
    debug_launches = (kernel.launches, kernel_b2.launches)
    curve = debug.gaussians_per_limit(state, cam.campos,
                                      cam.world_view[:3, 2], DEBUG_LIMITS)
    counts = [n for _, n in slices]
    leaf0 = int(torch.nonzero(leaf)[0])
    path = debug.path_to_root(state, leaf0)
    top = int(torch.nonzero(state.nodes[:, gm.NODE_PARENT] == -1)[0])
    kids = torch.nonzero(state.nodes[:, gm.NODE_PARENT] == top)[:, 0]
    cols = debug.false_color_by_subtree(state, kids.tolist())
    slice_err = float(np.abs(img0 - flat).max())
    log(f"  debug at {width}x{height}: depth-0 slice {n0} nodes, "
        f"max|d| {slice_err:.3e} from the leaves' flat render; level slices "
        f"{counts}; gaussians_per_limit {list(DEBUG_LIMITS)}: {curve}; "
        f"path_to_root of leaf {leaf0}: {path.shape[0]} points; "
        f"false colours of {len(kids)} subtrees {cols.shape}; "
        f"{debug_launches[0]} B1 launches for {1 + len(slices)} renders in "
        f"{debug_s:.2f} s")
    if (n0 != n_leaves or slice_err > FRAME_ATOL or counts[0] != n_leaves
            or any(x <= y for x, y in zip(counts, counts[1:]))
            or any(x < y for x, y in zip(curve, curve[1:]))
            or path.shape[0] != int(state.nodes[leaf0, gm.NODE_DEPTH]) + 1
            or debug_launches != (1 + len(slices), 0)
            or not all(np.isfinite(x).all() for x, _ in slices)):
        raise AssertionError("the debug renders disagree")

    # ---- (c) LPIPS on the card: the leaves' render and their parents' -----
    pair = [torch.as_tensor(x, device=dev) for x in (flat, slices[1][0])]
    del slices, img0, flat
    lp_card = make_lpips(weights, device=dev)
    lp_cpu = make_lpips(weights, device=torch.device("cpu"))
    y0, x0 = (height - LPIPS_CROP) // 2, (width - LPIPS_CROP) // 2
    crop = [x[:, y0:y0 + LPIPS_CROP, x0:x0 + LPIPS_CROP] for x in pair]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True       # PyTorch's default
    try:
        on_card = float(lp_card(*crop))
        on_cpu = float(lp_cpu(*(x.cpu() for x in crop)))
        lp_hd = float(lp_card(*pair))
        lp_ms = cuda_time_ms(lambda: lp_card(*pair), 5, warmup=1)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    rel = abs(on_card / on_cpu - 1)
    log(f"  LPIPS (seeded VGG16 weights), leaves vs parents at camera 0: "
        f"{LPIPS_CROP}x{LPIPS_CROP} crop card {on_card:.8f} vs CPU "
        f"{on_cpu:.8f} ({rel:.2e} relative, bound {LPIPS_RTOL:g}, "
        f"cudnn.allow_tf32 on outside the call); {width}x{height} pair "
        f"{lp_hd:.6f} in {lp_ms:.2f} ms [{smi}]")
    if not rel <= LPIPS_RTOL or not np.isfinite(lp_hd):
        raise AssertionError("LPIPS on the card disagrees with the CPU")
    del lp_card, lp_cpu, pair, crop

    # ---- (e) the native image loader ---------------------------------------------
    loader = native.NativeImageLoader(png_paths, n_threads=8, max_width=0)
    t0 = time.perf_counter()
    loader.prefetch(list(range(len(png_paths))))
    imgs = [loader.get(i) for i in range(len(png_paths))]
    load_s = time.perf_counter() - t0
    load_err = max(float(np.abs(x - loader._pil_get(i)).max())
                   for i, x in enumerate(imgs))
    library = loader.library
    loader.close()
    if library != "image_loader":
        try:
            native.build("image_loader")
        except RuntimeError as e:
            log("  the loader library does not build here: "
                + " | ".join(x for x in str(e).splitlines()
                             if "error" in x)[:300])
    log(f"  NativeImageLoader: {len(imgs)} {width}x{height} PNGs in "
        f"{load_s:.2f} s through {library} (libraries that build here: "
        f"{native.native_available()}), max|d| from PIL {load_err:.1e}")
    if load_err > 1e-6 or imgs[0].shape != (3, height, width):
        raise AssertionError("the native loader disagrees with PIL")

    # ---- (f) B1 at an eval frame ----------------------------------------------------
    view = cams[0]
    pcache = cut_mod.build_parent_cache_box(state.nodes, *boxes)
    act = gm.activate(state)
    itab = cut_mod.build_interp_table(
        dict(means3d=act.means3d, scales=act.scales, quats=act.quats,
             opacities=act.opacities, shs=act.shs), state.nodes)
    target = max(float(render.tau_to_threshold(levels[1], float(
        view.tan_fovx), ew)), 1e-12)

    def eval_frame():
        with torch.no_grad():
            return render.render_lod(
                act.means3d, act.scales, act.quats, act.opacities, act.shs,
                state.nodes, state.alive, view.world_view, view.full_proj,
                view.campos, view.tan_fovx, view.tan_fovy,
                torch.zeros(3, device=dev), target, boxes, None, pcache,
                None, itab, sh_degree=state.sh_degree, width=ew, height=eh,
                budget=1 << 18, n_skybox=state.n_skybox, cfg=eval_cfg)

    res, n_sel = eval_frame()
    with torch.no_grad():
        need = int(render.render_lod(
            act.means3d, act.scales, act.quats, act.opacities, act.shs,
            state.nodes, state.alive, view.world_view, view.full_proj,
            view.campos, view.tan_fovx, view.tan_fovy,
            torch.zeros(3, device=dev), target, boxes, None, pcache, None,
            itab, sh_degree=state.sh_degree, width=ew, height=eh,
            budget=1 << 18, n_skybox=state.n_skybox,
            cfg=dataclasses.replace(eval_cfg, max_dup=1 << 24))[0].n_dup)
    log(f"  the eval frame: {int(n_sel)} nodes, {int(res.n_dup)} entries "
        f"kept of the {need} it needs (max_dup {eval_cfg.max_dup}), "
        f"truncated {bool(res.truncated)}")
    del res
    b1, b1_err = b1_at_frame(capture_b1_inputs(eval_frame), ew, eh,
                             f"eval frame (tau {levels[1]:g}, test view 0)",
                             smi)
    b1["tau"] = levels[1]
    log(f"  phase [20] in {time.perf_counter() - t_phase:.1f} s")
    return dict(b1={"eval_cli": eval_launches, "debug": debug_launches[0]},
                b2={"eval_cli": 0, "debug": debug_launches[1]},
                b1_frame=b1, b1_err=b1_err)


BENCH_KEYS = ("metric", "value", "unit", "vs_baseline",
              "lod_stream_tau0_mpix_s", "lod_stream_tau15_mpix_s")
BENCH_DEADLINE_S = 300


def bench_phase(smi):
    """[21] bench_torch.py in a subprocess on the card, reusing the kernels
    phase [1] built: exit 0 and its last stdout line bench.py's six keys,
    none null. Returns its (B1, B2) launches, which its last stderr note
    counts."""
    log("[21] bench_torch.py, the twin of bench.py, in a subprocess")
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench_torch.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=BENCH_DEADLINE_S)
    sec = time.perf_counter() - t0
    for line in run.stderr.splitlines():
        log("  " + line)
    if run.returncode != 0:
        raise AssertionError(f"bench_torch.py exited {run.returncode}")
    line = json.loads(run.stdout.strip().splitlines()[-1])
    if tuple(line) != BENCH_KEYS or any(line[k] is None for k in BENCH_KEYS):
        raise AssertionError(f"bench_torch.py printed {line}")
    counts = re.findall(r"kernel launches: B1 (\d+), B2 (\d+)", run.stderr)
    launches = tuple(int(c) for c in counts[-1]) if counts else (0, 0)
    log(f"  {json.dumps(line)}; B1 {launches[0]} and B2 {launches[1]} "
        f"launches; {sec:.1f} s with the start [{smi}]")
    if 0 in launches:
        raise AssertionError(f"the bench launched B1 / B2 {launches} times")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke "
              "test runs only on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from hlod_gaussians_torch import convert, optim, render
    from hlod_gaussians_torch.config import RasterizerConfig
    from hlod_gaussians_torch.data.dhier import load_dhier
    from hlod_gaussians_torch.models import gaussians as gm
    from hlod_gaussians_torch.ops import gaussian_math, sh as sh_ops
    from hlod_gaussians_torch.ops import rasterize_cuda
    from hlod_gaussians_torch.ops.binning import bin_gaussians
    from hlod_gaussians_torch.ops.lod_preprocess import lod_preprocess
    from hlod_gaussians_torch.ops.rasterize import rasterize_tiles
    from hlod_gaussians_torch.ops.rasterize_xla import (blend_backward_plain,
                                                        blend_features,
                                                        blend_forward_plain)
    from hlod_gaussians_torch.ops.train_preprocess import (
        train_preprocess_forward)
    from hlod_gaussians_torch.train import flat
    from hlod_gaussians_torch.train.post import create_from_dhier
    from hlod_gaussians_torch.utils.camera import make_camera

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernel = rasterize_cuda.blend_forward
    kernel_b2 = rasterize_cuda.blend_backward
    t_start = time.perf_counter()

    # ---- 1. card and build ---------------------------------------------
    smi = nvidia_smi_line()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    built = rasterize_cuda.build()
    for name in built:
        rasterize_cuda._library(name)
    log("[1] built " + ", ".join(os.path.relpath(path, ROOT)
                                 for path, _ in built.values())
        + f" in {time.perf_counter() - t0:.2f} s")
    for name, (_, build_log) in built.items():
        for kernel_name, line in ptxas_lines(build_log):
            log(f"    ptxas {kernel_name}: {line}")

    # ---- 2. kernel vs plain --------------------------------------------
    log("[2] kernel vs plain version")
    max_err = 0.0
    cases = [
        # name, (tile_w, tile_h), scene kwargs, want_seen
        ("16x16 seen", (16, 16), dict(n=2000, seed=5), True),
        ("16x16", (16, 16), dict(n=2000, seed=5), False),
        ("32x32 lod seen", (32, 32), dict(n=2000, seed=7, lod=True), True),
        ("32x32 lod", (32, 32), dict(n=2000, seed=7, lod=True), False),
        ("8x128 seen", (8, 128), dict(n=2000, seed=9, lod=True), True),
        ("16x16 dense saturated", (16, 16), dict(n=4000, seed=3, big=True),
         True),
        ("16x8 sticky", (16, 8), dict(n=600, seed=7, stacked=True), True),
        ("16x16 sticky", (16, 16), dict(n=600, seed=7, stacked=True), True),
        # B1 and B2 run 4 pixels a thread on the tiles above, 2 on 8x8 and
        # 8x24, 1 on 8x4 and 12x8; ragged frames cut the last tile row and
        # column
        ("8x4", (8, 4), dict(n=2000, seed=11), False),
        ("8x4 sticky", (8, 4), dict(n=600, seed=7, stacked=True), True),
        ("8x8 lod", (8, 8), dict(n=2000, seed=13, lod=True), False),
        ("8x24 ragged", (8, 24), dict(n=2000, seed=15, frame=(250, 190)),
         False),
        ("12x8 ragged lod", (12, 8), dict(n=2000, seed=17, lod=True,
                                          frame=(250, 190)), False),
        ("32x32 ragged seen", (32, 32), dict(n=2000, seed=19,
                                             frame=(250, 190)), True),
        # B1 alone: one pixel a thread in row order, the last warp partial
        ("10x6 partial warp seen", (10, 6), dict(n=2000, seed=21), True),
        ("10x6 ragged lod", (10, 6), dict(n=2000, seed=23, lod=True,
                                          frame=(250, 190)), False),
    ]
    b2_cases = {}      # B2's cases: the scenes above, once each
    for name, (tw, th), kw, want_seen in cases:
        kw = dict(kw)
        sw, shh = kw.pop("frame", (256, 192))
        p, color, ts, kids = small_scene(dev, width=sw, height=shh, **kw)
        bins, feats = blend_inputs(p, color, ts, kids, sw, shh, tw, th,
                                   1 << 20, tight=not kw.get("stacked"))
        if bool(bins.overflow):
            raise AssertionError(f"{name}: max_dup overflow")
        args = (feats, bins.sorted_gid, bins.tile_starts, bins.tile_counts)
        opts = dict(width=sw, height=shh, tile_w=tw, tile_h=th,
                    use_lod=ts is not None, want_seen=want_seen)
        got = kernel(*args, **opts)
        torch.cuda.synchronize()
        ref = blend_forward_plain(*args, **opts)
        max_err = max(max_err, compare(name, got, ref, SMALL_ATOL))
        if "saturated" in name or "sticky" in name:
            # saturated pixel: T stopped within one entry of t_eps
            nc_sat = int(ref[2].flatten()[int(ref[1].argmin())])
            log(f"    min final_t {float(ref[1].min()):.3e} at a pixel with "
                f"n_contrib {nc_sat}")
            if float(ref[1].min()) >= 2e-4:
                raise AssertionError(f"{name}: no saturated pixel")
            if "sticky" in name and nc_sat <= 2 * B1_BATCH:
                raise AssertionError(f"{name}: stop does not cross several "
                                     "entry batches")
        if tw * th % 32 == 0:
            b2_cases.setdefault(name.replace(" seen", ""), (args, opts, got))

    width, height = 1920, 1080
    cfg = RasterizerConfig(backend="pallas", tile_w=32, tile_h=32,
                           max_dup=352 * 1024, tight_binning=True)
    scene = load_bench_scene()
    n_g = scene["xyz"].shape[0]
    means = torch.as_tensor(scene["xyz"], device=dev)
    scales = torch.exp(torch.as_tensor(scene["log_scale"], device=dev))
    quats = torch.as_tensor(scene["quat"], device=dev)
    quats = quats / torch.linalg.norm(quats, dim=-1, keepdim=True)
    opac = torch.sigmoid(torch.as_tensor(scene["opacity_logit"][:, 0],
                                         device=dev))
    shs = torch.cat([torch.as_tensor(scene["f_dc"], device=dev),
                     torch.as_tensor(scene["f_rest"], device=dev)], dim=1)
    valid = torch.ones((n_g,), dtype=torch.bool, device=dev)
    bg = torch.zeros(3, device=dev)

    def bench_camera(yaw_deg):
        a = np.deg2rad(yaw_deg)
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]])
        return make_camera(R, np.zeros(3), 1.2, 0.8, width, height,
                           device=dev)

    cam0 = bench_camera(0.0)

    def project_and_color(cam):
        cov6 = gaussian_math.compute_cov3d(scales, quats)
        p = gaussian_math.project_gaussians(
            means, cov6, opac, cam.world_view, cam.full_proj, width, height,
            cam.focal_x, cam.focal_y, cam.tan_fovx, cam.tan_fovy,
            dilation=cfg.dilation, near=cfg.near, valid_in=valid)
        return p, sh_ops.sh_color(3, shs, means, cam.campos)

    p0, color0 = project_and_color(cam0)
    bins0, feats0 = blend_inputs(p0, color0, None, None, width, height, 32,
                                 32, cfg.max_dup, tight=True)
    frame_args = (feats0, bins0.sorted_gid, bins0.tile_starts,
                  bins0.tile_counts)
    frame_opts = dict(width=width, height=height, tile_w=32, tile_h=32)
    got = kernel(*frame_args, **frame_opts)
    torch.cuda.synchronize()
    ref = blend_forward_plain(*frame_args, **frame_opts)
    max_err = max(max_err, compare("1080p bench frame", got, ref,
                                   FRAME_ATOL, FRAME_NC_SHARE))
    again = kernel(*frame_args, **frame_opts)
    same = all(torch.equal(a, b) for a, b in zip(got[:3], again[:3]))
    log(f"  1080p bench frame: second launch bitwise equal {same}")
    if not same:
        raise AssertionError("kernel B1 is not repeatable at the bench frame")
    del again

    # kernel, plain version and bound at the bench frame
    kernel_ms = cuda_time_ms(lambda: kernel(*frame_args, **frame_opts), 20,
                             warmup=3)
    plain_ms = cuda_time_ms(lambda: blend_forward_plain(*frame_args,
                                                        **frame_opts), 3)
    evaluated, applied, _, read = work_of_frame(
        *frame_args, width, height, 32, 32, cfg.t_eps, cfg.alpha_min)
    num_dup = int(bins0.num_dup)
    bytes_moved, n_read, n_rows = frame_bytes(frame_args, read, width,
                                              height, 4 * 4 + 4 + 4)
    ops = OPS_EVAL * evaluated + OPS_APPLY * applied
    bound_ms, bound_by, parts = bound(bytes_moved, ops)
    log(f"  bench frame: {num_dup} entries ({n_read} read, naming {n_rows} "
        f"of {n_g} rows), {evaluated} evaluated and {applied} applied "
        f"(entry, pixel) pairs, {ops:.4e} f32 ops, {bytes_moved} bytes")
    log(f"  blend_forward kernel {kernel_ms:.4f} ms, plain version "
        f"{plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({bound_by}; {parts}) "
        f"[{smi}]")

    # ---- 2b. kernel B2 vs plain -----------------------------------------
    log("[2b] kernel B2 (blend backward) vs plain version")
    gen = torch.Generator(device=dev).manual_seed(0)
    b2_err = 0.0
    for name, (args, opts, fwd) in b2_cases.items():
        b2_err = max(b2_err, check_backward(name, args, opts, fwd, gen)[0])
    err, (b2_args, b2_opts) = check_backward(
        "1080p bench frame", frame_args, dict(frame_opts, use_lod=False),
        got, gen)
    b2_err = max(b2_err, err)
    b2_ms = cuda_time_ms(lambda: kernel_b2(*b2_args, **b2_opts), 20,
                         warmup=3)
    b2_plain_ms = cuda_time_ms(lambda: blend_backward_plain(*b2_args,
                                                            **b2_opts), 3)
    # the kernel walks every pixel of a tile down from the tile's largest
    # n_contrib
    needed, b2_bytes, b2_ops, b2_walk, b2_rows = b2_work(
        frame_args, got, applied, width, height)
    b2_bound_ms, b2_bound_by, b2_parts = bound(b2_bytes, b2_ops)
    log(f"  bench frame: {needed} needed, {applied} applied and "
        f"{b2_walk * 32 * 32} walked (entry, pixel) pairs, {b2_walk} entries "
        f"walked naming {b2_rows} rows, {b2_ops:.4e} f32 ops, {b2_bytes} "
        "bytes")
    log(f"  blend_backward kernel {b2_ms:.4f} ms, plain version "
        f"{b2_plain_ms:.2f} ms, bound {b2_bound_ms:.4f} ms ({b2_bound_by}; "
        f"{b2_parts}) [{smi}]")

    # ---- 3. flat serving: the main path ---------------------------------
    log("[3] flat serving: 8 requests, render_arrays 1920x1080, "
        f"{n_g} Gaussians, SH 3")
    cams = [bench_camera(a) for a in np.linspace(-3.5, 3.5, 8)]

    def serve(cam):
        with torch.no_grad():
            return render.render_arrays(
                means, scales, quats, opac, shs, valid, cam.world_view,
                cam.full_proj, cam.campos, cam.tan_fovx, cam.tan_fovy, bg,
                sh_degree=3, width=width, height=height, cfg=cfg)

    kernel.launches = kernel_b2.launches = 0
    outs = [serve(cam) for cam in cams]
    torch.cuda.synchronize()
    flat_launches, flat_b2 = kernel.launches, kernel_b2.launches
    for i, out in enumerate(outs):
        if bool(out.truncated) or not bool(torch.isfinite(out.image).all()):
            raise AssertionError(f"request {i}: truncated or non-finite")
        if tuple(out.image.shape) != (3, height, width):
            raise AssertionError(f"request {i}: image {tuple(out.image.shape)}")
    log(f"  8 requests untruncated and finite; entries per request "
        f"{[int(o.n_dup) for o in outs]}; kernel launches {flat_launches}")
    if flat_launches != len(cams) or flat_b2 != 0:
        raise AssertionError(f"{flat_launches} B1 and {flat_b2} B2 launches "
                             f"for {len(cams)} requests")
    del outs

    frame_ms = []
    for _ in range(2):                                    # warm-up
        serve(cams[0])
    for cam in cams * 2:
        frame_ms.append(cuda_time_ms(lambda: serve(cam), 1, warmup=0))
    host = []
    for cam in cams:
        t0 = time.perf_counter()
        serve(cam)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    proj_ms = cuda_time_ms(lambda: project_and_color(cam0), 10)
    bin_ms = cuda_time_ms(lambda: bin_gaussians(
        p0.xy, p0.depth, p0.radius, p0.valid, width, height, 32, 32,
        cfg.max_dup, ext=p0.ext, reff2=p0.reff2), 10)
    blend_ms = cuda_time_ms(lambda: rasterize_tiles(
        bins0, blend_features(p0.xy, p0.conic, p0.opacity, color0,
                              1.0 / torch.clamp_min(p0.depth, 1e-6)),
        bg, width=width, height=height, tile_w=32, tile_h=32), 10)
    log(f"  frame median {statistics.median(frame_ms):.3f} ms on the card "
        f"(CUDA events, {len(frame_ms)} frames), host wall median "
        f"{statistics.median(host):.3f} ms")
    log(f"  split: project+SH {proj_ms:.3f} ms, binning {bin_ms:.3f} ms, "
        f"blend {blend_ms:.3f} ms (kernel {kernel_ms:.3f} ms) [{smi}]")

    # ---- 4. LOD serving ------------------------------------------------
    log("[4] LOD serving: oracle hierarchy + 100k skybox, render_lod 1080p")
    d = load_dhier(os.path.join(ROOT, "tests", "fixtures", "oracle",
                                "hierarchy.dhier.gz"))
    g = d.pos.shape[0]
    scene_radius = float(np.linalg.norm(d.pos, axis=1).max())
    state = create_from_dhier(d, capacity=g + 100_000, skybox_num=100_000,
                              scene_radius=scene_radius, device=dev)
    act = gm.activate(state)
    # 16 units in front of the tree's near face, so the three granularities
    # cut it at different depths (the whole 12-unit tree stays in view)
    lod_cam = make_camera(np.eye(3), np.array([0.0, 0.0, 16.0]), 1.2, 0.8,
                          width, height, device=dev)
    budget = 2048
    lod_cfg = RasterizerConfig(backend="pallas", tile_w=32, tile_h=32,
                               max_dup=1 << 21, tight_binning=True)

    def serve_lod(tau, cfg_):
        target = render.tau_to_threshold(tau, lod_cam.tan_fovx, width)
        with torch.no_grad():
            return render.render_lod(
                act.means3d, act.scales, act.quats, act.opacities, act.shs,
                state.nodes, state.alive, lod_cam.world_view,
                lod_cam.full_proj, lod_cam.campos, lod_cam.tan_fovx,
                lod_cam.tan_fovy, bg, target,
                sh_degree=d.sh_degree, width=width, height=height,
                budget=budget, n_skybox=state.n_skybox, cfg=cfg_, k_max=8192)

    taus = (0.0, 3.0, 15.0)
    kernel.launches = kernel_b2.launches = 0
    lod_out = [serve_lod(tau, lod_cfg) for tau in taus]
    torch.cuda.synchronize()
    lod_launches, lod_b2 = kernel.launches, kernel_b2.launches
    n_sel = [int(n) for _, n in lod_out]
    for tau, (out, n) in zip(taus, lod_out):
        if bool(out.truncated) or not bool(torch.isfinite(out.image).all()):
            raise AssertionError(f"LOD tau {tau}: truncated or non-finite")
        log(f"  tau {tau:4.1f}: n_selected {int(n)} of {g} nodes, entries "
            f"{int(out.n_dup)}, image mean {float(out.image.mean()):.4f}")
    if (lod_launches != len(taus) or lod_b2 != 0
            or not n_sel[0] >= n_sel[1] >= n_sel[2] > 0):
        raise AssertionError(f"LOD: launches {lod_launches} (B2 {lod_b2}), "
                             f"n_selected {n_sel}")
    lod_ms = {tau: cuda_time_ms(lambda: serve_lod(tau, lod_cfg), 5)
              for tau in taus}
    log("  frame median " + ", ".join(f"tau {t}: {ms:.3f} ms"
                                      for t, ms in lod_ms.items())
        + f" [{smi}]")
    plain_cfg = RasterizerConfig(backend="xla", tile_w=32, tile_h=32,
                                 max_dup=1 << 22)
    plain_out, plain_n = serve_lod(3.0, plain_cfg)
    lod_err = float((plain_out.image - lod_out[1][0].image).abs().max())
    log(f"  tau 3 vs plain (xla) path: max|d image| {lod_err:.3e}, "
        f"n_selected {int(plain_n)} vs {n_sel[1]}, plain truncated "
        f"{bool(plain_out.truncated)}")
    if (lod_err > FRAME_ATOL or int(plain_n) != n_sel[1]
            or bool(plain_out.truncated)):
        raise AssertionError("LOD render disagrees with the plain path")
    max_err = max(max_err, lod_err)

    del lod_out, plain_out, state, act

    # ---- 5. training ---------------------------------------------------
    log("[5] training: train.flat.train_step")
    check_small_train_step(dev)
    log(f"  full width: {TRAIN_STEPS} steps at 1920x1080 on the bench scene "
        f"({n_g} Gaussians, SH 3), f_dc + 0.3 and xyz jitter, fit toward "
        "the unperturbed render")
    arrays = dict(scene, exposure=np.eye(3, 4, dtype=np.float32)[None],
                  alive=np.ones(n_g, bool),
                  nodes=np.full((n_g, 6), -1, np.int32))
    truth = convert.state_from_numpy(arrays, n_skybox=0, device=dev)
    gt = serve(cam0).image
    rng = np.random.default_rng(7)
    pert = dataclasses.replace(
        truth, f_dc=truth.f_dc + 0.3,
        xyz=truth.xyz + torch.as_tensor(
            rng.normal(size=(n_g, 3)).astype(np.float32) * 0.01, device=dev))
    del truth
    ts = flat.init_flat_train(pert)
    cam_args = (cam0.world_view, cam0.full_proj, cam0.campos, cam0.tan_fovx,
                cam0.tan_fovy)
    kernel.launches = kernel_b2.launches = 0
    fused_before = lod_preprocess.launches
    adam_launches, tp_launches = {}, {}
    adam_before = optim.sparse_adam_cuda.launches
    tp_before = train_preprocess_forward.launches
    tr = train_phase(ts, cam_args, gt, bg, cfg, width, height)
    adam_launches["train"] = optim.sparse_adam_cuda.launches - adam_before
    tp_launches["train"] = train_preprocess_forward.launches - tp_before
    train_launches, train_b2 = tr["launches"]
    train_lp = lod_preprocess.launches - fused_before
    if train_lp:
        raise AssertionError(f"train_step launched lod_preprocess "
                             f"{train_lp} times")
    log(f"  losses {tr['losses']}; {tr['n_visible']} visible; launches B1 "
        f"{train_launches}, B2 {train_b2}")
    log(f"  step median {statistics.median(tr['step_ms']):.3f} ms on the "
        f"card (CUDA events, {TRAIN_STEPS} steps), host wall median "
        f"{statistics.median(tr['host_ms']):.3f} ms")
    log(f"  split: forward (render + loss) {tr['fwd_ms']:.3f} ms, backward "
        f"{tr['bwd_ms']:.3f} ms (B2 kernel {b2_ms:.3f} ms), Adam "
        f"{tr['adam_ms']:.3f} ms (sparse_adam; plain chain "
        f"{tr['adam_plain_ms']:.3f} ms) [{smi}]")

    del ts, tr, pert
    torch.cuda.empty_cache()

    lodr = full_lod_phases(dev, width, height, bg, smi)
    max_err = max(max_err, lodr["max_err"])
    torch.cuda.empty_cache()
    lpr = lod_preprocess_phase(dev, smi)
    adr = sparse_adam_phase(dev, smi)
    tpr = train_preprocess_phase(dev, smi)

    adam_before = optim.sparse_adam_cuda.launches
    tp_before = train_preprocess_forward.launches
    postr = post_phase(dev, width, height, smi)
    adam_launches["post"] = optim.sparse_adam_cuda.launches - adam_before
    tp_launches["post"] = train_preprocess_forward.launches - tp_before
    max_err = max(max_err, postr["b1_err"])
    b2_err = max(b2_err, postr["b2_err"])
    torch.cuda.empty_cache()

    offr = offload_phase(dev, width, height, smi, postr["max_dup"])
    max_err = max(max_err, offr["b1_err"])
    b2_err = max(b2_err, offr["b2_err"])
    torch.cuda.empty_cache()

    piper = pipeline_phase(dev, smi)
    max_err = max(max_err, piper["b1_err"])
    b2_err = max(b2_err, piper["b2_err"])
    cli_phase(dev, smi)
    torch.cuda.empty_cache()

    # ---- 15-19. scale-out and the viewer -----------------------------------
    t_scale = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="scaleout_") as root:
        try:
            mesh = nccl_world(dev, root)
            dpr = dp_phase(dev, smi, scene, mesh, root)
            torch.cuda.empty_cache()
            band = band_phase(dev, smi, scene)
            max_err = max(max_err, band["b1_err"])
            chunkr = chunk_phase(dev, smi)
            torch.cuda.empty_cache()
            world = GlooWorld(dev, root, chunkr["bitwise"])
            pipeline_one_phase(dev, smi, root)
            torch.cuda.empty_cache()
            gloo = gloo_phases(dev, smi, root, world, chunkr)
            viewr = viewer_phase(dev, smi, root)
            max_err = max(max_err, viewr["b1_err"])
            scale_s = time.perf_counter() - t_scale
            torch.cuda.empty_cache()
            perir = periphery_phase(dev, smi, root,
                                    os.path.join(root, "viewer.dhier"))
            max_err = max(max_err, perir["b1_err"])
        finally:
            if torch.distributed.is_initialized():
                torch.distributed.destroy_process_group()
    log(f"  phases 15-19 in {scale_s:.1f} s")
    scale_b1 = dict(dp=dpr["launches"][0] + gloo["sums"]["dp"][0],
                    chunk_parallel=(chunkr["launches"][0]
                                    + gloo["sums"]["chunks"][0]),
                    tile_parallel=(gloo["sums"]["tile_flat"][0]
                                   + gloo["sums"]["tile_lod"][0]),
                    pipeline_mp=gloo["sums"]["pipeline"][0],
                    viewer=viewr["launches"])
    scale_b2 = dict(dp=dpr["launches"][1] + gloo["sums"]["dp"][1],
                    chunk_parallel=(chunkr["launches"][1]
                                    + gloo["sums"]["chunks"][1]),
                    tile_parallel=(gloo["sums"]["tile_flat"][1]
                                   + gloo["sums"]["tile_lod"][1]),
                    pipeline_mp=gloo["sums"]["pipeline"][1], viewer=0)
    scale_b1.update(perir["b1"])
    scale_b2.update(perir["b2"])
    for path in ("dp", "chunk_parallel", "tile_parallel", "pipeline_mp",
                 "viewer", "eval_cli", "debug"):
        if scale_b1[path] == 0:
            raise AssertionError(f"path {path} launched no B1")
    for path in ("dp", "chunk_parallel", "pipeline_mp"):
        if scale_b2[path] == 0:
            raise AssertionError(f"path {path} launched no B2")

    bench_b1, bench_b2 = bench_phase(smi)

    # ---- 22. kernel table -------------------------------------------------
    log(f"[22] done in {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": [{
        "name": "blend_forward",
        "route": "cuda",
        "source": "hlod_gaussians_torch/csrc/blend_forward.cu",
        "replaces": "hlod_gaussians_tpu/ops/rasterize_pallas.py:700",
        "launches": (flat_launches + lod_launches + train_launches
                     + sum(lodr["b1"].values()) + postr["b1"] + offr["b1"]
                     + piper["b1"] + piper["b1_eval"]
                     + sum(scale_b1.values()) + bench_b1),
        "launches_by_path": dict({"flat": flat_launches, "lod": lod_launches,
                                  "train": train_launches}, **lodr["b1"],
                                 post=postr["b1"], offload=offr["b1"],
                                 pipeline=piper["b1"],
                                 pipeline_eval=piper["b1_eval"], **scale_b1,
                                 bench=bench_b1),
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "lod_stream_tau0": lodr["tau0"],
        "post_frame": postr["b1_frame"],
        "offload_frame": offr["b1_frame"],
        "pipeline_frame": piper["b1_frame"],
        "band_frame": {k: band[k] for k in ("band 0", "band 1",
                                            "whole frame", "imbalance")},
        "viewer_frame": viewr["b1_frame"],
        "eval_frame": perir["b1_frame"],
    }, {
        "name": "blend_backward",
        "route": "cuda",
        "source": "hlod_gaussians_torch/csrc/blend_backward.cu",
        "replaces": "hlod_gaussians_tpu/ops/rasterize_pallas.py:1240",
        "launches": (flat_b2 + lod_b2 + train_b2 + sum(lodr["b2"].values())
                     + postr["b2"] + offr["b2"] + piper["b2"]
                     + sum(scale_b2.values()) + bench_b2),
        "launches_by_path": dict({"flat": flat_b2, "lod": lod_b2,
                                  "train": train_b2}, **lodr["b2"],
                                 post=postr["b2"], offload=offr["b2"],
                                 pipeline=piper["b2"], **scale_b2,
                                 bench=bench_b2),
        "max_abs_err": b2_err,
        "ms": b2_ms,
        "plain_ms": b2_plain_ms,
        "bound_ms": b2_bound_ms,
        "bound_by": b2_bound_by,
        "library_ms": None,
        "post_frame": postr["b2_frame"],
        "offload_frame": offr["b2_frame"],
        "pipeline_frame": piper["b2_frame"],
    }, lod_preprocess_entry(lpr, dict(lodr["lod_preprocess"],
                                      train=train_lp)),
        sparse_adam_entry(adr, dict(
            adam_launches, other=optim.sparse_adam_cuda.launches
            - adr["launches"] - sum(adam_launches.values()))),
        train_preprocess_entry(tpr, dict(
            tp_launches, other=train_preprocess_forward.launches
            - tpr["launches"] - sum(tp_launches.values())))]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
