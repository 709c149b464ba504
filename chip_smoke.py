#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (hlod_gaussians_torch) on one NVIDIA
GPU: builds the blend kernels, holds each to its plain PyTorch version,
serves flat and hierarchical-LOD renders and takes flat training steps
through the public entry points, and prints the kernel table.

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
     the first; step median and the forward / backward / Adam split.
  6. the {"kernels": [...]} line, then the device line.

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
B1_BATCH = 32        # entries per shared-memory batch of kernel B1
GRAD_SCALED_ATOL = 3e-4
TRAIN_STEPS = 8


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
        m = re.search(r"(blend_(?:forward|backward)_kernel)I(\w*?)EEv",
                      line)
        if m:
            args = re.findall(r"L[bi](\d+)E", m.group(2) + "E")
            kernel_name = f"{m.group(1)}<{', '.join(args)}>"
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


def work_of_frame(feats, bins, width, height, tile_w, tile_h, t_eps,
                  alpha_min):
    """(evaluated, applied) (entry, pixel) pairs of the serial loop on these
    inputs: a replay of the plain version's control flow that counts, per
    pixel, the entries it evaluates up to its stop."""
    import torch
    from hlod_gaussians_torch.ops.rasterize_xla import (entry_alpha,
                                                        tile_pixels)
    px, py, inside = tile_pixels(width, height, tile_w, tile_h, feats.device)
    pxf, pyf = px.float(), py.float()
    t_run = torch.ones(px.shape, device=feats.device)
    done = ~inside
    evaluated = torch.zeros((), dtype=torch.int64, device=feats.device)
    applied = torch.zeros_like(evaluated)
    for k in range(int(bins.tile_counts.max())):
        live = (k < bins.tile_counts)[:, None] & ~done
        evaluated += live.sum()
        f = feats[bins.sorted_gid[torch.clamp(bins.tile_starts + k, 0,
                                              bins.sorted_gid.shape[0] - 1)
                                  ].long()]
        alpha, power = entry_alpha(f, pxf, pyf, use_lod=False)
        pre = live & (power <= 0.0) & (alpha >= alpha_min)
        test_t = t_run * (1.0 - alpha)
        trigger = pre & (test_t < t_eps)
        apply = pre & ~trigger
        applied += apply.sum()
        t_run = torch.where(apply, test_t, t_run)
        done = done | trigger
    return int(evaluated), int(applied)


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
    from hlod_gaussians_torch.train import flat
    b1, b2 = rasterize_cuda.blend_forward, rasterize_cuda.blend_backward
    opt = OptimizationConfig()
    step_kw = dict(exposure_idx=0, scene_extent=extent, opt=opt, cfg=cfg,
                   width=width, height=height, sh_degree=3)
    losses, step_ms, host_ms = [], [], []
    for i in range(TRAIN_STEPS):
        before = (b1.launches, b2.launches)
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
        delta = (b1.launches - before[0], b2.launches - before[1])
        if (bool(aux.truncated) or not np.isfinite(losses[-1])
                or delta != (1, 1)):
            raise AssertionError(f"train step {i}: truncated "
                                 f"{bool(aux.truncated)}, loss {losses[-1]}, "
                                 f"(B1, B2) launches {delta}")
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
    bwd_times, adam_times = [], []
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
        adam_times.append(cuda_time_ms(lambda: optim.sparse_adam_update(
            detached, grads, ts.adam, lrs, visible=out.visible), 1,
            warmup=0))
    return dict(launches=launches, losses=[round(x, 6) for x in losses],
                step_ms=step_ms,
                host_ms=host_ms, n_visible=int(aux.n_visible), fwd_ms=fwd_ms,
                bwd_ms=statistics.median(bwd_times),
                adam_ms=statistics.median(adam_times))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke "
              "test runs only on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from hlod_gaussians_torch import convert, render
    from hlod_gaussians_torch.config import RasterizerConfig
    from hlod_gaussians_torch.data.dhier import load_dhier
    from hlod_gaussians_torch.models import gaussians as gm
    from hlod_gaussians_torch.ops import gaussian_math, sh as sh_ops
    from hlod_gaussians_torch.ops import rasterize_cuda
    from hlod_gaussians_torch.ops.binning import bin_gaussians
    from hlod_gaussians_torch.ops.rasterize import rasterize_tiles
    from hlod_gaussians_torch.ops.rasterize_xla import (blend_backward_plain,
                                                        blend_forward_plain,
                                                        tile_image)
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
    evaluated, applied = work_of_frame(feats0, bins0, width, height, 32, 32,
                                       cfg.t_eps, cfg.alpha_min)
    num_dup = int(bins0.num_dup)
    n_tiles = bins0.tile_starts.numel()
    bytes_moved = (n_g * 12 * 4 + num_dup * 4 + 2 * n_tiles * 4
                   + width * height * (4 * 4 + 4 + 4))
    ops = OPS_EVAL * evaluated + OPS_APPLY * applied
    t_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    log(f"  bench frame: {num_dup} entries, {evaluated} evaluated and "
        f"{applied} applied (entry, pixel) pairs, {ops:.4e} f32 ops, "
        f"{bytes_moved} bytes")
    log(f"  blend_forward kernel {kernel_ms:.4f} ms, plain version "
        f"{plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({bound_by}; bytes "
        f"{t_bytes:.4f} ms, ops {t_ops:.4f} ms) [{smi}]")

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
    # the work these inputs need: every entry before a pixel's n_contrib
    # decides whether it was applied, and the applied pairs (the forward's)
    # carry the gradient; the kernel walks every pixel of a tile down from
    # the tile's largest n_contrib
    needed = int(got[2].sum())
    walked = int(tile_image(got[2], width, height, 32, 32).amax(1).sum()
                 ) * 32 * 32
    b2_bytes = (n_g * 12 * 4 + num_dup * 4 + 2 * n_tiles * 4
                + width * height * (4 + 4 + 4 * 4 + 4)
                + bins0.sorted_gid.numel() * 12 * 4)
    b2_ops = B2_OPS_NEED * needed + B2_OPS_APPLY * applied
    b2_t_bytes = b2_bytes / PEAK_BYTES_S * 1e3
    b2_t_ops = b2_ops / PEAK_F32_S * 1e3
    b2_bound_ms = max(b2_t_bytes, b2_t_ops)
    b2_bound_by = "bytes" if b2_t_bytes >= b2_t_ops else "operations"
    log(f"  bench frame: {needed} needed, {applied} applied and {walked} "
        f"walked (entry, pixel) pairs, {b2_ops:.4e} f32 ops, {b2_bytes} "
        "bytes")
    log(f"  blend_backward kernel {b2_ms:.4f} ms, plain version "
        f"{b2_plain_ms:.2f} ms, bound {b2_bound_ms:.4f} ms ({b2_bound_by}; "
        f"bytes {b2_t_bytes:.4f} ms, ops {b2_t_ops:.4f} ms) [{smi}]")

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
        bins0, p0.xy, p0.conic, p0.opacity, color0,
        1.0 / torch.clamp_min(p0.depth, 1e-6), bg, width=width,
        height=height, tile_w=32, tile_h=32), 10)
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
    tr = train_phase(ts, cam_args, gt, bg, cfg, width, height)
    train_launches, train_b2 = tr["launches"]
    log(f"  losses {tr['losses']}; {tr['n_visible']} visible; launches B1 "
        f"{train_launches}, B2 {train_b2}")
    log(f"  step median {statistics.median(tr['step_ms']):.3f} ms on the "
        f"card (CUDA events, {TRAIN_STEPS} steps), host wall median "
        f"{statistics.median(tr['host_ms']):.3f} ms")
    log(f"  split: forward (render + loss) {tr['fwd_ms']:.3f} ms, backward "
        f"{tr['bwd_ms']:.3f} ms (B2 kernel {b2_ms:.3f} ms), Adam "
        f"{tr['adam_ms']:.3f} ms [{smi}]")

    # ---- 6. kernel table -------------------------------------------------
    log(f"[6] done in {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": [{
        "name": "blend_forward",
        "route": "cuda",
        "source": "hlod_gaussians_torch/csrc/blend_forward.cu",
        "replaces": "hlod_gaussians_tpu/ops/rasterize_pallas.py:700",
        "launches": flat_launches + lod_launches + train_launches,
        "launches_by_path": {"flat": flat_launches, "lod": lod_launches,
                             "train": train_launches},
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "blend_backward",
        "route": "cuda",
        "source": "hlod_gaussians_torch/csrc/blend_backward.cu",
        "replaces": "hlod_gaussians_tpu/ops/rasterize_pallas.py:1240",
        "launches": flat_b2 + lod_b2 + train_b2,
        "launches_by_path": {"flat": flat_b2, "lod": lod_b2,
                             "train": train_b2},
        "max_abs_err": b2_err,
        "ms": b2_ms,
        "plain_ms": b2_plain_ms,
        "bound_ms": b2_bound_ms,
        "bound_by": b2_bound_by,
        "library_ms": None,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
