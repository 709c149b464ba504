#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port (hlod_gaussians_torch) on one NVIDIA
GPU: the twin of bench.py, measuring what it measures.

    python3 bench_torch.py          # from the repository root, one GPU

Prints ONE JSON line on stdout with bench.py's keys: "metric"
("rasterizer_fwd_bwd_1080p"), "value" and "unit" (Mpix/s of the
train-style step: render forward + full backward through the blend,
projection, SH and covariance math, at 1920x1080 on scripts/bench_scene.py's
100k-Gaussian SH-3 scene), "vs_baseline" (value over 124.4 Mpix/s, the
north-star proxy of 60 such steps a second at 1080p), and the streaming
hierarchical-LOD rates "lod_stream_tau0_mpix_s" / "lod_stream_tau15_mpix_s"
(render_lod_stream at 1080p, SH 0, over bench.py's 2^19-leaf tree built by
the port into 1,048,575 nodes; the median of three 20-frame windows).

Times are host clock around work that ends in torch.cuda.synchronize(), so
host dispatch counts, as it does in bench.py. The step raises if the scene
overflows max_dup. The LOD keys are null only when the time budget
(BENCH_TIME_BUDGET_S, default 540 s, bench.py's guard) is nearly spent,
which stderr says; any failure propagates and the exit code is non-zero.
Progress goes to stderr as `[bench ...s]` notes, with the card's name and
power limit and the run's kernel launches. The built tree is cached in
.bench_cache/lodtree_torch.npz. Without a CUDA device it exits 1 and does
not fall back to the CPU; the functions below take any device (the tests
run them on the CPU, where the kernels' wrappers run their plain versions).
"""

import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(ROOT, ".bench_cache", "lodtree_torch.npz")
BASELINE_MPIX_S = 124.4     # 60 fwd+bwd steps/s at 1080p
STEP_KEYS = ("xyz", "log_scale", "quat", "opacity_logit", "f_dc", "f_rest")
STREAM_TAUS = ((0.0, "lod_stream_tau0_mpix_s"),
               (15.0, "lod_stream_tau15_mpix_s"))
STEP_ITERS = 20
N_CAMS, WARM_FRAMES, WINDOWS, WINDOW_FRAMES = 26, 6, 3, 20


class Size(NamedTuple):
    """bench.py's sizes: the frame, the bench scene, the train step's
    capacity, the LOD tree's leaves and the stream's capacity."""
    width: int = 1920
    height: int = 1080
    n_pts: int = 100_000
    max_dup: int = 352 * 1024
    n_leaves: int = 1 << 19
    lod_max_dup: int = 1 << 20


class Budget:
    """bench.py's deadline guard (its seconds from BENCH_TIME_BUDGET_S,
    default 540) and its stderr notes."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.seconds = float(os.environ.get("BENCH_TIME_BUDGET_S", "540"))

    def left(self):
        return self.seconds - (time.perf_counter() - self.t0)

    def note(self, msg):
        print(f"[bench {time.perf_counter() - self.t0:6.1f}s] {msg}",
              file=sys.stderr, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launches():
    from hlod_gaussians_torch.ops import rasterize_cuda
    return (rasterize_cuda.blend_forward.launches,
            rasterize_cuda.blend_backward.launches)


def bench_scene(n_pts):
    """scripts/bench_scene.make_bench_scene (numpy only), as float32 (its
    log_scale comes out as float64; jnp.asarray makes float32 in bench.py)."""
    spec = importlib.util.spec_from_file_location(
        "bench_scene", os.path.join(ROOT, "scripts", "bench_scene.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {k: v.astype(np.float32)
            for k, v in mod.make_bench_scene(n_pts=n_pts).items()}


def bench_camera(device, width, height, yaw=0.0):
    """bench.py's cameras: at the origin, yawed `yaw` radians about y."""
    from hlod_gaussians_torch.utils.camera import make_camera
    R = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                  [-np.sin(yaw), 0, np.cos(yaw)]], np.float32)
    return make_camera(R, np.zeros(3), fovx=1.2, fovy=0.8, width=width,
                       height=height, device=device)


def bench_step(device, *, width, height, n_pts, max_dup):
    """bench.py's train-style step on `device` (bench.py:60-91): the six
    raw parameter leaves of the bench scene, requiring grad, and
    render(*leaves) -> RenderResult (quaternions normalised with a 1e-12
    clip, exp scales, sigmoid opacity, SH 3, 32x32 tiles, tight binning,
    k_max 384)."""
    import torch
    from hlod_gaussians_torch import render as render_mod
    from hlod_gaussians_torch.config import RasterizerConfig
    p = bench_scene(n_pts)
    leaves = tuple(torch.as_tensor(p[k], device=device).requires_grad_(True)
                   for k in STEP_KEYS)
    cam = bench_camera(device, width, height)
    cfg = RasterizerConfig(backend="pallas", tile_w=32, tile_h=32,
                           max_dup=max_dup, tight_binning=True)
    valid = torch.ones((n_pts,), dtype=torch.bool, device=device)
    bg = torch.zeros(3, device=device)

    def render(xyz, log_scale, quat, op_logit, f_dc, f_rest):
        q = quat / torch.linalg.norm(quat, dim=-1,
                                     keepdim=True).clamp_min(1e-12)
        return render_mod.render_arrays(
            xyz, torch.exp(log_scale), q, torch.sigmoid(op_logit[..., 0]),
            torch.cat([f_dc, f_rest], dim=1), valid, cam.world_view,
            cam.full_proj, cam.campos, cam.tan_fovx, cam.tan_fovy, bg,
            sh_degree=3, width=width, height=height, cfg=cfg, k_max=384)
    return leaves, render


def step_grads(render, leaves):
    """grad(L1(render)) over the six leaves: (loss, gradients)."""
    import torch
    image = render(*leaves).image
    loss = torch.abs(image - torch.zeros_like(image)).mean()
    return loss, torch.autograd.grad(loss, leaves)


def bench_step_rate(device, *, width=1920, height=1080, n_pts=100_000,
                    max_dup=352 * 1024, budget=None):
    """The step's Mpix/s (bench.py:94-118): the truncation check, one
    warm-up step, then blocks of 5 steps until 20 are in or the budget is
    nearly spent."""
    import torch
    budget = budget or Budget()
    leaves, render = bench_step(device, width=width, height=height,
                                n_pts=n_pts, max_dup=max_dup)
    with torch.no_grad():
        if bool(render(*leaves).truncated):
            raise RuntimeError("bench scene overflows max_dup — fix the "
                               "config")
    budget.note("warm-up step")
    step_grads(render, leaves)
    _sync(device)
    budget.note("timing")
    iters = 0
    t0 = time.perf_counter()
    while iters < STEP_ITERS and (iters < 5 or budget.left() > 15.0):
        for _ in range(5):
            step_grads(render, leaves)
        _sync(device)
        iters += 5
    dt = (time.perf_counter() - t0) / iters
    budget.note(f"{iters} iters, {dt * 1e3} ms/step")
    return width * height / dt / 1e6


def leaf_draws(n_leaves):
    """bench.py's LOD bench leaves (bench.py:147-158), default_rng(0):
    positions N(0, 10) shifted +30 in z, log-normal scales, unit
    quaternions, opacity U(0.3, 0.9), SH degree 0."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(n_leaves, 3)).astype(np.float32) * 10.0
    pts[:, 2] += 30.0
    scales = np.exp(rng.normal(size=(n_leaves, 3)) * 0.3
                    - 3.2).astype(np.float32)
    quats = rng.normal(size=(n_leaves, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    ops = rng.uniform(0.3, 0.9, n_leaves).astype(np.float32)
    shs = rng.normal(size=(n_leaves, 1, 3)).astype(np.float32) * 0.3
    return pts, scales, quats, ops, shs


def build_lod_tree(n_leaves, device):
    """The LOD bench tree built by the port on `device`: numpy pos, scale,
    quat, opacity, sh and nodes (2 n_leaves - 1 rows)."""
    from hlod_gaussians_torch.hierarchy import build
    h = build.build_hierarchy(*leaf_draws(n_leaves), device=device)
    return dict(pos=h.pos, scale=h.scale, quat=h.quat, opacity=h.opacity,
                sh=h.sh, nodes=h.nodes)


def load_lod_tree(n_leaves, device, cache=None, budget=None):
    """build_lod_tree, read from and written to `cache` when given."""
    if cache and os.path.exists(cache):
        with np.load(cache) as d:
            tree = {k: d[k] for k in d.files}
        if tree["nodes"].shape[0] == 2 * n_leaves - 1:
            return tree
    (budget or Budget()).note(f"building the {2 * n_leaves - 1}-node LOD "
                              "tree (cached for the next run)")
    tree = build_lod_tree(n_leaves, device)
    if cache:
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        np.savez(cache, **tree)
    return tree


def lod_inputs(tree, device):
    """render_lod_stream's tree arguments as bench.py passes them (the
    opacity clipped to [0, 1], every node alive) and its parent cache and
    interp table, built once."""
    import torch
    from hlod_gaussians_torch.hierarchy import cut
    t = {k: torch.as_tensor(v, device=device) for k, v in tree.items()}
    op = torch.clamp(t["opacity"], 0.0, 1.0)
    alive = torch.ones((t["nodes"].shape[0],), dtype=torch.bool,
                       device=device)
    pcache = cut.build_parent_cache(t["nodes"], t["pos"],
                                    torch.max(t["scale"], dim=1).values)
    itab = cut.build_interp_table(
        dict(means3d=t["pos"], scales=t["scale"], quats=t["quat"],
             opacities=op, shs=t["sh"]), t["nodes"])
    args = (t["pos"], t["scale"], t["quat"], op, t["sh"], t["nodes"], alive)
    return args, pcache, itab


def stream_target(tau, cam, width):
    from hlod_gaussians_torch import render
    return max(float(render.tau_to_threshold(tau, float(cam.tan_fovx),
                                             width)), 1e-9)


def stream_frame(inputs, cam, target, state, *, width, height, max_dup):
    """One render_lod_stream frame (bench.py:219-228): SH 0, 32x32 tiles,
    k_max 512, no frustum cull; `state` is the stream's dict."""
    import torch
    from hlod_gaussians_torch import render
    from hlod_gaussians_torch.config import RasterizerConfig
    args, pcache, itab = inputs
    cfg = RasterizerConfig(backend="pallas", tile_w=32, tile_h=32,
                           max_dup=max_dup, tight_binning=True)
    with torch.no_grad():
        out, _ = render.render_lod_stream(
            *args, cam.world_view, cam.full_proj, cam.campos, cam.tan_fovx,
            cam.tan_fovy, torch.zeros(3, device=args[0].device), target,
            state, pcache=pcache, interp_table=itab, sh_degree=0,
            width=width, height=height, cfg=cfg, k_max=512,
            use_frustum=False)
    return out


def lod_stream_rates(device, *, width=1920, height=1080, n_leaves=1 << 19,
                     max_dup=1 << 20, cache=None, budget=None):
    """The stream's rates at tau 0 and 15 (bench.py:121-245): 6 warm-up
    frames over the 26 yawing cameras, then three 20-frame windows; the
    median window's Mpix/s under each key (the windows stop early, and
    tau 15 is skipped, as the budget runs out)."""
    budget = budget or Budget()
    tree = load_lod_tree(n_leaves, device, cache, budget)
    inputs = lod_inputs(tree, device)
    cams = [bench_camera(device, width, height, 0.02 * i)
            for i in range(N_CAMS)]
    _sync(device)
    out = {}
    for tau, key in STREAM_TAUS:
        target, st = stream_target(tau, cams[0], width), {}

        def frame(i):
            return stream_frame(inputs, cams[i % N_CAMS], target, st,
                                width=width, height=height, max_dup=max_dup)

        budget.note(f"LOD stream tau{tau:g}: warm + {WINDOWS}x"
                    f"{WINDOW_FRAMES} frames")
        for i in range(WARM_FRAMES):
            frame(i)
        _sync(device)
        fidx, rates = WARM_FRAMES, []
        for _ in range(WINDOWS):
            t0 = time.perf_counter()
            for i in range(WINDOW_FRAMES):
                frame(fidx + i)
            _sync(device)
            fidx += WINDOW_FRAMES
            rates.append(width * height / ((time.perf_counter() - t0)
                                           / WINDOW_FRAMES) / 1e6)
            if budget.left() < 45.0:
                break
        rates.sort()
        out[key] = rates[len(rates) // 2]
        budget.note(f"tau{tau:g}: {out[key]} Mpix/s (windows {rates}; "
                    f"path {st['pending'][1]}, truncated frames "
                    f"{st.get('n_truncated_frames')})")
        if budget.left() < 60.0:
            break
    return out


def main(device=None, size=Size(), cache=CACHE):
    """Runs the bench on `device` (the card when None; exits 1 without one)
    and prints its JSON line."""
    import torch
    if device is None:
        if not torch.cuda.is_available():
            print("bench_torch: torch.cuda.is_available() is False — this "
                  "benchmark runs only on an NVIDIA GPU", file=sys.stderr)
            return 1
        device = "cuda"
    device = torch.device(device)
    budget = Budget()
    if device.type == "cuda":
        budget.note(f"{nvidia_smi_line()}; torch {torch.__version__} cuda "
                    f"{torch.version.cuda}")
    launches = _launches()
    mpix_s = bench_step_rate(
        device, width=size.width, height=size.height, n_pts=size.n_pts,
        max_dup=size.max_dup, budget=budget)
    lod = {key: None for _, key in STREAM_TAUS}
    if budget.left() > 150.0:
        lod.update(lod_stream_rates(
            device, width=size.width, height=size.height,
            n_leaves=size.n_leaves, max_dup=size.lod_max_dup, cache=cache,
            budget=budget))
    else:
        budget.note("budget nearly spent: the LOD stream is skipped and its "
                    "keys are null")
    after = _launches()
    budget.note(f"kernel launches: B1 {after[0] - launches[0]}, B2 "
                f"{after[1] - launches[1]}")
    out = {
        "metric": "rasterizer_fwd_bwd_1080p",
        "value": round(mpix_s, 2),
        "unit": "Mpix/s",
        "vs_baseline": round(mpix_s / BASELINE_MPIX_S, 3),
    }
    out.update({k: None if v is None else round(v, 2)
                for k, v in lod.items()})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
