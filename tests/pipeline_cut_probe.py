"""The pipeline scene of chip_smoke.py's phase [14] at reduced scale, trained
at chip_smoke.py's step counts by one package on the CPU, then the tau sweep
on the merged tree over the ring test views. Run once per package and
compare: a port whose training diverged from the JAX package's would show
here as a different loss curve or tau table at the same step counts.

    JAX_PLATFORMS=cpu python -m tests.pipeline_cut_probe --package jax
    JAX_PLATFORMS=cpu python -m tests.pipeline_cut_probe --package torch
        [--iters COARSE CHUNK POST ROUND_EVERY] [--per N] [--width W]
        [--chunk-capacity ROWS]

The scene keeps the 3x3 grid of shells, the cameras (12 a shell, one in
three held out), the chunking and every PipelineConfig field of the phase;
per shell it has 1,000 points instead of 250,000, and frames of 64 pixels
instead of 512, with the capacities and max_dup scaled to keep their ratios
to the point count and the pixel count (10-15 minutes a package on the CPU,
the ground truth included). Scaled so, a chunk's capacity leaves no room
for the scaffold ring (`_train_chunk` keeps 4,096 rows free);
``--chunk-capacity`` raises it until the ring fits, as it does at the full
size. The JAX package runs with the port's kNN quantization
(`tests/jax_knn.py`), as the tests that compare the two run it. The ground
truth is the port's plain render of the points (SH 1, opacity 0.92) for
both packages; the JAX package renders on its xla path, the port through
its kernel wrappers, here on their plain versions. Prints one JSON object:
the logged losses, each chunk's mean loss over the views it trained again
at their first and last visit, the mean activated opacity of the merged
tree's leaves, the tau table, and for each chunk its own post-optimized
tree (chunk_*/hierarchy.dhier_opt) beside the merged tree at taus 0 and 3
over the ring test views of the chunk's shell (`per_chunk`, with the chunk
tree's leaves in the ring band), which tells the chunks' training from the
merge.
"""

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import EVAL_TAUS, PIPE_CENTERS, structured_colors  # noqa

PER, WIDTH = 1000, 64


def set_size(per, width):
    """The points a shell and the frame width that configs() and the
    renders read."""
    global PER, WIDTH
    PER, WIDTH = per, width


def scene(per, width):
    """(points, colours, views as (R, T, image) with the ring test split):
    chip_smoke.pipeline_scene's shells and cameras, rendered on the CPU."""
    import torch
    from hlod_gaussians_torch import render
    from hlod_gaussians_torch.config import RasterizerConfig
    from hlod_gaussians_torch.models import gaussians as gm
    from hlod_gaussians_torch.utils.camera import make_camera
    rng = np.random.default_rng(7)
    parts = []
    for c in PIPE_CENTERS:
        d = rng.normal(size=(per, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True).clip(1e-9)
        r = 0.7 + rng.normal(0, 0.01, (per, 1))
        parts.append((c + d * r).astype(np.float32))
    pts = np.concatenate(parts)
    cols = structured_colors(pts)
    cpu = torch.device("cpu")
    gt = gm.create_from_points(pts, cols, capacity=1 << int(np.ceil(np.log2(
        len(pts)))), sh_degree=1, opacity_init=0.92, device=cpu)
    act = gm.activate(gt)
    cfg = RasterizerConfig(backend="pallas", tile_w=16, tile_h=16,
                           max_dup=32 * width * width, tight_binning=True)
    views = []
    for c in PIPE_CENTERS.astype(np.float64):
        for k in range(12):
            ang = 2 * np.pi * (k + 0.5) / 12
            pos = c + np.array([1.1 * np.cos(ang), 1.1 * np.sin(ang), -3.5],
                               np.float32).astype(np.float64)
            fwd = (c - pos) / np.linalg.norm(c - pos)
            right = np.cross([0.0, 1.0, 0.0], fwd)
            right /= np.linalg.norm(right)
            rwc = np.stack([right, np.cross(fwd, right), fwd], axis=0)
            R, T = rwc.T, -rwc @ pos
            cam = make_camera(R, T, 1.0, 1.0, width, width, device=cpu)
            with torch.no_grad():
                out = render.render_arrays(
                    act.means3d, act.scales, act.quats, act.opacities,
                    act.shs, act.valid, cam.world_view, cam.full_proj,
                    cam.campos, cam.tan_fovx, cam.tan_fovy, torch.zeros(3),
                    sh_degree=1, width=width, height=width, cfg=cfg,
                    k_max=1024)
            assert not bool(out.truncated)
            views.append((R, T, pos, out.image.numpy()))
    return pts, cols, views


class Info:
    """A scene camera carrying its ready view (the JAX run's FakeInfo)."""

    def __init__(self, v, pos):
        self.v = v
        self.R = np.eye(3)
        self.T = -np.asarray(pos, np.float64)


def configs(mod, per, iters, chunk_capacity=None):
    coarse, chunk, post_iters, every = iters
    scale = 2.25e6 / (9 * per)
    pcfg = mod["PipelineConfig"](
        coarse_iters=coarse, chunk_iters=chunk, post_iters=post_iters,
        skybox_num=1024,
        coarse_capacity=1 << int(round(np.log2((1 << 22) / scale))),
        chunk_capacity=chunk_capacity or 1 << int(round(np.log2(
            (1 << 19) / scale))),
        k_max=1024, mh_walk=True, densification_interval=10_000,
        densify_from_iter=10_000, opacity_reset_interval=100_000,
        post_densify_interval=every, chunk_size=2.9,
        chunk_point_padding=0.15)
    opt = mod["OptimizationConfig"](iterations=1500, densify_until_iter=0,
                                    densify_grad_threshold=1e8)
    post = mod["PostConfig"](spt_root_volume=1e-3, min_spt_size=64,
                             lambda_opacity=0.0, grow_fraction=0.005,
                             max_sh_degree=1)
    return pcfg, opt, post, mod["ModelConfig"](sh_degree=1)


def revisits(steps, n_chunks, chunk_iters):
    """Each chunk's mean loss on the views it trained more than once, at
    the first and the last visit."""
    out = []
    for j in range(n_chunks):
        run = steps[j * chunk_iters:(j + 1) * chunk_iters]
        first, last = {}, {}
        for k, (_, view) in enumerate(run):
            first.setdefault(view, k)
            last[view] = k
        pairs = [(run[first[v]][0], run[last[v]][0])
                 for v in first if last[v] > first[v]]
        out.append([len(pairs)] + (np.mean(pairs, 0).round(6).tolist()
                                   if pairs else []))
    return out


def run_jax(pts, cols, views, args, out_dir):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from hlod_gaussians_tpu import config, eval as eval_mod
    from hlod_gaussians_tpu.data import dhier as dhier_io
    from hlod_gaussians_tpu.data.scene import SceneInfo
    from hlod_gaussians_tpu.pipeline import full_train
    from hlod_gaussians_tpu.train import flat, post as post_mod
    from hlod_gaussians_tpu.utils.camera import make_camera
    from tests.jax_knn import knn_keeps_axis_max
    mod = dict(vars(config), PipelineConfig=full_train.PipelineConfig)
    pcfg, opt, post, mcfg = configs(mod, PER, args.iters,
                                    args.chunk_capacity)
    cfg = config.RasterizerConfig(backend="xla", tile_w=16, tile_h=16,
                                  max_dup=16 * WIDTH ** 2,
                                  tight_binning=True)
    vs = [make_camera(R, T, 1.0, 1.0, WIDTH, WIDTH,
                      image=jnp.asarray(img), exposure_idx=i)
          for i, (R, T, _, img) in enumerate(views)]
    steps = []
    orig = flat.train_step

    def step(*a, **kw):
        ts, aux = orig(*a, **kw)
        steps.append((float(aux.loss), id(a[6])))
        return ts, aux
    flat.train_step = step
    with knn_keeps_axis_max():
        return _run(full_train, SceneInfo, eval_mod,
                    post_mod.create_from_dhier, pts, cols, vs, views, steps,
                    pcfg, opt, post, mcfg, cfg, out_dir, {},
                    dhier_io.load_dhier)


def run_torch(pts, cols, views, args, out_dir):
    import torch
    from hlod_gaussians_torch import config, eval as eval_mod
    from hlod_gaussians_torch.data import dhier as dhier_io
    from hlod_gaussians_torch.data.scene import SceneInfo
    from hlod_gaussians_torch.pipeline import full_train
    from hlod_gaussians_torch.train import flat, post as post_mod
    from hlod_gaussians_torch.utils.camera import make_camera
    torch.set_num_threads(3)
    cpu = torch.device("cpu")
    mod = dict(vars(config), PipelineConfig=full_train.PipelineConfig)
    pcfg, opt, post, mcfg = configs(mod, PER, args.iters,
                                    args.chunk_capacity)
    cfg = config.RasterizerConfig(backend="pallas", tile_w=16, tile_h=16,
                                  max_dup=16 * WIDTH ** 2,
                                  tight_binning=True)
    vs = [dataclasses.replace(make_camera(R, T, 1.0, 1.0, WIDTH, WIDTH,
                                          device=cpu),
                              image=torch.from_numpy(img), exposure_idx=i)
          for i, (R, T, _, img) in enumerate(views)]
    steps = []
    orig = flat.train_step

    def step(*a, **kw):
        ts, aux = orig(*a, **kw)
        steps.append((float(aux.loss), id(a[6])))
        return ts, aux
    flat.train_step = step
    return _run(full_train, SceneInfo, eval_mod,
                lambda d, capacity: post_mod.create_from_dhier(
                    d, capacity=capacity, device=cpu),
                pts, cols, vs, views, steps, pcfg, opt, post, mcfg, cfg,
                out_dir, dict(device=cpu), dhier_io.load_dhier)


def _run(full_train, SceneInfo, eval_mod, create, pts, cols, vs, views,
         steps, pcfg, opt, post, mcfg, cfg, out_dir, dev, load_dhier):
    n_ring = len(vs)
    train = [(v, p[2]) for i, (v, p) in enumerate(zip(vs, views))
             if i % 3 != 0]
    test = [v for i, v in enumerate(vs) if i % 3 == 0]
    sc = SceneInfo(points=pts, colors=cols,
                   train_cameras=[Info(v, p) for v, p in train],
                   test_cameras=[], extent=9.0,
                   center=np.zeros(3, np.float32))
    logs = []

    class Log:
        def log(self, **kv):
            logs.append({k: v for k, v in kv.items() if k in (
                "stage", "it", "loss", "n_nodes")})
            print(f"{time.perf_counter() - t0:.1f} s", logs[-1],
                  file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    merged = full_train.run_pipeline(
        sc, view_loader=lambda ci: ci.v, output_dir=out_dir, pcfg=pcfg,
        opt=opt, post=post, cfg=cfg, mcfg=mcfg, logger=Log(), **dev)
    run_s = time.perf_counter() - t0
    leaf = merged.nodes[:, 2] == 0
    opacity = merged.opacity[leaf]              # stored activated
    cap = 1 << int(np.ceil(np.log2(merged.pos.shape[0] + 1)))
    st = create(merged, capacity=cap)
    table = eval_mod.eval_views(
        st, test, [v.image for v in test], EVAL_TAUS, level_is_tau=True,
        budget=1 << 20, cfg=cfg, k_max=1024, warn=lambda *a, **k: None)
    per_chunk = []
    for name in sorted(os.listdir(out_dir)):
        path = os.path.join(out_dir, name, "hierarchy.dhier_opt")
        if not name.startswith("chunk_") or not os.path.exists(path):
            continue
        d = load_dhier(path)
        # the chunk's shell: nearest its center.txt in x and y (its leaves'
        # mean moves toward the middle when it holds a scaffold ring)
        with open(os.path.join(out_dir, name, "center.txt")) as f:
            center = np.array(f.read().split()[:2], np.float64)
        c = int(np.argmin(np.linalg.norm(PIPE_CENTERS[:, :2] - center,
                                         axis=1)))
        ring = len(vs) // len(PIPE_CENTERS)
        shell = [vs[i] for i in range(c * ring, (c + 1) * ring) if i % 3 == 0]
        # the scaffold ring's leaves in the chunk's tree (the ring band of
        # gm.select_scaffold_ring around the chunk's center)
        e = pcfg.chunk_size
        m = np.abs(d.pos[d.nodes[:, 2] == 0][:, :2] - center).max(axis=1)
        row = dict(chunk=name, shell=c,
                   ring_leaves=int(((m > 0.5 * e) & (m < 1.5 * e)).sum()))
        for key, s in (("own", create(d, capacity=1 << int(np.ceil(np.log2(
                d.pos.shape[0] + 1))))), ("merged", st)):
            r = eval_mod.eval_views(
                s, shell, [v.image for v in shell], (0.0, 3.0),
                level_is_tau=True, budget=1 << 20, cfg=cfg, k_max=1024,
                warn=lambda *a, **k: None)
            row[key] = [round(float(x.psnr), 3) for x in r]
        per_chunk.append(row)
        print(f"{time.perf_counter() - t0:.1f} s", row, file=sys.stderr,
              flush=True)
    black = float(np.mean([
        10 * np.log10(1.0 / np.mean(np.asarray(v.image) ** 2))
        for v in test]))
    return dict(
        seconds=round(run_s, 1), n_views=n_ring, merged_nodes=int(
            merged.nodes.shape[0]),
        logged=[e for e in logs if "loss" in e],
        revisits=revisits(steps, 9, pcfg.chunk_iters),
        leaf_opacity_mean=float(opacity.mean()),
        leaf_opacity_above_half=float((opacity > 0.5).mean()),
        psnr_all_black=black, per_chunk=per_chunk,
        taus=[dict(tau=r.level, psnr=float(r.psnr), ssim=float(r.ssim),
                   mean_rendered=float(r.mean_rendered)) for r in table])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--iters", type=int, nargs=4, default=(60, 100, 40, 20),
                    metavar=("COARSE", "CHUNK", "POST", "ROUND_EVERY"))
    ap.add_argument("--per", type=int, default=PER,
                    help="ground-truth points a shell")
    ap.add_argument("--width", type=int, default=WIDTH,
                    help="frame width and height in pixels")
    ap.add_argument("--chunk-capacity", type=int, default=None,
                    help="rows of a chunk's state (default: scaled)")
    args = ap.parse_args()
    set_size(args.per, args.width)
    pts, cols, views = scene(PER, WIDTH)
    with tempfile.TemporaryDirectory() as d:
        fn = run_jax if args.package == "jax" else run_torch
        res = fn(pts, cols, views, args, d)
    res.update(package=args.package, per=PER, width=WIDTH,
               iters=list(args.iters), chunk_capacity=args.chunk_capacity)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
