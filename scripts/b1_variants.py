#!/usr/bin/env python3
"""Kernel B1 (hlod_gaussians_torch/csrc/blend_forward.cu) in variants,
timed at the 1080p bench frame of chip_smoke.py on one GPU.

    python3 scripts/b1_variants.py [--baseline OLD.cu] [--reps 20]
                                   [--frame bench|lod] [--out table.json]

Each variant is the current source with the text edits of VARIANTS below
(each edit must match exactly once), each taking one design choice back;
with --baseline, an older copy of the source with the same C entry point
joins them (e.g. `git show <commit>:hlod_gaussians_torch/csrc/
blend_forward.cu`). One nvcc per variant, with the flags of
ops/rasterize_cuda.py, all started together, into a temporary directory
(scripts/b2_variants.py's helpers). `--frame lod` takes instead the
kernel's inputs of the tau-3 LOD request of chip_smoke.py [4] (the oracle
tree and a 100k skybox, B1 with LOD), as render_lod hands them over. On the
frame every variant is held to blend_forward_plain: image and inverse depth
to 1e-4, and at most 1e-4 of the pixels with another n_contrib (one that
misses is marked WRONG, and the exit code is then 1 unless it is a
"probe:", wrong by design). Then
each is timed with CUDA events around the bare launch into preallocated
outputs: median of --reps launches, in two passes of opposite order. Prints
one line per variant with its ptxas registers and the blocks per SM they
leave room for, and, with --out, writes the table as JSON. Needs a CUDA
device.
"""

import argparse
import ctypes
import json
import os
import re
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from b2_variants import blocks_per_sm, build_all, edited, registers  # noqa: E402

P_AT_MOST = lambda p: ("constexpr int kMaxP = 4;",
                       f"constexpr int kMaxP = {p};")
WIDEST = ("if (!best || pw + n / pw <= best + n / best)",
          "if (!best || pw > best)")
BLOCKS = lambda n: ("kMinBlocks = P == 4 ? (LOD ? 3 : 4) : 1;",
                    f"kMinBlocks = P == 4 ? (LOD ? 3 : {n}) : 1;")
NO_CULL = [("touch = !(rej > 0.0f);", "touch = true;"),
           ("if (rej < 0.0f && det > 0.0f) {", "if (false) {")]
NO_REJECT = ("!(powers[p] < reject)", "true")
VARIANTS = {            # name -> text edits of the current source
    "current": [],
    "P<=2": [P_AT_MOST(2)],
    "P=1": [P_AT_MOST(1)],
    "P=1, 32x1 row warps": [P_AT_MOST(1), WIDEST],
    "widest warp patches": [WIDEST],
    "no exp reject": [NO_REJECT],
    "no per-warp cull": NO_CULL,
    "no cull, no exp reject": NO_CULL + [NO_REJECT],
    "warp vote per entry": [("if (cand) {",
                             "if (__any_sync(kFull, cand != 0)) {")],
    "2 blocks/SM": [BLOCKS(2)],
    "3 blocks/SM": [BLOCKS(3)],
    # the LOD kernel (--frame lod) at four blocks, where it spills
    "4 blocks/SM with LOD": [("(LOD ? 3 : 4)", "4")],
    "batch 64": [("kBatch = 32;", "kBatch = 64;")],
    "2 ring slots": [("kStages = 3;", "kStages = 2;")],
    # blocks take the tiles in order of decreasing walk (the largest
    # n_contrib of the tile), which the script computes and hands over
    "heaviest tiles first": [
        ("namespace {\n", "namespace {\n__device__ const int* g_order;\n"),
        ("const int tile = blockIdx.x;",
         "const int tile = g_order ? g_order[blockIdx.x] : blockIdx.x;"),
        ('extern "C" const char* blend_forward_error_string',
         'extern "C" int b1_set_order(const void* p) {\n'
         '  return static_cast<int>(cudaMemcpyToSymbol(g_order, &p, '
         'sizeof(p)));\n}\n\nextern "C" const char* '
         'blend_forward_error_string')],
    # probe, wrong by design: the walk (cull, powers and their tests)
    # without the alpha and apply path
    "probe: walk without apply": [
        ("if (cand) {", "if (cand && prm.t_eps < -1.0f) {")],
}


def lod_frame(dev):
    """The tau-3 LOD request of chip_smoke.py [4]: B1's inputs (feats,
    sorted_gid, tile_starts, tile_counts) as render_lod hands them to the
    kernel's wrapper, and its keywords."""
    import numpy as np
    import torch
    from hlod_gaussians_torch import render
    from hlod_gaussians_torch.config import RasterizerConfig
    from hlod_gaussians_torch.data.dhier import load_dhier
    from hlod_gaussians_torch.models import gaussians as gm
    from hlod_gaussians_torch.ops import rasterize_cuda
    from hlod_gaussians_torch.train.post import create_from_dhier
    from hlod_gaussians_torch.utils.camera import make_camera
    width, height = 1920, 1080
    d = load_dhier(os.path.join(ROOT, "tests", "fixtures", "oracle",
                                "hierarchy.dhier.gz"))
    g = d.pos.shape[0]
    state = create_from_dhier(
        d, capacity=g + 100_000, skybox_num=100_000,
        scene_radius=float(np.linalg.norm(d.pos, axis=1).max()), device=dev)
    act = gm.activate(state)
    cam = make_camera(np.eye(3), np.array([0.0, 0.0, 16.0]), 1.2, 0.8,
                      width, height, device=dev)
    cfg = RasterizerConfig(backend="pallas", tile_w=32, tile_h=32,
                           max_dup=1 << 21, tight_binning=True)
    calls = []
    kernel = rasterize_cuda.blend_forward

    class Captured(Exception):
        pass

    def record(*a, **kw):       # keep the wrapper's inputs, stop the render
        calls.append((a, kw))
        raise Captured

    rasterize_cuda.blend_forward = record
    try:
        with torch.no_grad():
            render.render_lod(
                act.means3d, act.scales, act.quats, act.opacities, act.shs,
                state.nodes, state.alive, cam.world_view, cam.full_proj,
                cam.campos, cam.tan_fovx, cam.tan_fovy,
                torch.zeros(3, device=dev),
                render.tau_to_threshold(3.0, cam.tan_fovx, width),
                sh_degree=d.sh_degree, width=width, height=height,
                budget=2048, n_skybox=state.n_skybox, cfg=cfg)
    except Captured:
        pass
    finally:
        rasterize_cuda.blend_forward = kernel
    (fargs, kw), = calls
    opts = {k: kw[k] for k in ("width", "height", "tile_w", "tile_h",
                               "t_eps", "alpha_min", "use_lod")}
    if not opts["use_lod"]:
        raise RuntimeError("render_lod did not ask B1 for LOD alpha")
    return fargs, opts


def smem_bytes(src):
    """Static shared memory of the current design without `seen` (the
    feature ring and a one-int gid array), from the source's constants."""
    batch = int(re.search(r"kBatch = (\d+);", src).group(1))
    stages = int(re.search(r"kStages = (\d+);", src).group(1))
    return stages * batch * 48 + 4


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="an older blend_forward.cu to time "
                    "beside the variants")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--frame", choices=("bench", "lod"), default="bench",
                    help="the 1080p bench frame (flat) or the tau-3 LOD "
                    "request")
    ap.add_argument("--out", help="also write the table as JSON")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("b1_variants: needs a CUDA device", file=sys.stderr)
        return 1
    from b2_variants import bench_frame
    from chip_smoke import cuda_time_ms, nvidia_smi_line
    from hlod_gaussians_torch.ops import rasterize_cuda
    from hlod_gaussians_torch.ops.binning import tile_grid
    from hlod_gaussians_torch.ops.rasterize_xla import (blend_forward_plain,
                                                        tile_image)

    smi = nvidia_smi_line()
    print(smi, flush=True)
    src = rasterize_cuda.SOURCES["blend_forward"].read_text()
    jobs = {name: edited(src, edits) for name, edits in VARIANTS.items()}
    if args.baseline:
        with open(args.baseline) as fh:
            jobs["baseline"] = fh.read()
    with tempfile.TemporaryDirectory() as tmp:
        built = build_all(jobs, tmp)
        libs = {}
        for name, (path, _) in built.items():
            lib = ctypes.CDLL(path)
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.blend_forward_launch.argtypes = [p] * 4 + [i] * 6 + [
                f, f, i] + [p] * 5
            lib.blend_forward_launch.restype = i
            libs[name] = lib

        dev = torch.device("cuda")
        if args.frame == "bench":
            fargs, opts, cfg = bench_frame(dev)
            opts.update(t_eps=cfg.t_eps, alpha_min=cfg.alpha_min,
                        use_lod=False)
        else:
            fargs, opts = lod_frame(dev)
        width, height, tw, th = (opts[k] for k in ("width", "height",
                                                   "tile_w", "tile_h"))
        ref = blend_forward_plain(*fargs, **opts)
        gw, gh = tile_grid(width, height, tw, th)
        stream = torch.cuda.current_stream().cuda_stream
        heavy_first = torch.argsort(
            tile_image(ref[2], width, height, tw, th).amax(1),
            descending=True, stable=True).to(torch.int32)
        for lib in libs.values():
            if hasattr(lib, "b1_set_order"):
                lib.b1_set_order.argtypes = [ctypes.c_void_p]
                if lib.b1_set_order(heavy_first.data_ptr()):
                    raise RuntimeError("b1_set_order failed")
        outs = (torch.empty_like(ref[0]), torch.empty_like(ref[1]),
                torch.empty_like(ref[2]))

        def run(lib):
            err = lib.blend_forward_launch(
                *(x.data_ptr() for x in fargs), gw * gh, gw, tw, th, width,
                height, float(opts["t_eps"]), float(opts["alpha_min"]),
                int(opts["use_lod"]),
                *(x.data_ptr() for x in outs), None, stream)
            if err:
                raise RuntimeError(lib.blend_forward_error_string(err))

        rows = {}
        for name, lib in libs.items():
            outs[2].fill_(-1)
            run(lib)
            torch.cuda.synchronize()
            img_err = float((outs[0] - ref[0]).abs().max())
            nc_share = float((outs[2] != ref[2]).float().mean())
            rows[name] = dict(img_err=img_err, nc_share=nc_share, ms=[],
                              correct=img_err <= 1e-4 and nc_share <= 1e-4)
        order = list(libs)
        for names in (order, order[::-1]):
            for name in names:
                rows[name]["ms"].append(cuda_time_ms(
                    lambda: run(libs[name]), args.reps, warmup=3))
        lod = int(opts["use_lod"])
        for name, row in rows.items():
            if "kMaxP" not in jobs[name]:   # an older design: a thread a pixel
                regs = registers(built[name][1],
                                 r"blend_forward_kernel\w*ILb%dELb0EE" % lod)
                threads, smem = 1024, 1024 * (3 * 16 + 4)
            else:                       # P pixels a thread at 32x32 tiles
                p = int(re.search(r"kMaxP = (\d+);", jobs[name]).group(1))
                regs = registers(
                    built[name][1],
                    r"blend_forward_kernel\w*ILb%dELb0ELi%dE" % (lod, p))
                threads = 1024 // p
                smem = smem_bytes(jobs[name])
            row.update(registers=regs, threads=threads, smem=smem,
                       blocks_per_sm=(blocks_per_sm(regs, threads, smem)
                                      if regs else None))
            print(f"{name:30s} {min(row['ms']):.4f} / {max(row['ms']):.4f} ms"
                  f" (two passes, median of {args.reps}), {regs} registers, "
                  f"{threads} threads, {smem} B shared, "
                  f"{row['blocks_per_sm']} blocks/SM, max|d img4| "
                  f"{row['img_err']:.2e}, n_contrib diff share "
                  f"{row['nc_share']:.2e}"
                  + ("" if row["correct"] else " WRONG"), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            frame = ("1080p bench, 32x32 tiles" if args.frame == "bench"
                     else "1080p LOD request, tau 3, 32x32 tiles")
            json.dump({"device": smi, "frame": frame, "variants": rows}, fh,
                      indent=1)
    return 0 if all(row["correct"] for name, row in rows.items()
                    if not name.startswith("probe:")) else 1


if __name__ == "__main__":
    sys.exit(main())
