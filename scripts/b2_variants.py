#!/usr/bin/env python3
"""Kernel B2 (hlod_gaussians_torch/csrc/blend_backward.cu) in variants,
timed at the 1080p bench frame of chip_smoke.py on one GPU.

    python3 scripts/b2_variants.py [--baseline OLD.cu] [--reps 20]
                                   [--out table.json]

Each variant is the current source with the text edits of VARIANTS below
(each edit must match exactly once), each taking one design choice back
or elsewhere; with --baseline, an older copy of the source with the same C
entry point joins them (e.g. `git show <commit>:hlod_gaussians_torch/csrc/
blend_backward.cu`). One nvcc per variant, with the flags of
ops/rasterize_cuda.py, all started together, into a temporary directory.
On the bench frame (B1's final T and n_contrib, seeded random cotangents)
every variant is held to blend_backward_plain at 3e-4 of the largest plain
gradient (one that misses is marked WRONG, and the exit code is then 1
unless it is a "probe:", wrong by design), then timed with CUDA events:
median of --reps launches, in two passes of opposite order. Prints one line
per variant with its ptxas registers and the blocks per SM they leave room
for, and, with --out, writes the table as JSON. Needs a CUDA device.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P_AT_MOST = lambda p: ("constexpr int kMaxP = 4;",
                       f"constexpr int kMaxP = {p};")
PLAIN_BUTTERFLY = (  # ten 5-level xor butterflies, lane 0 stores the sums
    """      int c;
      const float z = reduce_scatter10(acc, lane, &c);
      if (c >= 0) dst[c] = z;""",
    """#pragma unroll
      for (int s = 0; s < kSums; ++s) {
        float x = acc[s];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) x += shfl(x, o);
        if (lane == 0) dst[s] = x;
      }""")
BLOCKS = lambda n: ("P == 4 ? (LOD ? 2 : 3)", f"P == 4 ? (LOD ? 2 : {n})")
VARIANTS = {            # name -> text edits of the current source
    "current": [],
    "P<=2": [P_AT_MOST(2)],
    "P=1": [P_AT_MOST(1)],
    "plain butterfly": [PLAIN_BUTTERFLY],
    "P=1, plain butterfly": [P_AT_MOST(1), PLAIN_BUTTERFLY],
    "2 blocks/SM": [BLOCKS(2)],
    "4 blocks/SM": [BLOCKS(4)],
    "no exp reject": [("(LOD || !(powers[p] < reject))", "true")],
    "IEEE suffix divide": [("__fdividef(S[p], one_m)", "S[p] / one_m")],
    "batch 64": [("kBatch = 32;", "kBatch = 64;")],
    "4 ring slots": [("kStages = 3;", "kStages = 4;")],
    "widest warp patches": [("if (!best || pw + n / pw <= best + n / best)",
                             "if (!best || pw > best)")],
    "P=8": [P_AT_MOST(8), ("p == 4 ? &launch<LOD, 4>",
                            "p == 8 ? &launch<LOD, 8> : p == 4 ? "
                            "&launch<LOD, 4>")],
    # probes, wrong by design: what the walk costs without the cross-lane
    # reduction, and without everything after the applied decision
    "probe: no reduction": [
        ("const float z = reduce_scatter10(acc, lane, &c);",
         "c = lane < kSums ? lane : -1;\n      const float z = acc[0] + acc[1]"
         " + acc[2] + acc[3] + acc[4] + acc[5] + acc[6] + acc[7] + acc[8] + "
         "acc[9];")],
    "probe: decision only": [
        ("if (alpha < alpha_min) continue;",
         "if (alpha < alpha_min || alpha >= -1.0f) continue;")],
    # blocks take the tiles in order of decreasing walk (the largest
    # n_contrib of the tile), which the script computes and hands over
    "heaviest tiles first": [
        ("namespace {\n", "namespace {\n__device__ const int* g_order;\n"),
        ("const int tile = blockIdx.x;",
         "const int tile = g_order ? g_order[blockIdx.x] : blockIdx.x;"),
        ('extern "C" const char* blend_backward_error_string',
         'extern "C" int b2_set_order(const void* p) {\n'
         '  return static_cast<int>(cudaMemcpyToSymbol(g_order, &p, '
         'sizeof(p)));\n}\n\nextern "C" const char* '
         'blend_backward_error_string')],
}


def edited(src, edits):
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"variant edit does not match once: {old!r}")
        src = src.replace(old, new)
    return src


def smem_bytes(src, threads):
    """Dynamic shared memory of the current design's launch (features ring
    and partials), from the source's constants."""
    batch = int(re.search(r"kBatch = (\d+);", src).group(1))
    stages = int(re.search(r"kStages = (\d+);", src).group(1))
    return stages * batch * 48 + 2 * batch * (threads // 32) * 10 * 4


def blocks_per_sm(regs, threads, smem):
    """Resident blocks per H100 SM for a kernel of `regs` registers a
    thread (allocated in units of 8 per thread), `threads` a block and
    `smem` bytes of shared memory (plus 1 KB the runtime reserves)."""
    warps = threads // 32
    by_regs = (65536 // (-(-regs // 8) * 8 * 32)) // warps
    by_smem = (228 * 1024) // (smem + 1024)
    return min(by_regs, by_smem, 2048 // threads, 32)


def build_all(jobs, outdir):
    """jobs: {name: source text} -> {name: (library path, ptxas log)}."""
    from hlod_gaussians_torch.ops import rasterize_cuda
    nvcc = rasterize_cuda._nvcc()
    procs = {}
    for i, (name, text) in enumerate(jobs.items()):
        src = os.path.join(outdir, f"variant_{i}.cu")
        with open(src, "w") as fh:
            fh.write(text)
        lib = os.path.join(outdir, f"variant_{i}.so")
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *rasterize_cuda.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        out[name] = (lib, log)
    return out


def registers(log, want):
    """Registers of the kernel specialisation whose mangled name matches the
    regex `want`, from nvcc's -Xptxas -v output."""
    want = re.compile(want)
    current = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and current and want.search(current):
            return int(m.group(1))
    return None


def bench_frame(dev):
    """The 1080p bench frame of chip_smoke.py [2]: B1's inputs (feats,
    sorted_gid, tile_starts, tile_counts), its keywords and the config."""
    import torch
    from chip_smoke import blend_inputs, load_bench_scene
    from hlod_gaussians_torch.config import RasterizerConfig
    from hlod_gaussians_torch.ops import gaussian_math
    from hlod_gaussians_torch.ops import sh as sh_ops
    from hlod_gaussians_torch.utils.camera import make_camera
    width, height, tw, th = 1920, 1080, 32, 32
    cfg = RasterizerConfig(backend="pallas", tile_w=tw, tile_h=th,
                           max_dup=352 * 1024, tight_binning=True)
    scene = load_bench_scene()
    t = lambda a: torch.as_tensor(a, device=dev)
    quats = t(scene["quat"])
    quats = quats / torch.linalg.norm(quats, dim=-1, keepdim=True)
    means = t(scene["xyz"])
    cam = make_camera(np.eye(3), np.zeros(3), 1.2, 0.8, width, height,
                      device=dev)
    proj = gaussian_math.project_gaussians(
        means, gaussian_math.compute_cov3d(torch.exp(t(scene["log_scale"])),
                                           quats),
        torch.sigmoid(t(scene["opacity_logit"][:, 0])), cam.world_view,
        cam.full_proj, width, height, cam.focal_x, cam.focal_y,
        cam.tan_fovx, cam.tan_fovy, dilation=cfg.dilation, near=cfg.near)
    shs = torch.cat([t(scene["f_dc"]), t(scene["f_rest"])], dim=1)
    color = sh_ops.sh_color(3, shs, means, cam.campos)
    bins, feats = blend_inputs(proj, color, None, None, width, height, tw,
                               th, cfg.max_dup, tight=True)
    fargs = (feats, bins.sorted_gid, bins.tile_starts, bins.tile_counts)
    return fargs, dict(width=width, height=height, tile_w=tw, tile_h=th), cfg


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="an older blend_backward.cu to time "
                    "beside the variants")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", help="also write the table here as JSON")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("b2_variants: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import cuda_time_ms, nvidia_smi_line
    from hlod_gaussians_torch.ops import rasterize_cuda
    from hlod_gaussians_torch.ops.binning import tile_grid
    from hlod_gaussians_torch.ops.rasterize_xla import (blend_backward_plain,
                                                        tile_image)

    smi = nvidia_smi_line()
    print(smi, flush=True)
    src = rasterize_cuda.SOURCES["blend_backward"].read_text()
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
            lib.blend_backward_launch.argtypes = [p] * 8 + [i] * 6 + [
                f, i, p, p]
            lib.blend_backward_launch.restype = i
            libs[name] = lib

        # the bench frame of chip_smoke.py [2] / [2b]
        dev = torch.device("cuda")
        fargs, opts, cfg = bench_frame(dev)
        width, height, tw, th = (opts[k] for k in ("width", "height",
                                                   "tile_w", "tile_h"))
        _, final_t, n_contrib, _ = rasterize_cuda.blend_forward(*fargs,
                                                                **opts)
        gen = torch.Generator(device=dev).manual_seed(0)
        g_img4 = torch.randn((4, height, width), generator=gen, device=dev)
        g_ft = torch.randn((height, width), generator=gen, device=dev)
        bargs = fargs + (final_t, n_contrib, g_img4, g_ft)
        ref = blend_backward_plain(*bargs, **opts)
        scale = float(ref.abs().max())
        gw, gh = tile_grid(width, height, tw, th)
        stream = torch.cuda.current_stream().cuda_stream
        heavy_first = torch.argsort(
            tile_image(n_contrib, width, height, tw, th).amax(1),
            descending=True, stable=True).to(torch.int32)
        for lib in libs.values():
            if hasattr(lib, "b2_set_order"):
                lib.b2_set_order.argtypes = [ctypes.c_void_p]
                if lib.b2_set_order(heavy_first.data_ptr()):
                    raise RuntimeError("b2_set_order failed")

        def run(lib):
            out = torch.zeros_like(ref)
            err = lib.blend_backward_launch(
                *(x.data_ptr() for x in bargs), gw * gh, gw, tw, th, width,
                height, float(cfg.alpha_min), 0, out.data_ptr(), stream)
            if err:
                raise RuntimeError(lib.blend_backward_error_string(err))
            return out

        rows = {}
        for name, lib in libs.items():
            got = run(lib)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            rows[name] = dict(scaled_err=err / scale, ms=[],
                              correct=err <= 3e-4 * scale)
        order = list(libs)
        for names in (order, order[::-1]):
            for name in names:
                rows[name]["ms"].append(cuda_time_ms(
                    lambda: run(libs[name]), args.reps, warmup=3))
        for name, row in rows.items():
            if "kMaxP" not in jobs[name]:   # an older design: a thread a pixel
                regs = registers(built[name][1],
                                 r"blend_backward_kernel\w*ILb0EE")
                threads, smem = 1024, 3 * 32 * 16 + 32 * 32 * 10 * 4
            else:                       # P pixels a thread at 32x32 tiles
                p = int(re.search(r"kMaxP = (\d+);", jobs[name]).group(1))
                regs = registers(built[name][1],
                                 r"blend_backward_kernel\w*ILb0ELi%dE" % p)
                threads = 1024 // p
                smem = smem_bytes(jobs[name], threads)
            row.update(registers=regs, threads=threads, smem=smem,
                       blocks_per_sm=(blocks_per_sm(regs, threads, smem)
                                      if regs else None))
            print(f"{name:22s} {min(row['ms']):.4f} / {max(row['ms']):.4f} ms"
                  f" (two passes, median of {args.reps}), {regs} registers, "
                  f"{threads} threads, {smem} B shared, "
                  f"{row['blocks_per_sm']} blocks/SM, scaled error "
                  f"{row['scaled_err']:.2e}"
                  + ("" if row["correct"] else " WRONG"), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"device": smi, "frame": "1080p bench, 32x32 tiles",
                       "variants": rows}, fh, indent=1)
    return 0 if all(row["correct"] for name, row in rows.items()
                    if not name.startswith("probe:")) else 1


if __name__ == "__main__":
    sys.exit(main())
