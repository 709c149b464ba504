"""Kernel B2's CUDA source (hlod_gaussians_torch/csrc/blend_backward.cu) run
on the CPU against its plain version, blend_backward_plain.

A CUDA kernel has no CPU mode, so this file translates the source into C++
that g++ builds: one std::thread per CUDA thread, std::barrier for
__syncthreads and for the warp collectives (shuffles, votes, max), a
synchronous copy for cp.async, and the launch as a loop over blocks. That
runs the kernel's own control flow without a GPU: the launch shapes with 4,
2 and 1 pixels a thread, the entry ring over many batches, warps that stop
early, ragged tiles, the reduce-scatter butterfly and the cross-warp sums.
The arithmetic is the host's, so the result agrees with the plain version to
rounding, as on the card; the card's own run is tests/test_torch_cuda.py.
Each emulated launch runs in a subprocess with a time limit, so a barrier
that never completes fails the test instead of hanging it. Skips without
g++.
"""

import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hlod_gaussians_torch.ops import gaussian_math
from hlod_gaussians_torch.ops.binning import bin_gaussians, tile_grid
from hlod_gaussians_torch.ops.rasterize_xla import (blend_backward_plain,
                                                    blend_features,
                                                    blend_forward_plain)
from hlod_gaussians_torch.utils.camera import make_camera

SOURCE = (Path(__file__).resolve().parents[1] / "hlod_gaussians_torch"
          / "csrc" / "blend_backward.cu")
GRAD_ATOL = 3e-4     # per-entry gradients, scaled by the largest magnitude

EMUL_H = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
struct float4 { float x, y, z, w; };
struct Idx { int x = 0; };
inline thread_local Idx threadIdx, blockIdx, blockDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0, cudaErrorInvalidValue = 1;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 0;
template <class K> int cudaFuncSetAttribute(K, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(int e) { return e ? "error" : "ok"; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline float __fdividef(float a, float b) { return a / b; }
inline float __logf(float x) { return std::log(x); }
inline unsigned long long __cvta_generic_to_shared(const void*) { return 0; }
using std::max;
using std::min;
namespace emu {
inline thread_local std::barrier<>* block_bar;
inline thread_local std::barrier<>* warp_bar;
inline thread_local float* warp_f;
inline thread_local int* warp_i;
inline std::vector<char> dyn;
inline int collect(int x, bool take_max) {
  const int l = threadIdx.x & 31;
  warp_i[l] = x;
  warp_bar->arrive_and_wait();
  int r = warp_i[0];
  for (int i = 1; i < 32; ++i)
    r = take_max ? std::max(r, warp_i[i]) : (r | warp_i[i]);
  warp_bar->arrive_and_wait();
  return r;
}
template <class K, class... A>
void launch(K kernel, int grid, int nthr, size_t smem, cudaStream_t,
            A... args) {
  for (int b = 0; b < grid; ++b) {
    dyn.assign(smem, 0);
    std::barrier<> bar(nthr);
    std::vector<std::unique_ptr<std::barrier<>>> warps;
    for (int w = 0; w < nthr / 32; ++w)
      warps.emplace_back(new std::barrier<>(32));
    std::vector<float> wf(nthr);
    std::vector<int> wi(nthr);
    std::vector<std::thread> threads;
    for (int t = 0; t < nthr; ++t)
      threads.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = b;
        blockDim.x = nthr;
        block_bar = &bar;
        warp_bar = warps[t / 32].get();
        warp_f = wf.data() + t / 32 * 32;
        warp_i = wi.data() + t / 32 * 32;
        kernel(args...);
      });
    for (auto& th : threads) th.join();
  }
}
}  // namespace emu
inline void __syncthreads() { emu::block_bar->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float x, int o) {
  const int l = threadIdx.x & 31;
  emu::warp_f[l] = x;
  emu::warp_bar->arrive_and_wait();
  const float r = emu::warp_f[l ^ o];
  emu::warp_bar->arrive_and_wait();
  return r;
}
inline bool __any_sync(unsigned, bool p) { return emu::collect(p, false); }
inline int __reduce_max_sync(unsigned, int x) { return emu::collect(x, true); }
"""

# the subprocess: load the library, launch twice on the saved inputs
RUNNER = r"""
import ctypes, sys, torch
lib = ctypes.CDLL(sys.argv[1])
p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
lib.blend_backward_launch.argtypes = [p] * 8 + [i] * 6 + [f, i, p, p]
d = torch.load(sys.argv[2])
outs = []
for _ in range(2):
    out = torch.zeros((d["gid"].shape[0], 12))
    err = lib.blend_backward_launch(
        *(d[k].data_ptr() for k in ("feats", "gid", "starts", "counts", "ft",
                                    "nc", "g4", "gft")),
        *d["shape"], 1.0 / 255.0, d["lod"], out.data_ptr(), None)
    assert err == 0, err
    outs.append(out)
torch.save(outs, sys.argv[3])
"""

# tile, scene; B2 runs P = 4, 2 or 1 pixels a thread. Small frames: every
# emulated CUDA thread is an OS thread and every warp collective a barrier
CASES = {
    "16x16": dict(tile=(16, 16), n=120, seed=5),                  # P 4
    "32x32-lod": dict(tile=(32, 32), n=120, seed=7, lod=True),    # P 4
    "8x128-lod": dict(tile=(8, 128), n=120, seed=9, lod=True),    # P 4
    "16x8-sticky": dict(tile=(16, 8), n=300, seed=7, stacked=True),
    "8x4": dict(tile=(8, 4), n=120, seed=11),                     # P 1
    "8x8-lod": dict(tile=(8, 8), n=120, seed=13, lod=True),       # P 2
    "12x8-ragged-lod": dict(tile=(12, 8), n=120, seed=17, lod=True,
                            frame=(58, 41)),                      # P 1
    "32x32-ragged": dict(tile=(32, 32), n=120, seed=19, frame=(58, 41)),
}


def translate(src: str) -> str:
    """blend_backward.cu -> C++ on top of EMUL_H; each edit must apply."""
    edits = [
        (r"#include <cuda_runtime.h>", '#include "emul.h"'),
        (r"extern __shared__ float4 smem\[\];",
         "float4* smem = reinterpret_cast<float4*>(emu::dyn.data());"),
        (r"__shared__ int", "static int"),
        (r'asm volatile\("cp\.async\.cg.*?\);', "std::memcpy(dst, src, 16);"),
        (r'asm volatile\("cp\.async\.commit_group.*?\);', ""),
        (r'asm volatile\("cp\.async\.wait_group.*?\);', ""),
        (r"(\w+)<<<(.*?)>>>\(", r"emu::launch(\1, \2, "),
    ]
    for pattern, repl in edits:
        src, n = re.subn(pattern, repl, src, flags=re.S)
        assert n >= 1, f"the kernel source no longer has {pattern!r}"
    return src


@pytest.fixture(scope="module")
def emulated_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the emulated kernel")
    d = tmp_path_factory.mktemp("b2_emulated")
    (d / "emul.h").write_text(EMUL_H)
    (d / "b2.cpp").write_text(translate(SOURCE.read_text()))
    lib = d / "libb2.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared",
                    "-fPIC", "-pthread", "-I", str(d), "-o", str(lib),
                    str(d / "b2.cpp")], check=True, timeout=300)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # tiny tensors; the workers share cores
    yield lib
    torch.set_num_threads(threads)


def _inputs(tile, n, seed, lod=False, stacked=False, frame=(48, 32)):
    width, height = frame
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
        scales = np.exp(rng.normal(size=(n, 3)) * 0.4 - 2.5).astype(
            np.float32)
        quats = rng.normal(size=(n, 4)).astype(np.float32)
        ops = rng.uniform(0.2, 0.95, n).astype(np.float32)
    t = torch.as_tensor
    cam = make_camera(np.eye(3), np.zeros(3), 0.9, 0.7, width, height,
                      device=torch.device("cpu"))
    p = gaussian_math.project_gaussians(
        t(xyz), gaussian_math.compute_cov3d(t(scales), t(quats)), t(ops),
        cam.world_view, cam.full_proj, width, height, cam.focal_x,
        cam.focal_y, cam.tan_fovx, cam.tan_fovy)
    ts = t(rng.uniform(0, 1, n).astype(np.float32)) if lod else None
    kids = t(rng.integers(0, 4, n).astype(np.int32)) if lod else None
    bins = bin_gaussians(p.xy, p.depth, p.radius, p.valid, width, height,
                         *tile, 1 << 16, ext=p.ext, reff2=p.reff2)
    feats = blend_features(p.xy, p.conic, p.opacity,
                           t(rng.uniform(0, 1, (n, 3)).astype(np.float32)),
                           1.0 / torch.clamp_min(p.depth, 1e-6), ts, kids)
    kw = dict(width=width, height=height, tile_w=tile[0], tile_h=tile[1],
              use_lod=lod)
    args = (feats, bins.sorted_gid, bins.tile_starts, bins.tile_counts)
    _, final_t, n_contrib, _ = blend_forward_plain(*args, **kw)
    g4 = t(rng.normal(size=(4, height, width)).astype(np.float32))
    gft = t(rng.normal(size=(height, width)).astype(np.float32))
    return args + (final_t.contiguous(), n_contrib.contiguous(), g4, gft), kw


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_backward_matches_plain(case, emulated_lib, tmp_path):
    """The kernel's source, emulated, against blend_backward_plain to 3e-4 of
    the largest gradient; two launches give the same bits."""
    bargs, kw = _inputs(**CASES[case])
    gw, gh = tile_grid(kw["width"], kw["height"], kw["tile_w"], kw["tile_h"])
    names = ("feats", "gid", "starts", "counts", "ft", "nc", "g4", "gft")
    saved = dict(zip(names, bargs), lod=int(kw["use_lod"]),
                 shape=[gw * gh, gw, kw["tile_w"], kw["tile_h"], kw["width"],
                        kw["height"]])
    torch.save(saved, tmp_path / "in.pt")
    subprocess.run([sys.executable, "-c", RUNNER, str(emulated_lib),
                    str(tmp_path / "in.pt"), str(tmp_path / "out.pt")],
                   check=True, timeout=300)
    got, again = torch.load(tmp_path / "out.pt")
    ref = blend_backward_plain(*bargs, **kw)
    scale = float(ref.abs().max())
    assert scale > 0
    assert float((got - ref).abs().max()) <= GRAD_ATOL * scale
    assert torch.equal(got, again)
