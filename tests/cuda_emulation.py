"""Run a CUDA kernel's source on the CPU: the translation that the emulated
kernel tests (tests/test_torch_b1_emulated.py, test_torch_b2_emulated.py,
test_torch_lod_preprocess_emulated.py, test_torch_sparse_adam_emulated.py,
test_torch_train_preprocess_emulated.py) share, and the small scenes the
blend tests feed it.

A CUDA kernel has no CPU mode, so `translate` turns a `.cu` source into C++
that g++ builds on top of EMUL_H: one std::thread per CUDA thread,
std::barrier for __syncthreads (and its _count / _or votes) and for the warp
collectives (__syncwarp, shuffles, votes, ballots, max), a synchronous copy
for cp.async (16 bytes .cg, 8 and 4 bytes .ca), `static` for __shared__ (blocks
run one after another), and the launch as a loop over blocks. That runs the
kernel's own control flow without a GPU. The arithmetic is the host's, so
results agree with the plain versions to rounding, as on the card. A test
runs each emulated launch in a subprocess with a time limit, so that a
barrier that never completes fails the test instead of hanging it.
"""

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from hlod_gaussians_torch.ops import gaussian_math
from hlod_gaussians_torch.ops.binning import bin_gaussians
from hlod_gaussians_torch.ops.rasterize_xla import blend_features
from hlod_gaussians_torch.utils.camera import make_camera

CSRC = Path(__file__).resolve().parents[1] / "hlod_gaussians_torch" / "csrc"

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
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
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
inline float __fsqrt_rn(float x) { volatile float r = std::sqrt(x); return r; }
inline float __logf(float x) { return std::log(x); }
inline unsigned long long __cvta_generic_to_shared(const void*) { return 0; }
using std::max;
using std::min;
namespace emu {
inline thread_local std::barrier<>* block_bar;
inline thread_local std::barrier<>* warp_bar;
inline thread_local float* warp_f;
inline thread_local int* warp_i;
inline thread_local int* block_i;
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
    std::vector<int> wi(nthr), bi(nthr);
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
        block_i = bi.data();
        kernel(args...);
      });
    for (auto& th : threads) th.join();
  }
}
}  // namespace emu
inline void __syncthreads() { emu::block_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu::warp_bar->arrive_and_wait();
}
inline int __syncthreads_count(int p) {
  emu::block_i[threadIdx.x] = p != 0;
  emu::block_bar->arrive_and_wait();
  int n = 0;
  for (int i = 0; i < blockDim.x; ++i) n += emu::block_i[i];
  emu::block_bar->arrive_and_wait();
  return n;
}
inline int __syncthreads_or(int p) { return __syncthreads_count(p) != 0; }
inline float __shfl_xor_sync(unsigned, float x, int o) {
  const int l = threadIdx.x & 31;
  emu::warp_f[l] = x;
  emu::warp_bar->arrive_and_wait();
  const float r = emu::warp_f[l ^ o];
  emu::warp_bar->arrive_and_wait();
  return r;
}
inline float __shfl_sync(unsigned, float x, int src) {
  const int l = threadIdx.x & 31;
  emu::warp_f[l] = x;
  emu::warp_bar->arrive_and_wait();
  const float r = emu::warp_f[src & 31];
  emu::warp_bar->arrive_and_wait();
  return r;
}
inline unsigned __ballot_sync(unsigned, bool p) {
  return emu::collect(p ? 1 << (threadIdx.x & 31) : 0, false);
}
inline int __ffs(int x) { return __builtin_ffs(x); }
inline bool __any_sync(unsigned, bool p) { return emu::collect(p, false); }
inline int __reduce_max_sync(unsigned, int x) { return emu::collect(x, true); }
"""


def translate(src: str) -> str:
    """A kernel's .cu source -> C++ on top of EMUL_H. The include and the
    launch must be found; the other edits apply where the source has the
    construct (a construct the emulation lacks fails the g++ build)."""
    edits = [
        (r"#include <cuda_runtime.h>", '#include "emul.h"', True),
        (r"extern __shared__ float4 smem\[\];",
         "float4* smem = reinterpret_cast<float4*>(emu::dyn.data());", False),
        (r"__shared__ ", "static ", False),
        (r'asm volatile\("cp\.async\.cg.*?\);', "std::memcpy(dst, src, 16);",
         False),
        (r'asm volatile\("cp\.async\.ca\.shared\.global \[%0\], \[%1\], 4;'
         r'.*?\);', "std::memcpy(dst, src, 4);", False),
        (r'asm volatile\("cp\.async\.ca.*?, 8;.*?\);',
         "std::memcpy(dst, src, 8);", False),
        (r'asm volatile\("cp\.async\.commit_group.*?\);', "", False),
        (r'asm volatile\("cp\.async\.wait_group.*?\);', "", False),
        (r"(\w+)<<<(.*?)>>>\(", r"emu::launch(\1, \2, ", True),
    ]
    for pattern, repl, required in edits:
        src, n = re.subn(pattern, repl, src, flags=re.S)
        assert n >= 1 or not required, \
            f"the kernel source no longer has {pattern!r}"
    return src


def build_emulated(name: str, out_dir: Path) -> Path:
    """Translate csrc/<name>.cu and build it with g++ into a shared library
    in out_dir; skips the calling test without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the emulated kernel")
    (out_dir / "emul.h").write_text(EMUL_H)
    cpp = out_dir / f"{name}.cpp"
    cpp.write_text(translate((CSRC / f"{name}.cu").read_text()))
    lib = out_dir / f"lib{name}.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared",
                    "-fPIC", "-pthread", "-I", str(out_dir), "-o", str(lib),
                    str(cpp)], check=True, timeout=300)
    return lib


def scene_inputs(tile, n, seed, lod=False, stacked=False, frame=(48, 32)):
    """A small projected scene binned for `tile`: (feats, sorted_gid,
    tile_starts, tile_counts) and the blend keywords. `stacked`: n faint
    Gaussians on the axis; at n = 400 a few centre pixels stop (T under
    t_eps) at entry ~320."""
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
    return (feats, bins.sorted_gid, bins.tile_starts, bins.tile_counts), kw
