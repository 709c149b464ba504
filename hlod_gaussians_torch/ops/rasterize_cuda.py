"""Kernel wrappers: the hand-written CUDA blend forward (B1) and backward
(B2), and the build of every kernel source of the port.

B1 `blend_forward` replaces hlod_gaussians_tpu/ops/rasterize_pallas.py
::blend_forward, B2 `blend_backward` replaces ::blend_backward (the Pallas
TPU kernels). The sources are `hlod_gaussians_torch/csrc/blend_forward.cu`
and `csrc/blend_backward.cu`; their header notes give the design and what
bounds each. Both cover a tile with one block: 4, 2 or 1 pixels a thread,
the most that splits the tile into whole warp patches. B1 takes any tile of
1 to 1024 pixels (one pixel a thread, the last warp partial, where the
pixel count is not a multiple of 32); B2 only tiles of a multiple of 32
pixels.

Build: at first use, `nvcc -gencode arch=compute_90a,code=sm_90a -O3
-shared -Xcompiler -fPIC` compiles each source of `SOURCES` (the blend
kernels, `csrc/lod_preprocess.cu`, whose wrapper is `ops/lod_preprocess.py`,
`csrc/sparse_adam.cu`, whose wrapper is `optim.sparse_adam_cuda`, and
`csrc/train_preprocess.cu`, whose wrapper is `ops/train_preprocess.py`) into
a shared library with a plain C launcher under `hlod_gaussians_torch/
_build/`, named by a hash of that source and its flags, and loads it with
ctypes. `build()` starts one nvcc per missing
library, all at once. Nothing is built or imported while this module is
imported.

Dispatch: on CPU tensors each wrapper runs its plain version
(`rasterize_xla.blend_forward_plain` / `blend_backward_plain`); on CUDA
tensors it launches the kernel on the current stream or raises.
`blend_forward.launches` and `blend_backward.launches` count the kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from hlod_gaussians_torch.ops.binning import tile_grid
from hlod_gaussians_torch.ops.rasterize_xla import (N_FEATS,
                                                    blend_backward_plain,
                                                    blend_forward_plain)

_PKG = Path(__file__).resolve().parents[1]
SOURCES = {name: _PKG / "csrc" / f"{name}.cu"
           for name in ("blend_forward", "blend_backward", "lod_preprocess",
                        "sparse_adam", "train_preprocess")}
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# lod_preprocess, sparse_adam and train_preprocess follow their plain
# versions' rounding op by op: no FMAs
EXTRA_FLAGS = {"lod_preprocess": ("-fmad=false",),
               "sparse_adam": ("-fmad=false",),
               "train_preprocess": ("-fmad=false",)}
_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the signature of each launcher `<key>_launch`; a library's launchers are
# LAUNCHERS[name], by default `<name>_launch` alone
_TRAIN_PRE = [_p] * 13 + [_f, _f] + [_i] * 5 + [_f] * 4 + [_i]
ARGTYPES = {
    "blend_forward": [_p] * 4 + [_i] * 6 + [_f, _f, _i] + [_p] * 5,
    "blend_backward": [_p] * 8 + [_i] * 6 + [_f, _i, _p, _p],
    "lod_preprocess": ([_p] * 10 + [_f, _f] + [_i] * 6 + [_f] * 4 + [_i]
                       + [_p] * 7),
    "sparse_adam": [_i] + [_p] * 5 + [_f] * 7 + [_p],
    "train_preprocess_forward": _TRAIN_PRE + [_p] * 7,
    "train_preprocess_backward": _TRAIN_PRE + [_p] * 9,
}
LAUNCHERS = {"train_preprocess": ("train_preprocess_forward",
                                  "train_preprocess_backward")}


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    src = SOURCES[name].read_bytes()
    flags = " ".join(_flags(name)).encode()
    key = hashlib.sha256(src + flags).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{key}.so"


def build(names=tuple(SOURCES)) -> dict:
    """Compile the kernel libraries whose hashed outputs are missing, one
    nvcc process per source, all started together. Returns {name: (library
    path, compiler output — register and shared-memory use)}."""
    missing = [name for name in names if not _lib_path(name).exists()]
    nvcc = _nvcc() if missing else None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    try:
        for name in missing:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            jobs[name] = (tmp, subprocess.Popen(
                [nvcc, *_flags(name), "-o", tmp, str(SOURCES[name])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (tmp, proc) in jobs.items():
            out = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {SOURCES[name].name} "
                              f"({proc.returncode}):\n{out}")
                continue
            lib = _lib_path(name)
            lib.with_suffix(".log").write_text(out)
            os.replace(tmp, lib)        # atomic: concurrent builds agree
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for tmp, proc in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    out = {}
    for name in names:
        log = _lib_path(name).with_suffix(".log")
        out[name] = (_lib_path(name),
                     log.read_text() if log.exists() else "")
    return out


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build((name,))[name][0]))
    for key in LAUNCHERS.get(name, (name,)):
        launch = getattr(lib, f"{key}_launch")
        launch.argtypes = ARGTYPES[key]
        launch.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_entries(feats, sorted_gid, tile_starts, tile_counts, gw, gh):
    n = feats.shape[0]
    _check(feats, "feats", torch.float32, (n, N_FEATS))
    if feats.data_ptr() % 16:
        raise ValueError("feats must be 16-byte aligned (float4 row loads)")
    _check(sorted_gid, "sorted_gid", torch.int32, (sorted_gid.shape[0],))
    _check(tile_starts, "tile_starts", torch.int32, (gw * gh,))
    _check(tile_counts, "tile_counts", torch.int32, (gw * gh,))


def launch_blend_forward(feats, sorted_gid, tile_starts, tile_counts, img4,
                         final_t, n_contrib, seen, *, width: int, height: int,
                         tile_w: int, tile_h: int, t_eps: float,
                         alpha_min: float, use_lod: bool) -> None:
    """One launch of kernel B1 on the current stream into preallocated
    outputs (seen zeroed, or None), with no checks and no count: the C call
    that blend_forward makes, also timed bare."""
    gw, gh = tile_grid(width, height, tile_w, tile_h)
    lib = _library("blend_forward")
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        err = lib.blend_forward_launch(
            feats.data_ptr(), sorted_gid.data_ptr(), tile_starts.data_ptr(),
            tile_counts.data_ptr(), gw * gh, gw, tile_w, tile_h, width,
            height, float(t_eps), float(alpha_min), int(use_lod),
            img4.data_ptr(), final_t.data_ptr(), n_contrib.data_ptr(),
            seen.data_ptr() if seen is not None else None, stream)
    if err != 0:
        raise RuntimeError("blend_forward kernel launch failed: "
                           f"{lib.blend_forward_error_string(err).decode()}")


def launch_blend_backward(feats, sorted_gid, tile_starts, tile_counts,
                          final_t, n_contrib, g_img4, g_final_t, egrads, *,
                          width: int, height: int, tile_w: int, tile_h: int,
                          alpha_min: float, use_lod: bool) -> None:
    """One launch of kernel B2 on the current stream into a zeroed
    [max_dup, 12] egrads, with no checks and no count: the C call that
    blend_backward makes, also timed bare."""
    gw, gh = tile_grid(width, height, tile_w, tile_h)
    lib = _library("blend_backward")
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        err = lib.blend_backward_launch(
            feats.data_ptr(), sorted_gid.data_ptr(), tile_starts.data_ptr(),
            tile_counts.data_ptr(), final_t.data_ptr(), n_contrib.data_ptr(),
            g_img4.data_ptr(), g_final_t.data_ptr(), gw * gh, gw, tile_w,
            tile_h, width, height, float(alpha_min), int(use_lod),
            egrads.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("blend_backward kernel launch failed: "
                           f"{lib.blend_backward_error_string(err).decode()}")


def blend_forward(feats, sorted_gid, tile_starts, tile_counts, *,
                  width: int, height: int, tile_w: int, tile_h: int,
                  t_eps: float = 1e-4, alpha_min: float = 1.0 / 255.0,
                  use_lod: bool = False, want_seen: bool = False):
    """feats [N, 12] float32 (rasterize_xla.blend_features), sorted_gid
    [max_dup] int32, tile_starts / tile_counts [T] int32 ->
    (img4 [4, H, W], final_t [H, W], n_contrib [H, W] int32, seen [N] bool
    or None). The contract of rasterize_xla.blend_forward_plain."""
    if feats.device.type == "cpu":
        return blend_forward_plain(
            feats, sorted_gid, tile_starts, tile_counts, width=width,
            height=height, tile_w=tile_w, tile_h=tile_h, t_eps=t_eps,
            alpha_min=alpha_min, use_lod=use_lod, want_seen=want_seen)

    if not (tile_w > 0 and tile_h > 0 and tile_w * tile_h <= 1024):
        raise ValueError(f"tile {tile_w}x{tile_h}: the kernel covers a tile "
                         "with one block of up to 1024 threads (4, 2 or 1 "
                         "pixels a thread), so tile_w * tile_h must be in "
                         "[1, 1024]")
    gw, gh = tile_grid(width, height, tile_w, tile_h)
    n = feats.shape[0]
    _check_entries(feats, sorted_gid, tile_starts, tile_counts, gw, gh)

    dev = feats.device
    img4 = torch.empty((4, height, width), dtype=torch.float32, device=dev)
    final_t = torch.empty((height, width), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((height, width), dtype=torch.int32, device=dev)
    seen = (torch.zeros((n,), dtype=torch.uint8, device=dev)
            if want_seen else None)
    launch_blend_forward(
        feats, sorted_gid, tile_starts, tile_counts, img4, final_t,
        n_contrib, seen, width=width, height=height, tile_w=tile_w,
        tile_h=tile_h, t_eps=t_eps, alpha_min=alpha_min, use_lod=use_lod)
    blend_forward.launches += 1
    return img4, final_t, n_contrib, (seen.bool() if want_seen else None)


blend_forward.launches = 0


def blend_backward(feats, sorted_gid, tile_starts, tile_counts, final_t,
                   n_contrib, g_img4, g_final_t, *,
                   width: int, height: int, tile_w: int, tile_h: int,
                   alpha_min: float = 1.0 / 255.0, use_lod: bool = False):
    """feats, sorted_gid, tile_starts, tile_counts as for blend_forward; its
    final_t [H, W] and n_contrib [H, W] int32; cotangents g_img4 [4, H, W]
    and g_final_t [H, W] -> per-entry gradients [max_dup, 12] float32. The
    contract of rasterize_xla.blend_backward_plain."""
    if feats.device.type == "cpu":
        return blend_backward_plain(
            feats, sorted_gid, tile_starts, tile_counts, final_t, n_contrib,
            g_img4, g_final_t, width=width, height=height, tile_w=tile_w,
            tile_h=tile_h, alpha_min=alpha_min, use_lod=use_lod)

    gw, gh = tile_grid(width, height, tile_w, tile_h)
    nthr = tile_w * tile_h
    if not 0 < nthr <= 1024 or nthr % 32:
        raise ValueError(f"tile {tile_w}x{tile_h}: the kernel covers a tile "
                         "with whole warps of 1, 2 or 4 pixels a thread, so "
                         "tile_w * tile_h must be a multiple of 32 in "
                         "[32, 1024]")
    _check_entries(feats, sorted_gid, tile_starts, tile_counts, gw, gh)
    _check(final_t, "final_t", torch.float32, (height, width))
    _check(n_contrib, "n_contrib", torch.int32, (height, width))
    _check(g_img4, "g_img4", torch.float32, (4, height, width))
    _check(g_final_t, "g_final_t", torch.float32, (height, width))

    dev = feats.device
    max_dup = sorted_gid.shape[0]
    # entries past each tile's last applied one are never written
    egrads = torch.zeros((max_dup, N_FEATS), dtype=torch.float32, device=dev)
    launch_blend_backward(
        feats, sorted_gid, tile_starts, tile_counts, final_t, n_contrib,
        g_img4, g_final_t, egrads, width=width, height=height, tile_w=tile_w,
        tile_h=tile_h, alpha_min=alpha_min, use_lod=use_lod)
    blend_backward.launches += 1
    return egrads


blend_backward.launches = 0
