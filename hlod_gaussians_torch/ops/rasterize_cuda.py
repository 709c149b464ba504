"""Kernel B1 wrapper: the hand-written CUDA blend forward.

Replaces hlod_gaussians_tpu/ops/rasterize_pallas.py::blend_forward (the
Pallas TPU kernel). The source is `hlod_gaussians_torch/csrc/blend_forward.cu`;
its header note gives the design and what bounds it.

Build: at first use, `nvcc -gencode arch=compute_90a,code=sm_90a -O3
-shared -Xcompiler -fPIC` compiles the source into a shared library with a
plain C launcher under `hlod_gaussians_torch/_build/`, named by a hash of
the source and flags, and loads it with ctypes. Nothing is built or
imported while this module is imported.

Dispatch: on CPU tensors `blend_forward` runs the plain version
(`rasterize_xla.blend_forward_plain`); on CUDA tensors it launches the
kernel on the current stream or raises. `blend_forward.launches` counts the
kernel launches.
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
                                                    blend_forward_plain)

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "blend_forward.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA blend kernel cannot be built")


def build() -> tuple[Path, str]:
    """Compile the kernel library if its hashed output is missing. Returns
    (library path, compiler output — register and shared-memory use)."""
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"blend_forward_{key}.so"
    log_path = lib.with_suffix(".log")
    if lib.exists():
        return lib, log_path.read_text() if log_path.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)        # atomic: concurrent builders agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, log_path.read_text()


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.blend_forward_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, f, f,
                                         i, p, p, p, p, p]
    lib.blend_forward_launch.restype = ctypes.c_int
    lib.blend_forward_error_string.argtypes = [ctypes.c_int]
    lib.blend_forward_error_string.restype = ctypes.c_char_p
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

    gw, gh = tile_grid(width, height, tile_w, tile_h)
    n = feats.shape[0]
    if not 0 < tile_w * tile_h <= 1024:
        raise ValueError(f"tile {tile_w}x{tile_h}: the kernel runs one thread "
                         "per pixel, so tile_w * tile_h must be in [1, 1024]")
    _check(feats, "feats", torch.float32, (n, N_FEATS))
    if feats.data_ptr() % 16:
        raise ValueError("feats must be 16-byte aligned (float4 row loads)")
    _check(sorted_gid, "sorted_gid", torch.int32, (sorted_gid.shape[0],))
    _check(tile_starts, "tile_starts", torch.int32, (gw * gh,))
    _check(tile_counts, "tile_counts", torch.int32, (gw * gh,))

    dev = feats.device
    img4 = torch.empty((4, height, width), dtype=torch.float32, device=dev)
    final_t = torch.empty((height, width), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((height, width), dtype=torch.int32, device=dev)
    seen = (torch.zeros((n,), dtype=torch.uint8, device=dev)
            if want_seen else None)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.blend_forward_launch(
            feats.data_ptr(), sorted_gid.data_ptr(), tile_starts.data_ptr(),
            tile_counts.data_ptr(), gw * gh, gw, tile_w, tile_h, width,
            height, float(t_eps), float(alpha_min), int(use_lod),
            img4.data_ptr(), final_t.data_ptr(), n_contrib.data_ptr(),
            seen.data_ptr() if seen is not None else None, stream)
    if err != 0:
        raise RuntimeError("blend_forward kernel launch failed: "
                           f"{lib.blend_forward_error_string(err).decode()}")
    blend_forward.launches += 1
    return img4, final_t, n_contrib, (seen.bool() if want_seen else None)


blend_forward.launches = 0
