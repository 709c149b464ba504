"""ctypes bindings for the native runtime components (port of
hlod_gaussians_tpu/native.py).

* `NativeImageLoader`: threaded JPEG/PNG decode and prefetch pool
  (native/src/image_loader.cpp), the role torch DataLoader workers play in
  the reference (train_single.py:53). Decodes with PIL when the loader
  library cannot be built (no libjpeg / libpng headers, say).
* `build_hierarchy_file`: the offline hierarchy creator
  (native/src/hierarchy_creator.cpp), the .dhier-writing equivalent of the
  reference's GaussianHierarchyCreator executable.

Build: at first use, the host C++ compiler (`g++ -O2 -fPIC -pthread
-std=c++17 -shared`, no cmake) compiles each source in the repository's
`native/src/` into its own shared library under
`hlod_gaussians_torch/_build/native/`, named by a hash of the source and
the flags, and moves it into place atomically (concurrent builds agree).
The creator needs only the C++ standard library; the loader links
`-ljpeg -lpng`. Nothing is built while this module is imported.
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
from typing import Sequence, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE_DIR = _PKG.parent / "native" / "src"
BUILD_DIR = _PKG / "_build" / "native"
CXX_FLAGS = ("-O2", "-fPIC", "-pthread", "-std=c++17", "-shared")
# library -> (source in native/src, link flags)
LIBRARIES = {"hierarchy_creator": ("hierarchy_creator.cpp", ()),
             "image_loader": ("image_loader.cpp", ("-ljpeg", "-lpng"))}


def _lib_path(name: str) -> Path:
    src, link = LIBRARIES[name]
    key = hashlib.sha256((SOURCE_DIR / src).read_bytes()
                         + " ".join(CXX_FLAGS + link).encode()
                         ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{key}.so"


def build(name: str) -> Path:
    """Compile library `name` unless its hashed output exists; returns its
    path. Raises RuntimeError with the compiler's output on failure."""
    lib = _lib_path(name)
    if lib.exists():
        return lib
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError(f"no C++ compiler (g++ or c++ on PATH) to build "
                           f"native/src/{LIBRARIES[name][0]}")
    src, link = LIBRARIES[name]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE_DIR / src), *link],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{cxx} failed on native/src/{src} ({proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)        # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build(name)))
    if name == "hierarchy_creator":
        lib.hlod_build_hierarchy_file.restype = ctypes.c_int
        lib.hlod_build_hierarchy_file.argtypes = [ctypes.c_char_p,
                                                  ctypes.c_char_p]
        return lib
    lib.hlod_loader_create.restype = ctypes.c_void_p
    lib.hlod_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int]
    lib.hlod_loader_shape.restype = ctypes.c_int
    lib.hlod_loader_shape.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.hlod_loader_read.restype = ctypes.c_int
    lib.hlod_loader_read.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.hlod_loader_prefetch.restype = None
    lib.hlod_loader_prefetch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.hlod_loader_destroy.restype = None
    lib.hlod_loader_destroy.argtypes = [ctypes.c_void_p]
    return lib


def _loaded(name: str):
    try:
        return _library(name)
    except (RuntimeError, OSError):
        return None


def native_available() -> Tuple[str, ...]:
    """The names of the native libraries that build and load here (empty,
    and so false, when none does)."""
    return tuple(name for name in LIBRARIES if _loaded(name) is not None)


class NativeImageLoader:
    """Threaded prefetching image loader; returns [3,H,W] float32 in [0,1].
    `library` says which decoder serves it: "image_loader" or "PIL"."""

    def __init__(self, paths: Sequence[str], n_threads: int = 8,
                 max_width: int = 1600, cache_cap: int = 64):
        self.paths = list(paths)
        self.max_width = max_width
        self._handle = None
        self._lib = _loaded("image_loader")
        self.library = "PIL" if self._lib is None else "image_loader"
        if self._lib is not None:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths])
            self._handle = self._lib.hlod_loader_create(
                arr, len(self.paths), n_threads, max_width, cache_cap)

    def prefetch(self, idxs: Sequence[int]) -> None:
        if self._handle is not None and len(idxs):
            arr = (ctypes.c_int * len(idxs))(*idxs)
            self._lib.hlod_loader_prefetch(self._handle, arr, len(idxs))

    def get(self, idx: int) -> np.ndarray:
        if self._handle is not None:
            h = ctypes.c_int()
            w = ctypes.c_int()
            if self._lib.hlod_loader_shape(self._handle, idx, ctypes.byref(h),
                                           ctypes.byref(w)) == 0:
                out = np.empty((3, h.value, w.value), np.float32)
                rc = self._lib.hlod_loader_read(
                    self._handle, idx,
                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    out.size)
                if rc == 0:
                    return out
        return self._pil_get(idx)

    def _pil_get(self, idx: int) -> np.ndarray:
        from PIL import Image
        img = Image.open(self.paths[idx]).convert("RGB")
        if self.max_width > 0 and img.width > self.max_width:
            nh = round(img.height * self.max_width / img.width)
            img = img.resize((self.max_width, nh), Image.BILINEAR)
        a = np.asarray(img, np.float32) / 255.0
        return np.transpose(a, (2, 0, 1)).copy()

    def close(self):
        if self._handle is not None:
            self._lib.hlod_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def build_hierarchy_file(in_ply: str, out_dhier: str) -> int:
    """Run the native offline hierarchy creator. Returns the node count;
    raises RuntimeError, with the compiler's output, when its library
    cannot be built."""
    rc = _library("hierarchy_creator").hlod_build_hierarchy_file(
        in_ply.encode(), out_dhier.encode())
    if rc < 0:
        raise RuntimeError(f"hierarchy creator failed with code {rc}")
    return rc
