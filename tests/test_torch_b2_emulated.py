"""Kernel B2's CUDA source (hlod_gaussians_torch/csrc/blend_backward.cu) run
on the CPU against its plain version, blend_backward_plain.

tests/cuda_emulation.py translates the source into C++ that g++ builds (a
std::thread per CUDA thread, barriers for the block and warp collectives).
That runs the kernel's own control flow without a GPU: the launch shapes
with 4, 2 and 1 pixels a thread, the entry ring over many batches, warps
that stop early, ragged tiles, the reduce-scatter butterfly and the
cross-warp sums. The arithmetic is the host's, so the result agrees with the
plain version to rounding, as on the card; the card's own run is
tests/test_torch_cuda.py. Each emulated launch runs in a subprocess with a
time limit. Skips without g++.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from cuda_emulation import build_emulated, scene_inputs
from hlod_gaussians_torch.ops.binning import tile_grid
from hlod_gaussians_torch.ops.rasterize_xla import (blend_backward_plain,
                                                    blend_forward_plain)

GRAD_ATOL = 3e-4     # per-entry gradients, scaled by the largest magnitude

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


@pytest.fixture(scope="module")
def emulated_lib(tmp_path_factory):
    lib = build_emulated("blend_backward",
                         tmp_path_factory.mktemp("b2_emulated"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # tiny tensors; the workers share cores
    yield lib
    torch.set_num_threads(threads)


def _inputs(tile, n, seed, lod=False, stacked=False, frame=(48, 32)):
    args, kw = scene_inputs(tile, n, seed, lod, stacked, frame)
    _, final_t, n_contrib, _ = blend_forward_plain(*args, **kw)
    rng = np.random.default_rng(seed + 1)
    width, height = frame
    g4 = torch.as_tensor(rng.normal(size=(4, height, width)).astype(
        np.float32))
    gft = torch.as_tensor(rng.normal(size=(height, width)).astype(
        np.float32))
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
