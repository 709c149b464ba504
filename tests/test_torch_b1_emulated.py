"""Kernel B1's CUDA source (hlod_gaussians_torch/csrc/blend_forward.cu) run
on the CPU against its plain version, blend_forward_plain.

tests/cuda_emulation.py translates the source into C++ that g++ builds (a
std::thread per CUDA thread, barriers for the block and warp collectives).
That runs the kernel's own control flow without a GPU: the launch shapes
with 4, 2 and 1 pixels a thread, a tile whose last warp is partial, the
cp.async entry ring over many batches, the per-warp and block-wide stops,
the exp-free reject and the warp-voted `seen`. The arithmetic is the host's;
n_contrib and seen must still match the plain version exactly, images and
final T to 2e-5. Each emulated launch runs in a subprocess with a time
limit. Skips without g++.
"""

import subprocess
import sys

import pytest
import torch

from cuda_emulation import build_emulated, scene_inputs
from hlod_gaussians_torch.ops.binning import tile_grid
from hlod_gaussians_torch.ops.rasterize_xla import blend_forward_plain

ATOL = 2e-5
BATCH = 32           # entries per shared-memory batch of the kernel

# the subprocess: load the library, launch twice on the saved inputs
RUNNER = r"""
import ctypes, sys, torch
lib = ctypes.CDLL(sys.argv[1])
p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
lib.blend_forward_launch.argtypes = [p] * 4 + [i] * 6 + [f, f, i] + [p] * 5
d = torch.load(sys.argv[2])
n = d["feats"].shape[0]
w, h = d["shape"][4], d["shape"][5]
outs = []
for _ in range(2):
    img4, ft = torch.zeros((4, h, w)), torch.zeros((h, w))
    nc = torch.zeros((h, w), dtype=torch.int32)
    seen = torch.zeros((n,), dtype=torch.uint8) if d["seen"] else None
    err = lib.blend_forward_launch(
        *(d[k].data_ptr() for k in ("feats", "gid", "starts", "counts")),
        *d["shape"], 1e-4, 1.0 / 255.0, d["lod"], img4.data_ptr(),
        ft.data_ptr(), nc.data_ptr(),
        seen.data_ptr() if seen is not None else None, None)
    assert err == 0, err
    outs.append((img4, ft, nc, seen))
torch.save(outs, sys.argv[3])
"""

# tile, scene, want_seen; B1 runs P = 4 at 16x16, 32x32 and 16x8, P = 2 at
# 8x8, P = 1 at 8x4 and 12x8, and one pixel a thread with a partial last
# warp at 10x6 (60 pixels). Small frames: every emulated CUDA thread is an
# OS thread and every warp collective a barrier
CASES = {
    "16x16": dict(tile=(16, 16), n=120, seed=5),
    "32x32-lod-seen": dict(tile=(32, 32), n=120, seed=7, lod=True,
                           seen=True),
    "8x8-lod": dict(tile=(8, 8), n=120, seed=13, lod=True),
    "8x4": dict(tile=(8, 4), n=120, seed=11),
    "12x8-ragged-lod": dict(tile=(12, 8), n=120, seed=17, lod=True,
                            frame=(46, 29)),
    "10x6-partial-warp-seen": dict(tile=(10, 6), n=120, seed=21, seen=True),
    # four centre pixels stop (sticky) at entry ~320, in the tenth batch
    "16x8-sticky-seen": dict(tile=(16, 8), n=400, seed=7, stacked=True,
                             seen=True),
    "32x32-ragged-seen": dict(tile=(32, 32), n=120, seed=19, frame=(46, 29),
                              seen=True),
}


@pytest.fixture(scope="module")
def emulated_lib(tmp_path_factory):
    lib = build_emulated("blend_forward",
                         tmp_path_factory.mktemp("b1_emulated"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # tiny tensors; the workers share cores
    yield lib
    torch.set_num_threads(threads)


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_forward_matches_plain(case, emulated_lib, tmp_path):
    """The kernel's source, emulated, against blend_forward_plain: image and
    final T to 2e-5, n_contrib and seen exactly; two launches give the same
    bits."""
    c = dict(CASES[case])
    want_seen = c.pop("seen", False)
    args, kw = scene_inputs(**c)
    gw, gh = tile_grid(kw["width"], kw["height"], kw["tile_w"], kw["tile_h"])
    saved = dict(zip(("feats", "gid", "starts", "counts"), args),
                 lod=int(kw["use_lod"]), seen=want_seen,
                 shape=[gw * gh, gw, kw["tile_w"], kw["tile_h"], kw["width"],
                        kw["height"]])
    torch.save(saved, tmp_path / "in.pt")
    subprocess.run([sys.executable, "-c", RUNNER, str(emulated_lib),
                    str(tmp_path / "in.pt"), str(tmp_path / "out.pt")],
                   check=True, timeout=300)
    got, again = torch.load(tmp_path / "out.pt")
    ref = blend_forward_plain(*args, **kw, want_seen=want_seen)
    torch.testing.assert_close(got[0], ref[0], atol=ATOL, rtol=0)
    torch.testing.assert_close(got[1], ref[1], atol=ATOL, rtol=0)
    assert torch.equal(got[2], ref[2])
    assert int(ref[2].max()) > 0
    if want_seen:
        assert torch.equal(got[3].bool(), ref[3]) and bool(ref[3].any())
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)
    if c.get("stacked"):
        # a pixel stopped (T under t_eps) past several entry batches
        stop = int(ref[2].flatten()[int(ref[1].argmin())])
        assert float(ref[1].min()) < 2e-4 and stop > 2 * BATCH
