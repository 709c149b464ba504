"""Kernel sparse_adam's CUDA source (hlod_gaussians_torch/csrc/
sparse_adam.cu) run on the CPU through the wrapper's own C call,
optim.launch_sparse_adam, against its plain version, optim.sparse_adam_plain.

tests/cuda_emulation.py translates the source into C++ that g++ builds (a
std::thread per CUDA thread), so the kernel's own control flow runs: the
segment table, each block's segment, the 16-byte path and the float-by-
float one (a segment's ragged end, a tensor that is not 16-byte aligned),
the row of each float and its mask byte, inputs whose rows lie apart
(f_dc's and f_rest's gradients, views of one tensor; p, m and v as column
views of one packed matrix), a gradient broadcast from a row (copied),
the exposure table's own mask and a tensor of no elements. The cases
cover no mask, a partial and an empty one, steps 1 and 7, row widths 1, 3,
4, 9 and 45 and a tensor at lr 0. Rows outside the mask keep p, m and v bit
for bit; m and v of the updated rows are bit for bit the plain chain's (the
same products and sums, each rounded once); p agrees to rounding, since on
the CPU the chain divides by the bias corrections where the card's chain,
and the kernel, multiply by their reciprocals. Each emulated launch runs in
a subprocess with a time limit. The C call refuses, before any launch,
more segments than a launch takes, a segment of 2^32 floats and a stride
below its width. Skips without g++.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from cuda_emulation import build_emulated
from hlod_gaussians_torch import optim

# the subprocess: load the library, run the wrapper's C call on the inputs
RUNNER = r"""
import ctypes, sys, torch
from hlod_gaussians_torch import optim
from hlod_gaussians_torch.ops import rasterize_cuda
lib = ctypes.CDLL(sys.argv[1])
lib.sparse_adam_launch.argtypes = rasterize_cuda.ARGTYPES["sparse_adam"]
lib.sparse_adam_launch.restype = ctypes.c_int
lib.sparse_adam_error_string.restype = ctypes.c_char_p
d = torch.load(sys.argv[2])
p, s = optim.launch_sparse_adam(
    lib, d["p"], d["g"], optim.AdamState(m=d["m"], v=d["v"], step=d["step"]),
    d["lrs"], d["visible"], 0.9, 0.999, 1e-15, None)
torch.save(dict(p=p, m=s.m, v=s.v, step=s.step), sys.argv[3])
"""

# the subprocess: the C call on null data pointers (a launch would fault),
# every segment alike; prints its return code
REFUSAL_RUNNER = r"""
import ctypes, sys
from hlod_gaussians_torch.ops import rasterize_cuda
lib = ctypes.CDLL(sys.argv[1])
lib.sparse_adam_launch.argtypes = rasterize_cuda.ARGTYPES["sparse_adam"]
n, numel, width, stride = (int(x) for x in sys.argv[2:6])
arr = lambda t, xs: (t * len(xs))(*xs)
print(lib.sparse_adam_launch(
    n, arr(ctypes.c_void_p, [None] * (8 * n)), arr(ctypes.c_longlong,
    [numel] * n), arr(ctypes.c_int, [width] * n), arr(ctypes.c_longlong,
    [stride] * (4 * n)), arr(ctypes.c_float, [1e-3] * n), 0.9, 0.999, 0.1,
    0.001, 10.0, 1000.0, 1e-15, None))
"""

# rows C; widths by key; the exposure table [3, 3, 4] rides along
WIDTHS = dict(opacity_logit=(1,), xyz=(3,), quat=(4,), w9=(3, 3),
              f_rest=(15, 3), f_dc=(1, 3), empty=(0, 3))


def _inputs(c, seed):
    """p, g, m, v of every key of WIDTHS at C rows plus the exposure table.
    quat lies 4 bytes into its storage (not 16-byte aligned)."""
    rng = np.random.default_rng(seed)
    shapes = {k: (c,) + w for k, w in WIDTHS.items()}
    shapes["exposure"] = (3, 3, 4)

    def f(s, scale=1.0, shift=False):
        a = torch.as_tensor((rng.normal(size=s) * scale).astype(np.float32))
        if not shift:
            return a
        store = torch.empty(a.numel() + 1)
        out = store[1:].view(s)          # 4 bytes into the storage
        out.copy_(a)
        return out

    p = {k: f(s, shift=k == "quat") for k, s in shapes.items()}
    g = {k: f(s, 0.01) for k, s in shapes.items()}
    g["exposure"][1] = 0.0               # an image without gradient
    # f_dc's and f_rest's gradients as autograd hands them over: rows of
    # one [C, 16, 3] tensor; xyz's broadcast from one row (stride 0)
    sh = f((c, 16, 3), 0.01)
    g["f_dc"], g["f_rest"] = sh[:, :1], sh[:, 1:]
    g["xyz"] = f((1, 3), 0.01).expand(c, 3)
    m = {k: f(s, 0.01) for k, s in shapes.items()}
    v = {k: f(s, 1e-4).abs() for k, s in shapes.items()}
    # w9's p, m and v as the out-of-core trainer hands them over: column
    # views of one packed matrix
    packed = f((c, 3 * 9 + 5))
    packed[:, 9:18] = m["w9"].reshape(c, 9)
    packed[:, 18:27] = v["w9"].reshape(c, 9)
    p["w9"], m["w9"], v["w9"] = (packed[:, i:i + 9].reshape(c, 3, 3)
                                 for i in (0, 9, 18))
    lrs = {k: 1e-3 * (1 + i) for i, k in enumerate(shapes)}
    lrs["w9"] = 0.0                      # a tensor at lr 0
    return p, g, m, v, lrs


@pytest.fixture(scope="module")
def emulated_lib(tmp_path_factory):
    lib = build_emulated("sparse_adam",
                         tmp_path_factory.mktemp("sparse_adam_emulated"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # tiny tensors; the workers share cores
    yield lib
    torch.set_num_threads(threads)


CASES = {
    "all-step1": dict(mask=None, step=0),
    "partial-step7": dict(mask=0.6, step=6),
    "empty-step7": dict(mask=0.0, step=6),
    "partial-step1-ragged": dict(mask=0.6, step=0, c=301),
}


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_sparse_adam_matches_plain(case, emulated_lib, tmp_path):
    """The kernel's source, emulated, against sparse_adam_plain: rows
    outside the mask and the gradient-free image bit for bit, m and v
    bit for bit, p to rounding."""
    cs = CASES[case]
    c = cs.get("c", 256)
    p, g, m, v, lrs = _inputs(c, seed=len(case))
    visible = (None if cs["mask"] is None else
               torch.as_tensor(np.random.default_rng(1).random(c)
                               < cs["mask"]))
    state = optim.AdamState(m=m, v=v, step=cs["step"])
    ref_p, ref_s = optim.sparse_adam_plain(p, g, state, lrs, visible)
    torch.save(dict(p=p, g=g, m=m, v=v, lrs=lrs, visible=visible,
                    step=cs["step"]), tmp_path / "in.pt")
    subprocess.run([sys.executable, "-c", RUNNER, str(emulated_lib),
                    str(tmp_path / "in.pt"), str(tmp_path / "out.pt")],
                   check=True, timeout=300)
    got = torch.load(tmp_path / "out.pt")
    assert got["step"] == ref_s.step == cs["step"] + 1
    for k in p:
        for part, ref in (("m", ref_s.m[k]), ("v", ref_s.v[k])):
            assert torch.equal(got[part][k], ref), (part, k)
        torch.testing.assert_close(got["p"][k], ref_p[k], rtol=1e-6,
                                   atol=1e-9, msg=f"p {k}")
        if k == "exposure":
            keep = torch.tensor([False, True, False])
        elif visible is None:
            keep = torch.zeros(c, dtype=torch.bool)
        else:
            keep = ~visible
        for part, old in (("p", p[k]), ("m", m[k]), ("v", v[k])):
            assert torch.equal(got[part][k][keep], old[keep]), (part, k)
        if k != "empty" and k != "exposure" and cs["mask"] != 0.0:
            assert not torch.equal(got["m"][k], m[k]), k   # rows moved
    assert torch.equal(got["p"]["w9"], p["w9"])            # lr 0


# segments, floats a segment, width, stride -> the C call's return code
REFUSALS = {
    "9-segments": ((9, 12, 3, 3), 1),
    "2^32-floats": ((1, 1 << 32, 1, 1), 1),
    "stride-below-width": ((1, 12, 3, 2), 1),
    "7-empty-segments": ((7, 0, 3, 3), 0),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_emulated_sparse_adam_refuses_before_any_launch(case, emulated_lib):
    """More segments than one launch takes, a segment of 2^32 floats and a
    stride below its width return cudaErrorInvalidValue (1 in the
    emulation) without a launch; segments of no floats return success
    without one."""
    args, rc = REFUSALS[case]
    got = subprocess.run(
        [sys.executable, "-c", REFUSAL_RUNNER, str(emulated_lib),
         *map(str, args)], check=True, timeout=120, capture_output=True,
        text=True)
    assert int(got.stdout.split()[-1]) == rc
