"""Kernels train_preprocess_forward and train_preprocess_backward's CUDA
source (hlod_gaussians_torch/csrc/train_preprocess.cu) run on the CPU
through the wrapper's own C calls, ops/train_preprocess.launch_forward and
launch_backward, against their plain version, train_preprocess_plain,
differentiated by autograd.

tests/cuda_emulation.py translates the source into C++ that g++ builds (a
std::thread per CUDA thread, barriers for the warp collectives), so the
kernels' own control flow runs: the warp's ballot of the rows in the mask,
the 4-byte cp.async staging of their parameter spans, f_rest read only as
far as the degree needs, the gradients written back through shared memory
as contiguous runs, and a last warp that the capacity cuts. The cases, of
601 rows each, cover SH degrees 0, 1 and 3 (f_rest stored at 15
coefficients), antialiasing off and on, a finite big_limit, rows behind the
near plane, rows whose 2D determinant is not positive (a negative
dilation), rows whose tx / ty the projection clamps, rows outside the mask,
and a non-zero xy_offset or none.

Forward: on the valid rows the feature rows, depth, ext and reff2 agree to
rounding (2e-5); radius and valid are equal on every row; every other row
is sanitised as project_gaussians sanitises it, keeps its colour in the
mask and takes colour 0 outside it. Backward, for a random gradient of the
feature rows in the mask (zero outside, as the blend's reduction gives):
every parameter's gradient and xy_offset's agree with autograd's to 1e-5 of
the tensor's largest magnitude plus 1e-4 relative (float32 through some 100
dependent operations summed in another order, with the determinant's
cancellation); f_rest past the degree and every row outside the mask are
zero. Each emulated launch runs in a subprocess with a time limit. Skips
without g++.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from cuda_emulation import build_emulated
from hlod_gaussians_torch.ops import sh as sh_ops
from hlod_gaussians_torch.ops import train_preprocess as tp
from hlod_gaussians_torch.utils.camera import make_camera

W, H = 64, 48
ROWS = 601
RTOL, ATOL = 2e-5, 2e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5    # the atol scaled by max |gradient|

# the subprocess: load the library, run the wrapper's two C calls
RUNNER = r"""
import ctypes, sys, torch
from hlod_gaussians_torch.ops import rasterize_cuda, train_preprocess as tp
lib = ctypes.CDLL(sys.argv[1])
for key in rasterize_cuda.LAUNCHERS["train_preprocess"]:
    getattr(lib, key + "_launch").argtypes = rasterize_cuda.ARGTYPES[key]
    getattr(lib, key + "_launch").restype = ctypes.c_int
lib.train_preprocess_error_string.restype = ctypes.c_char_p
d = torch.load(sys.argv[2])
out = tp.launch_forward(lib, d["p"], d["mask"], d["xy"], d["cam"], d["kw"],
                        None)
grads, g_xy = tp.launch_backward(lib, d["p"], d["mask"], d["xy"], d["cam"],
                                 d["kw"], d["g"], None)
torch.save(dict(out=tuple(out), grads=grads, g_xy=g_xy), sys.argv[3])
"""

# the C calls on null pointers with a degree past f_rest's coefficients:
# refused before any launch (a launch would fault); prints the codes
REFUSAL_RUNNER = r"""
import ctypes, sys
from hlod_gaussians_torch.ops import rasterize_cuda
lib = ctypes.CDLL(sys.argv[1])
codes = []
for key, n_out in (("train_preprocess_forward", 7),
                   ("train_preprocess_backward", 9)):
    fn = getattr(lib, key + "_launch")
    fn.argtypes = rasterize_cuda.ARGTYPES[key]
    for deg, k_rest in ((1, 0), (3, 8), (4, 15)):
        codes.append(fn(*[None] * 13, 0.5, 0.5, 64, k_rest, 8, 8, deg, 0.3,
                        0.2, 1e30, 1 / 255, 0, *[None] * n_out))
print(codes)
"""

# SH degree, antialiasing, dilation, big_limit, an xy_offset
CASES = {
    "sh0": dict(deg=0),
    "sh1-of-3-aa": dict(deg=1, aa=True),
    "sh1-of-3-no-offset": dict(deg=1, offset=False),
    "sh3": dict(deg=3),
    "sh3-aa-big-limit": dict(deg=3, aa=True, big=0.12),
    "sh3-det": dict(deg=3, dilation=-0.3),
}


@pytest.fixture(scope="module")
def emulated_lib(tmp_path_factory):
    lib = build_emulated("train_preprocess",
                         tmp_path_factory.mktemp("train_preprocess_emulated"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # tiny tensors; the workers share cores
    yield lib
    torch.set_num_threads(threads)


def _inputs(seed=3):
    """601 rows of raw parameters at SH 3 storage: 20 behind the near plane
    or the camera, 20 beyond the clamp of tx, 10 too faint to draw; a mask
    of about 85 %, an xy_offset, a camera off the origin, and a gradient of
    the feature rows on the rows in the mask."""
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(ROWS, 3)) * [1.5, 1.2, 1.0]
    xyz[:, 2] = rng.uniform(0.5, 6.0, ROWS)
    xyz[:20, 2] = rng.uniform(-3.0, 0.15, 20)
    xyz[20:40, 0] = (xyz[20:40, 2] * rng.choice([-1.0, 1.0], 20)
                     * rng.uniform(0.7, 1.5, 20))
    log_scale = rng.normal(size=(ROWS, 3)) * 0.5 - 2.5
    opacity_logit = rng.normal(size=(ROWS, 1)) * 2.0
    opacity_logit[40:50] = -9.0
    p = [torch.as_tensor(np.asarray(a, np.float32)) for a in (
        xyz, log_scale, rng.normal(size=(ROWS, 4)), opacity_logit,
        rng.normal(size=(ROWS, 1, 3)) * 0.5,
        rng.normal(size=(ROWS, 15, 3)) * 0.3)]
    mask = torch.as_tensor(rng.uniform(size=ROWS) < 0.85)
    xy = torch.as_tensor((rng.normal(size=(ROWS, 2)) * 0.5).astype(np.float32))
    cam = make_camera(np.eye(3), np.array([0.1, -0.1, 0.0]), 0.9, 0.7, W, H,
                      device=torch.device("cpu"))
    g = torch.as_tensor(rng.normal(size=(ROWS, 12)).astype(np.float32))
    return p, mask, xy, cam, g * mask[:, None]


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_train_preprocess_matches_autograd(case, emulated_lib,
                                                    tmp_path):
    """The kernels' source, emulated, against the plain chain and its
    autograd gradient."""
    cs = CASES[case]
    p, mask, xy, cam, g = _inputs()
    xy = xy if cs.get("offset", True) else None
    kw = dict(width=W, height=H, sh_degree=cs["deg"],
              dilation=cs.get("dilation", 0.3), near=0.2,
              big_limit=cs.get("big", float("inf")),
              antialiasing=cs.get("aa", False), alpha_min=1.0 / 255.0)
    cam_args = (cam.world_view, cam.full_proj, cam.campos,
                cam.tan_fovx.reshape(1), float(cam.tan_fovy))
    leaves = [t.clone().requires_grad_(True) for t in p]
    xy_leaf = None if xy is None else xy.clone().requires_grad_(True)
    ref = tp.train_preprocess_plain(*leaves, mask, *cam_args, xy_leaf, **kw)
    wrt = leaves + ([] if xy is None else [xy_leaf])
    ref_grads = torch.autograd.grad(ref.feats, wrt, g)
    torch.save(dict(p=p, mask=mask, xy=xy, cam=cam_args, kw=kw, g=g),
               tmp_path / "in.pt")
    subprocess.run([sys.executable, "-c", RUNNER, str(emulated_lib),
                    str(tmp_path / "in.pt"), str(tmp_path / "out.pt")],
                   check=True, timeout=300)
    res = torch.load(tmp_path / "out.pt")
    got = tp.LodRows(*res["out"])

    # the case reaches what it names
    valid = ref.valid
    t = p[0] @ cam.world_view[:3, :3] + cam.world_view[3, :3]
    clamped = (t[:, 0] / t[:, 2]).abs() > 1.3 * float(cam.tan_fovx)
    assert 0 < int(valid.sum()) < int(mask.sum()) < ROWS
    assert int((mask & (t[:, 2] <= 0.2)).sum()) > 0
    assert int((valid & clamped).sum()) > 0
    culled_in_front = mask & (t[:, 2] > 0.2) & ~valid
    assert (int(culled_in_front.sum()) > 10) == ("big" in cs
                                                 or "dilation" in cs)

    # forward
    assert torch.equal(got.valid, valid)
    assert torch.equal(got.radius, ref.radius)
    feats = ref.feats.detach()
    for k in ("depth", "ext", "reff2"):
        torch.testing.assert_close(getattr(got, k)[valid],
                                   getattr(ref, k)[valid], rtol=RTOL,
                                   atol=ATOL)
        assert torch.equal(getattr(got, k)[~valid], getattr(ref, k)[~valid])
    torch.testing.assert_close(got.feats[valid], feats[valid], rtol=RTOL,
                               atol=ATOL)
    sanitised = [0, 1, 2, 3, 4, 5, 9, 10, 11]
    assert torch.equal(got.feats[~valid][:, sanitised],
                       feats[~valid][:, sanitised])
    culled = mask & ~valid
    torch.testing.assert_close(got.feats[culled][:, 6:9],
                               feats[culled][:, 6:9], rtol=RTOL, atol=ATOL)
    assert not got.feats[~mask][:, 6:9].any()
    assert bool(torch.isfinite(got.feats).all())

    # backward
    got_grads = res["grads"] + ([] if xy is None else [res["g_xy"]])
    assert xy is not None or res["g_xy"] is None
    names = tp._PARAMS + (() if xy is None else ("xy_offset",))
    for name, a, b in zip(names, got_grads, ref_grads):
        assert a.shape == b.shape, name
        torch.testing.assert_close(
            a, b, rtol=GRAD_RTOL,
            atol=GRAD_ATOL * max(float(b.abs().max()), 1e-30),
            msg=lambda m, name=name: f"{name}: {m}")
        if name != "xy_offset":
            assert not a[~mask].any(), name
    n_rest = sh_ops.NUM_COEFFS[cs["deg"]] - 1
    assert not got_grads[5][:, n_rest:].any()
    assert got_grads[5][:, :n_rest].any() == (n_rest > 0)


def test_emulated_train_preprocess_refuses_a_degree_past_f_rest(
        emulated_lib, tmp_path):
    """Both C calls return cudaErrorInvalidValue (1 in the emulation)
    before any launch for SH 1 without f_rest coefficients, SH 3 over 8
    and a degree past 3."""
    out = subprocess.run([sys.executable, "-c", REFUSAL_RUNNER,
                          str(emulated_lib)], check=True, timeout=60,
                         capture_output=True, text=True).stdout
    assert out.split() == ["[1,"] + ["1,"] * 4 + ["1]"]
