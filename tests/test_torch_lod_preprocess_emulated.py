"""Kernel lod_preprocess's CUDA source
(hlod_gaussians_torch/csrc/lod_preprocess.cu) run on the CPU against its
plain version, lod_preprocess_plain, on small built trees.

tests/cuda_emulation.py translates the source into C++ that g++ builds (a
std::thread per CUDA thread, barriers for the warp collectives), so the
kernel's own control flow runs: the warp's ballot of drawn rows, the
8-byte cp.async staging of their table rows, the skybox rows ahead of the
tree's, and the rows it never reads. The cases cover SH degrees 0, 1 and
3, 0 and 5 skybox rows (one of them dead), antialiasing off and on, a
finite big_limit, rows behind the near plane, rows whose 2D determinant is
not positive (a negative dilation) and rows outside the cut. On the valid
rows the feature rows, depth, ext and reff2 agree to rounding (the host's
logf and the SH sum's order are the only differences); radius and valid
are equal on every row; every other row is sanitised and finite. Each
emulated launch runs in a subprocess with a time limit. Skips without g++.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from cuda_emulation import build_emulated
from hlod_gaussians_torch.hierarchy import build, cut
from hlod_gaussians_torch.ops.lod_preprocess import lod_preprocess_plain
from hlod_gaussians_torch.utils.camera import make_camera

W, H = 64, 48
RTOL, ATOL = 2e-5, 2e-5

# the subprocess: load the library, launch on the saved inputs
RUNNER = r"""
import ctypes, sys, torch
lib = ctypes.CDLL(sys.argv[1])
p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
lib.lod_preprocess_launch.argtypes = ([p] * 10 + [f, f] + [i] * 6 + [f] * 4
                                      + [i] + [p] * 7)
d = torch.load(sys.argv[2])
m = d["n_sky"] + d["table"].shape[0]
out = dict(feats=torch.full((m, 12), float("nan")),
           depth=torch.full((m,), float("nan")),
           radius=torch.full((m,), -7, dtype=torch.int32),
           valid=torch.full((m,), 7, dtype=torch.uint8),
           ext=torch.full((m, 2), float("nan")),
           reff2=torch.full((m,), float("nan")))
err = lib.lod_preprocess_launch(
    *(d[k].data_ptr() for k in ("table", "mask", "ts", "kids", "alive",
                                "wv", "fp", "campos", "tanx")),
    None, 0.0, d["tany"], d["table"].shape[0], d["table"].shape[1] // 2,
    d["n_sky"], d["w"], d["h"], d["deg"], d["dilation"], 0.2,
    d["big_limit"], 1.0 / 255.0, d["aa"],
    *(out[k].data_ptr() for k in ("feats", "depth", "radius", "valid",
                                  "ext", "reff2")), None)
assert err == 0, err
torch.save(out, sys.argv[3])
"""

# leaves, SH degree, skybox rows, antialiasing, big_limit, dilation
CASES = {
    "256-sh0": dict(n=256, deg=0, sky=0, aa=False),
    "256-sh1-sky5-aa": dict(n=256, deg=1, sky=5, aa=True),
    "512-sh3-big-limit": dict(n=512, deg=3, sky=0, aa=False, big=0.06),
    "1024-sh3-sky5-aa-det": dict(n=1024, deg=3, sky=5, aa=True,
                                 dilation=-0.3),
}


@pytest.fixture(scope="module")
def emulated_lib(tmp_path_factory):
    lib = build_emulated("lod_preprocess",
                         tmp_path_factory.mktemp("lod_preprocess_emulated"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # tiny tensors; the workers share cores
    yield lib
    torch.set_num_threads(threads)


def _inputs(n, deg, seed=3):
    """A built tree of n leaves at SH degree 3 (16 coefficients, so the
    lower degrees read part of each row), its InterpTable, a cut at a mid
    granularity and a camera that some nodes lie behind."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * [1.5, 1.2, 2.0]
    pts[:, 2] += 2.5
    h = build.build_hierarchy(
        pts, np.exp(rng.normal(-2.8, 0.5, (n, 3))).astype(np.float32),
        rng.normal(size=(n, 4)).astype(np.float32),
        rng.uniform(0.005, 0.95, n).astype(np.float32),
        (rng.normal(size=(n, 16, 3)) * 0.3).astype(np.float32),
        device=torch.device("cpu"))
    t = {k: torch.as_tensor(np.asarray(getattr(h, k)))
         for k in ("pos", "scale", "quat", "opacity", "sh", "nodes")}
    params = dict(means3d=t["pos"], scales=t["scale"], quats=t["quat"],
                  opacities=t["opacity"].clamp(0, 1), shs=t["sh"])
    table = cut.build_interp_table(params, t["nodes"])
    cam = make_camera(np.eye(3), np.array([0.1, -0.1, 0.0]), 0.9, 0.7, W, H,
                      device=torch.device("cpu"))
    alive = torch.ones(t["nodes"].shape[0], dtype=torch.bool)
    alive[2] = False                   # a dead skybox row where n_sky = 5
    c = cut.expand_to_size_dynamic(
        t["nodes"], t["pos"], torch.max(t["scale"], dim=1).values, alive,
        cam.campos, cam.world_view[:3, 2], 0.02, use_frustum=False)
    return table, c, alive, cam


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_lod_preprocess_matches_plain(case, emulated_lib,
                                               tmp_path):
    """The kernel's source, emulated, against lod_preprocess_plain: valid
    rows to rounding, radius and valid exactly, the rest sanitised."""
    cs = CASES[case]
    table, c, alive, cam = _inputs(cs["n"], cs["deg"])
    big, dil = cs.get("big", float("inf")), cs.get("dilation", 0.3)
    kw = dict(width=W, height=H, sh_degree=cs["deg"], n_skybox=cs["sky"],
              dilation=dil, big_limit=big, antialiasing=cs["aa"])
    ref = lod_preprocess_plain(table, c.render_mask, c.ts, c.kids, alive,
                               cam.world_view, cam.full_proj, cam.campos,
                               cam.tan_fovx, cam.tan_fovy, **kw)
    torch.save(dict(table=table.feats, mask=c.render_mask, ts=c.ts,
                    kids=c.kids, alive=alive, wv=cam.world_view,
                    fp=cam.full_proj, campos=cam.campos,
                    tanx=cam.tan_fovx.reshape(1), tany=float(cam.tan_fovy),
                    n_sky=cs["sky"], w=W, h=H, deg=cs["deg"],
                    dilation=dil, big_limit=big, aa=int(cs["aa"])),
               tmp_path / "in.pt")
    subprocess.run([sys.executable, "-c", RUNNER, str(emulated_lib),
                    str(tmp_path / "in.pt"), str(tmp_path / "out.pt")],
                   check=True, timeout=300)
    got = torch.load(tmp_path / "out.pt")

    valid = ref.valid
    drawn = torch.cat([alive[:cs["sky"]], c.render_mask])
    # the case reaches what it names: rows outside the cut, drawn rows
    # behind the near plane and, with the negative dilation or big_limit,
    # drawn rows in front that the determinant or the scale culls
    assert 0 < int(valid.sum()) < int(drawn.sum()) < drawn.numel()
    means = cut.interpolate_all_masked(table, c.ts, c.render_mask)["means3d"]
    z = means @ cam.world_view[:3, 2] + cam.world_view[3, 2]
    behind = c.render_mask & (z <= 0.2)
    assert int(behind.sum()) > 0
    culled_in_front = c.render_mask & (z > 0.2) & ~valid[cs["sky"]:]
    assert (int(culled_in_front.sum()) > 0) == ("big" in cs
                                                 or "dilation" in cs)
    assert torch.equal(got["valid"].bool(), valid)
    assert torch.equal(got["radius"], ref.radius)
    for k in ("depth", "ext", "reff2"):
        torch.testing.assert_close(got[k][valid], getattr(ref, k)[valid],
                                   rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(got["feats"][valid], ref.feats[valid],
                               rtol=RTOL, atol=ATOL)
    # culled rows: sanitised as project_gaussians does; colour finite, and
    # the plain version's where the row was drawn
    off = ~valid
    sanitised = [0, 1, 2, 3, 4, 5, 9, 10, 11]
    assert torch.equal(got["feats"][off][:, sanitised],
                       ref.feats[off][:, sanitised])
    for k in ("depth", "ext", "reff2"):
        assert torch.equal(got[k][off], getattr(ref, k)[off])
    assert bool(torch.isfinite(got["feats"]).all())
    both = off & drawn
    torch.testing.assert_close(got["feats"][both][:, 6:9],
                               ref.feats[both][:, 6:9], rtol=RTOL,
                               atol=ATOL)
