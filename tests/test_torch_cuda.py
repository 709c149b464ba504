"""The CUDA blend kernel (kernel B1) against its plain PyTorch version on the
card. Every test here is marked `cuda` and skips without a GPU: a CUDA
kernel has no CPU mode. This file imports neither JAX nor the JAX package,
so it runs where only PyTorch is installed:

    PYTHONPATH=. python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from hlod_gaussians_torch.ops import gaussian_math, rasterize_cuda
from hlod_gaussians_torch.ops.binning import bin_gaussians
from hlod_gaussians_torch.ops.rasterize_xla import (blend_features,
                                                    blend_forward_plain)
from hlod_gaussians_torch.utils.camera import make_camera

W, H = 96, 64
ATOL = 2e-5

CASES = {
    "16x16": dict(tile=(16, 16), n=300, seed=5),
    "32x32-lod": dict(tile=(32, 32), n=300, seed=7, lod=True),
    "8x128-lod": dict(tile=(8, 128), n=300, seed=9, lod=True),
    "16x16-dense": dict(tile=(16, 16), n=800, seed=3, big=True),
    "16x8-sticky": dict(tile=(16, 8), n=600, seed=7, stacked=True),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(dev, tile, n, seed, big=False, lod=False, stacked=False):
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
        scales = np.exp(rng.normal(size=(n, 3)) * 0.4
                        - (1.5 if big else 2.5)).astype(np.float32)
        quats = rng.normal(size=(n, 4)).astype(np.float32)
        ops = rng.uniform(0.2, 0.95, n).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=dev)
    cam = make_camera(np.eye(3), np.zeros(3), 0.9, 0.7, W, H, device=dev)
    p = gaussian_math.project_gaussians(
        t(xyz), gaussian_math.compute_cov3d(t(scales), t(quats)), t(ops),
        cam.world_view, cam.full_proj, W, H, cam.focal_x, cam.focal_y,
        cam.tan_fovx, cam.tan_fovy)
    ts = t(rng.uniform(0, 1, n).astype(np.float32)) if lod else None
    kids = t(rng.integers(0, 4, n).astype(np.int32)) if lod else None
    bins = bin_gaussians(p.xy, p.depth, p.radius, p.valid, W, H, *tile,
                         1 << 16, ext=p.ext, reff2=p.reff2)
    feats = blend_features(p.xy, p.conic, p.opacity,
                           t(rng.uniform(0, 1, (n, 3)).astype(np.float32)),
                           1.0 / torch.clamp_min(p.depth, 1e-6), ts, kids)
    return (feats, bins.sorted_gid, bins.tile_starts, bins.tile_counts), \
        dict(width=W, height=H, tile_w=tile[0], tile_h=tile[1],
             use_lod=lod)


@pytest.mark.cuda
@pytest.mark.parametrize("want_seen", [True, False], ids=["seen", "noseen"])
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_kernel_matches_plain(case, want_seen, cuda_device):
    c = dict(CASES[case])
    args, kw = _inputs(cuda_device, **c)
    kw["want_seen"] = want_seen
    launches = rasterize_cuda.blend_forward.launches
    got = rasterize_cuda.blend_forward(*args, **kw)
    torch.cuda.synchronize()
    assert rasterize_cuda.blend_forward.launches == launches + 1
    ref = blend_forward_plain(*args, **kw)
    torch.testing.assert_close(got[0], ref[0], atol=ATOL, rtol=0)
    torch.testing.assert_close(got[1], ref[1], atol=ATOL, rtol=0)
    assert torch.equal(got[2], ref[2])
    if want_seen:
        assert torch.equal(got[3], ref[3]) and bool(got[3].any())
    else:
        assert got[3] is None


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_inputs(cuda_device):
    args, kw = _inputs(cuda_device, (16, 16), 50, 1)
    feats, gid, starts, counts = args
    with pytest.raises(ValueError, match="float32"):
        rasterize_cuda.blend_forward(feats.double(), gid, starts, counts,
                                     **kw)
    with pytest.raises(ValueError, match="contiguous"):
        rasterize_cuda.blend_forward(feats.t().contiguous().t(), gid, starts,
                                     counts, **kw)
    with pytest.raises(ValueError, match="tile_starts"):
        rasterize_cuda.blend_forward(feats, gid, starts[:-1], counts, **kw)
    with pytest.raises(ValueError, match="1024"):
        rasterize_cuda.blend_forward(feats, gid, starts, counts,
                                     **dict(kw, tile_w=64, tile_h=32))
