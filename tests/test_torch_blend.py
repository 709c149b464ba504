"""Port parity for kernel B1's plain version and the blend glue:
`blend_forward_plain` (via `rasterize_scan` and via `rasterize_tiles`, whose
wrapper runs it on CPU tensors) against the JAX scan and against the Pallas
`blend_forward` in interpret mode — LOD on and off, `seen`, the sticky
early stop across entry batches, 16x16 and 32x32 tiles. Images, inverse
depth and final T to atol 2e-5 (test_rasterize_pallas.py:81); n_contrib and
seen exactly. tests/test_torch_cuda.py holds the CUDA kernel itself to the
plain version on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hlod_gaussians_tpu.ops import gaussian_math as jgm
from hlod_gaussians_tpu.ops.binning import bin_gaussians as jbin_gaussians
from hlod_gaussians_tpu.ops.rasterize import rasterize_pallas_full
from hlod_gaussians_tpu.ops.rasterize_xla import rasterize_scan as jscan
from hlod_gaussians_tpu.utils.camera import make_camera
from hlod_gaussians_torch.ops import rasterize_cuda
from hlod_gaussians_torch.ops.binning import bin_gaussians
from hlod_gaussians_torch.ops.rasterize import rasterize_tiles
from hlod_gaussians_torch.ops.rasterize_xla import (blend_features,
                                                    rasterize_scan)

W, H = 64, 48
MAX_DUP = 4096
ATOL = 2e-5


def scene(n=80, seed=0, big=False, lod=False, stacked=False):
    """Projected Gaussians (JAX projection, numpy out) + colors + LOD."""
    rng = np.random.default_rng(seed)
    if stacked:
        # n Gaussians stacked on the same pixels at distinct depths; alpha
        # ~0.035 each, so T crosses t_eps after ~260 entries — past the first
        # batch of 128 and 256 entries — with ~n-260 entries behind it
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
        quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
        ops = rng.uniform(0.2, 0.95, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    cam = make_camera(np.eye(3), np.zeros(3), 0.9, 0.7, W, H)
    cov6 = jgm.compute_cov3d(jnp.asarray(scales), jnp.asarray(quats))
    p = jgm.project_gaussians(jnp.asarray(xyz), cov6, jnp.asarray(ops),
                              cam.world_view, cam.full_proj, W, H,
                              W / (2 * cam.tan_fovx), H / (2 * cam.tan_fovy),
                              cam.tan_fovx, cam.tan_fovy)
    s = {k: np.array(getattr(p, k))
         for k in ("xy", "depth", "radius", "valid", "conic", "opacity")}
    s["color"] = colors
    s["invd"] = (1.0 / np.maximum(s["depth"], 1e-6)).astype(np.float32)
    s["bg"] = np.array([0.3, 0.2, 0.1], np.float32)
    if lod:
        s["ts"] = rng.uniform(0, 1, n).astype(np.float32)
        s["kids"] = rng.integers(0, 4, n).astype(np.int32)  # 0: leaf guard
    return s


def jax_args(s):
    return ([jnp.asarray(s[k]) for k in ("xy", "conic", "opacity", "color",
                                         "invd", "bg")],
            [jnp.asarray(s[k]) if k in s else None for k in ("ts", "kids")])


def torch_bins(s, tile_w, tile_h):
    return bin_gaussians(*(torch.as_tensor(s[k]) for k in
                           ("xy", "depth", "radius", "valid")),
                         W, H, tile_w, tile_h, MAX_DUP)


def torch_args(s):
    return ([torch.as_tensor(s[k]) for k in ("xy", "conic", "opacity",
                                             "color", "invd", "bg")],
            [torch.as_tensor(s[k]) if k in s else None
             for k in ("ts", "kids")])


def assert_same(got, ref, seen=True):
    for k in ("image", "invdepth", "final_t"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(ref, k)), atol=ATOL,
                                   err_msg=k)
    np.testing.assert_array_equal(got.n_contrib.numpy(),
                                  np.asarray(ref.n_contrib))
    if seen:
        np.testing.assert_array_equal(got.seen.numpy(), np.asarray(ref.seen))


CASES = {
    "16x16": dict(tile=(16, 16), scene=dict(n=120, seed=5)),
    "32x32-lod": dict(tile=(32, 32), scene=dict(n=96, seed=7, lod=True)),
    "16x16-dense": dict(tile=(16, 16), scene=dict(n=400, seed=3, big=True)),
    "16x8-sticky": dict(tile=(16, 8), scene=dict(n=600, seed=7,
                                                 stacked=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_blend_matches_jax_scan(case):
    c = CASES[case]
    tw, th = c["tile"]
    s = scene(**c["scene"])
    (jxy, jcon, jop, jcol, jinv, jbg), (jts, jkids) = jax_args(s)
    jb = jbin_gaussians(jxy, jnp.asarray(s["depth"]), jnp.asarray(s["radius"]),
                        jnp.asarray(s["valid"]), W, H, tw, th, MAX_DUP)
    ref = jscan(jb, jxy, jcon, jop, jcol, jinv, jbg, jts, jkids, width=W,
                height=H, tile_w=tw, tile_h=th, k_max=1024)
    (xy, con, op, col, inv, bg), (ts, kids) = torch_args(s)
    got = rasterize_scan(torch_bins(s, tw, th),
                         blend_features(xy, con, op, col, inv, ts, kids), bg,
                         width=W, height=H, tile_w=tw, tile_h=th, k_max=1024,
                         use_lod=ts is not None)
    assert_same(got, ref)
    assert not bool(got.truncated)
    # saturated pixel: T stopped within one entry of t_eps
    sat = int(got.final_t.argmin())
    if case == "16x16-dense":
        assert int(got.n_contrib.max()) > 100
        assert float(got.final_t.min()) < 2e-4
    if case == "16x8-sticky":
        # the stop lies past two 128-entry batches and before the list ends
        assert float(got.final_t.min()) < 2e-4
        assert 256 < int(got.n_contrib.flatten()[sat]) < 600


def test_scan_truncation_flag():
    s = scene(n=200, seed=3, big=True)
    (xy, con, op, col, inv, bg), _ = torch_args(s)
    bins = torch_bins(s, 16, 16)
    k_max = int(bins.tile_counts.max()) - 1
    out = rasterize_scan(bins, blend_features(xy, con, op, col, inv), bg,
                         width=W, height=H, tile_w=16, tile_h=16, k_max=k_max)
    assert bool(out.truncated) == (int(bins.tile_counts.max()) >
                                   -(-k_max // 32) * 32)


@pytest.mark.parametrize("case", ["16x16", "32x32-lod", "16x8-sticky"])
def test_kernel_path_on_cpu_matches_pallas_interpret(case):
    """rasterize_tiles -> rasterize_cuda.blend_forward (plain version on CPU
    tensors) against the JAX Pallas path, binned the same way."""
    c = CASES[case]
    tw, th = c["tile"]
    s = scene(**c["scene"])
    (jxy, jcon, jop, jcol, jinv, jbg), (jts, jkids) = jax_args(s)
    ref = rasterize_pallas_full(
        jxy, jnp.asarray(s["depth"]), jnp.asarray(s["radius"]),
        jnp.asarray(s["valid"]), jcon, jop, jcol, jinv, jbg, jts, jkids,
        width=W, height=H, tile_w=tw, tile_h=th, max_dup=MAX_DUP,
        want_seen=True, interpret=True)
    (xy, con, op, col, inv, bg), (ts, kids) = torch_args(s)
    launches = rasterize_cuda.blend_forward.launches
    got = rasterize_tiles(torch_bins(s, tw, th),
                          blend_features(xy, con, op, col, inv, ts, kids), bg,
                          width=W, height=H, tile_w=tw, tile_h=th,
                          use_lod=ts is not None, want_seen=True)
    assert rasterize_cuda.blend_forward.launches == launches   # no kernel
    assert_same(got, ref)
    assert got.seen.any()


def test_kernel_path_is_differentiable_and_inference_raises():
    """The kernel path differentiates through its autograd Function; a
    render made with inference=True raises on backward (as the JAX package
    does for a render binned without gradient bookkeeping)."""
    s = scene(n=40, seed=1)
    (xy, con, op, col, inv, bg), _ = torch_args(s)
    bins = torch_bins(s, 16, 16)
    op.requires_grad_(True)

    def feats():
        return blend_features(xy, con, op, col, inv)

    out = rasterize_tiles(bins, feats(), bg, width=W, height=H, tile_w=16,
                          tile_h=16)
    out.image.sum().backward()
    assert torch.isfinite(op.grad).all() and bool((op.grad != 0).any())
    out = rasterize_tiles(bins, feats(), bg, width=W, height=H, tile_w=16,
                          tile_h=16, inference=True)
    with pytest.raises(RuntimeError, match="inference"):
        out.image.sum().backward()
    with torch.no_grad():
        out = rasterize_tiles(bins, feats(), bg, width=W, height=H,
                              tile_w=16, tile_h=16, inference=True)
    assert torch.isfinite(out.image).all()
