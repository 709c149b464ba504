"""Port parity for the blend backward: kernel B2's plain version
(`blend_backward_plain`, reached through `rasterize_tiles`, whose autograd
Function runs it on CPU tensors) and the per-Gaussian gradient reduction
(`gaussian_grads`) against the JAX Pallas backward in interpret mode and
against torch autograd through `blend_forward_plain`; the differentiable
`render_arrays` (pallas backend) against tests/golden_render.npz.

Tolerances: per-Gaussian gradients to atol 3e-4 after scaling by the
largest reference magnitude (test_rasterize_pallas.py:145-148); the golden
image to atol 1e-5 and its gradients to scaled 1e-4 (test_golden.py:71-76).
tests/test_torch_cuda.py holds the CUDA kernel B2 to the plain version on
the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hlod_gaussians_tpu.ops.rasterize import rasterize_pallas_full
from hlod_gaussians_torch import render as trender
from hlod_gaussians_torch.config import RasterizerConfig
from hlod_gaussians_torch.ops import rasterize_cuda
from hlod_gaussians_torch.ops.rasterize import gaussian_grads, rasterize_tiles
from hlod_gaussians_torch.ops.rasterize_xla import (blend_backward_plain,
                                                    blend_features,
                                                    blend_forward_plain)
from hlod_gaussians_torch.utils.camera import make_camera
from test_golden import FIXTURE, scene as golden_scene
from test_torch_blend import H, MAX_DUP, W, jax_args, scene, torch_args, \
    torch_bins

GRAD_ATOL = 3e-4
W_G, H_G = 96, 64      # the golden scene's image (test_golden.py:24)
NAMES = ("xy", "conic", "opacity", "color", "invdepth")



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are tiny: PyTorch's intra-op threads only contend with
    the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

CASES = {
    # LOD off, the production 16x8 tile of the JAX tests
    "16x8": dict(tile=(16, 8), scene=dict(n=80, seed=0)),
    "16x16-lod": dict(tile=(16, 16), scene=dict(n=96, seed=7, lod=True)),
    # heavy overlap: saturated pixels stop within one entry of t_eps
    "32x32-saturated": dict(tile=(32, 32), scene=dict(n=400, seed=3,
                                                      big=True)),
    # 300 stacked Gaussians: the sticky stop lies past 256 entries
    "16x8-sticky": dict(tile=(16, 8), scene=dict(n=300, seed=7,
                                                 stacked=True)),
}


def _target(seed=9):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (3, H, W)).astype(np.float32)


def _loss(out, tgt):
    """Image, inverse depth and final T all carry cotangents (as
    test_rasterize_pallas.py:129-130)."""
    return (abs(out.image - tgt).mean() + 0.1 * out.invdepth.mean()
            + 0.05 * out.final_t.mean())


def _assert_grads_close(got, ref, names=NAMES):
    for name, g, r in zip(names, got, ref):
        r = np.asarray(r)
        scale = np.abs(r).max() + 1e-12
        np.testing.assert_allclose(np.asarray(g) / scale, r / scale,
                                   atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_pallas_interpret(case):
    c = CASES[case]
    tw, th = c["tile"]
    s = scene(**c["scene"])
    tgt = _target()
    (jxy, jcon, jop, jcol, jinv, jbg), (jts, jkids) = jax_args(s)

    def jloss(xy, conic, op, col, invd):
        out = rasterize_pallas_full(
            xy, jnp.asarray(s["depth"]), jnp.asarray(s["radius"]),
            jnp.asarray(s["valid"]), conic, op, col, invd, jbg, jts, jkids,
            width=W, height=H, tile_w=tw, tile_h=th, max_dup=MAX_DUP,
            interpret=True)
        return _loss(out, jnp.asarray(tgt)), out.final_t

    (_, ft_ref), g_ref = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3, 4), has_aux=True)(jxy, jcon, jop, jcol,
                                                      jinv)

    (xy, con, op, col, inv, bg), (ts, kids) = torch_args(s)
    leaves = [t.requires_grad_(True) for t in (xy, con, op, col, inv)]
    before = rasterize_cuda.blend_backward.launches
    out = rasterize_tiles(torch_bins(s, tw, th),
                          blend_features(*leaves, ts, kids), bg, width=W,
                          height=H, tile_w=tw, tile_h=th,
                          use_lod=ts is not None)
    _loss(out, torch.as_tensor(tgt)).backward()
    assert rasterize_cuda.blend_backward.launches == before   # no kernel
    final_t = out.final_t.detach()
    _assert_grads_close([t.grad.numpy() for t in leaves], g_ref)
    assert np.abs(leaves[4].grad.numpy()).max() > 0     # inverse depth
    if case == "32x32-saturated":
        assert float(final_t.min()) < 2e-4
        assert int(out.n_contrib.max()) > 100
    if case == "16x8-sticky":
        sat = int(final_t.argmin())
        assert float(final_t.min()) < 2e-4
        assert 256 < int(out.n_contrib.flatten()[sat]) < 300
    np.testing.assert_allclose(final_t.numpy(), np.asarray(ft_ref),
                               atol=2e-5)


@pytest.mark.parametrize("case", ["16x8", "16x16-lod", "32x32-saturated"])
def test_plain_backward_matches_autograd(case):
    """blend_backward_plain + gaussian_grads against torch autograd through
    blend_forward_plain, on random cotangents of img4 and final_t."""
    c = CASES[case]
    tw, th = c["tile"]
    s = scene(**c["scene"])
    (xy, con, op, col, inv, _), (ts, kids) = torch_args(s)
    bins = torch_bins(s, tw, th)
    feats = blend_features(xy, con, op, col, inv, ts, kids).requires_grad_()
    opts = dict(width=W, height=H, tile_w=tw, tile_h=th,
                use_lod=ts is not None)
    img4, final_t, n_contrib, _ = blend_forward_plain(
        feats, bins.sorted_gid, bins.tile_starts, bins.tile_counts, **opts)
    rng = np.random.default_rng(11)
    g_img4 = torch.as_tensor(rng.normal(size=(4, H, W)).astype(np.float32))
    g_ft = torch.as_tensor(rng.normal(size=(H, W)).astype(np.float32))
    (ref,) = torch.autograd.grad((img4 * g_img4).sum() + (final_t * g_ft).sum(),
                                 feats)
    egrads = blend_backward_plain(
        feats.detach(), bins.sorted_gid, bins.tile_starts, bins.tile_counts,
        final_t.detach(), n_contrib, g_img4, g_ft, **opts)
    got = gaussian_grads(egrads, bins, feats.shape[0])
    assert got.shape == feats.shape
    np.testing.assert_array_equal(got[:, 10:].numpy(), 0.0)   # t, 1/kids
    scale = ref[:, :10].abs().max(dim=0).values + 1e-12
    np.testing.assert_allclose((got[:, :10] / scale).numpy(),
                               (ref[:, :10] / scale).numpy(), atol=GRAD_ATOL)


def _golden_render(xyz, log_scale, quat, shs, op, cam, cfg, valid=None):
    return trender.render_arrays(
        xyz, torch.exp(log_scale), quat, op, shs,
        torch.ones(len(op), dtype=torch.bool) if valid is None else valid,
        cam.world_view, cam.full_proj, cam.campos, cam.tan_fovx,
        cam.tan_fovy, torch.tensor([0.1, 0.2, 0.3]), sh_degree=1,
        width=cam.width, height=cam.height, cfg=cfg, k_max=256)


GOLDEN_CFG = RasterizerConfig(backend="pallas", tile_w=16, tile_h=16,
                              max_dup=16384, tight_binning=True)


def test_render_arrays_grads_match_golden():
    """The golden scene's image and its gradients w.r.t. xyz, log-scales,
    quaternions and SH through the port's kernel path (test_golden.py)."""
    xyz, log_scale, quat, op, shs, _ = golden_scene()
    cam = make_camera(np.eye(3), np.zeros(3), 1.0, 0.8, W_G, H_G,
                      device=torch.device("cpu"))
    leaves = [torch.as_tensor(a).requires_grad_(True)
              for a in (xyz, log_scale, quat, shs)]
    out = _golden_render(*leaves, torch.as_tensor(op), cam, GOLDEN_CFG)
    torch.abs(out.image).mean().backward()
    ref = np.load(FIXTURE)
    np.testing.assert_allclose(out.image.detach().numpy(), ref["image"],
                               atol=1e-5)
    for k, leaf in zip(("g_xyz", "g_log_scale", "g_quat", "g_shs"), leaves):
        scale = np.abs(ref[k]).max() + 1e-12
        np.testing.assert_allclose(leaf.grad.numpy() / scale, ref[k] / scale,
                                   atol=1e-4, err_msg=k)


def test_render_arrays_grads_finite_with_culled_rows():
    """Rows culled behind or inside the near plane or masked out by
    `valid`, and rows projected far off screen (visible but in no tile),
    get exactly zero gradients, and the live rows' stay finite
    (docs/KERNEL_DESIGN.md:84-86)."""
    xyz, log_scale, quat, op, shs, _ = golden_scene()
    xyz = xyz.copy()
    xyz[:10, 2] = -xyz[:10, 2]            # behind the camera
    xyz[10:15, 2] = 0.05                  # inside the near plane
    xyz[15:20, 0] += 50.0                 # far off screen
    valid = torch.ones(len(op), dtype=torch.bool)
    valid[20:25] = False                  # dead rows
    cam = make_camera(np.eye(3), np.zeros(3), 1.0, 0.8, W_G, H_G,
                      device=torch.device("cpu"))
    leaves = [torch.as_tensor(a).requires_grad_(True)
              for a in (xyz, log_scale, quat, shs)]
    opac = torch.as_tensor(op).requires_grad_(True)
    out = _golden_render(*leaves, opac, cam, GOLDEN_CFG, valid=valid)
    (out.image.mean() + out.invdepth.mean()).backward()
    culled = torch.zeros(len(op), dtype=torch.bool)
    culled[:15] = culled[20:25] = True
    assert not bool(out.visible[culled].any())
    assert bool(out.visible[15:20].all())
    for leaf in leaves + [opac]:
        g = leaf.grad
        assert torch.isfinite(g).all()
        assert (g[:25] == 0).all()
        assert (g[25:] != 0).any()
