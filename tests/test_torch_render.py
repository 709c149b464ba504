"""Port parity for the flat serving render: render_arrays against the JAX
package's render_arrays (pallas backend in interpret mode, and the xla
scan backend) and against the committed tests/golden_render.npz image; the
model state helpers and the numpy weight hand-over (convert.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hlod_gaussians_tpu import render as jrender
from hlod_gaussians_tpu.config import RasterizerConfig as JConfig
from hlod_gaussians_tpu.models import gaussians as jgm
from hlod_gaussians_torch import convert
from hlod_gaussians_torch import render as trender
from hlod_gaussians_torch.config import RasterizerConfig
from hlod_gaussians_torch.models import gaussians as tgm
from hlod_gaussians_torch.utils.camera import make_camera
from test_golden import CFG, FIXTURE, H, W, scene

CPU = torch.device("cpu")
BG = np.array([0.1, 0.2, 0.3], np.float32)


def _inputs():
    xyz, log_scale, quat, op, shs, cam = scene()
    return dict(xyz=xyz, scale=np.exp(log_scale), quat=quat, op=op, shs=shs)


def _jax_render(a, cfg, **kw):
    _, _, _, _, _, cam = scene()
    return jrender.render_arrays(
        jnp.asarray(a["xyz"]), jnp.asarray(a["scale"]), jnp.asarray(a["quat"]),
        jnp.asarray(a["op"]), jnp.asarray(a["shs"]),
        jnp.ones(len(a["op"]), bool), cam.world_view, cam.full_proj,
        cam.campos, cam.tan_fovx, cam.tan_fovy, jnp.asarray(BG),
        sh_degree=1, width=W, height=H, cfg=cfg, k_max=256, **kw)


def _torch_render(a, cfg, **kw):
    cam = make_camera(np.eye(3), np.zeros(3), 1.0, 0.8, W, H, device=CPU)
    t = lambda x: torch.as_tensor(np.asarray(x))
    with torch.no_grad():
        return trender.render_arrays(
            t(a["xyz"]), t(a["scale"]), t(a["quat"]), t(a["op"]),
            t(a["shs"]), torch.ones(len(a["op"]), dtype=torch.bool),
            cam.world_view, cam.full_proj, cam.campos, cam.tan_fovx,
            cam.tan_fovy, t(BG), sh_degree=1, width=W, height=H, cfg=cfg,
            k_max=256, **kw)


def _assert_render_same(got, ref):
    for k in ("image", "invdepth", "final_t"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(ref, k)), atol=2e-5,
                                   err_msg=k)
    for k in ("n_contrib", "seen", "radii", "visible", "truncated", "n_dup"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(ref, k)), err_msg=k)


def test_render_arrays_pallas_matches_jax_and_golden():
    a = _inputs()
    cfg = RasterizerConfig(backend="pallas", tile_w=16, tile_h=16,
                           max_dup=16384, tight_binning=True)
    got = _torch_render(a, cfg, want_seen=True)
    _assert_render_same(got, _jax_render(a, CFG, want_seen=True))
    assert not bool(got.truncated) and got.seen.any()
    golden = np.load(FIXTURE)["image"]
    np.testing.assert_allclose(got.image.numpy(), golden, atol=1e-5)


def test_render_arrays_xla_backend_matches_jax():
    a = _inputs()
    off = np.random.default_rng(1).normal(size=(len(a["op"]), 2)).astype(
        np.float32) * 0.3
    got = _torch_render(a, RasterizerConfig(backend="xla", tile_w=16,
                                            tile_h=8, max_dup=16384),
                        xy_offset=torch.as_tensor(off))
    ref = _jax_render(a, JConfig(backend="xla", tile_w=16, tile_h=8,
                                 max_dup=16384), xy_offset=jnp.asarray(off))
    _assert_render_same(got, ref)


def test_render_arrays_pallas_raises_under_grad():
    """A pallas-backend render made with RasterizerConfig.inference raises
    when differentiated; the same render with a training config does not."""
    a = _inputs()
    cam = make_camera(np.eye(3), np.zeros(3), 1.0, 0.8, W, H, device=CPU)
    xyz = torch.as_tensor(a["xyz"]).requires_grad_(True)

    def render(inference):
        return trender.render_arrays(
            xyz, torch.as_tensor(a["scale"]), torch.as_tensor(a["quat"]),
            torch.as_tensor(a["op"]), torch.as_tensor(a["shs"]),
            torch.ones(len(a["op"]), dtype=torch.bool), cam.world_view,
            cam.full_proj, cam.campos, cam.tan_fovx, cam.tan_fovy,
            torch.as_tensor(BG), sh_degree=1, width=W, height=H,
            cfg=RasterizerConfig(backend="pallas", tile_w=16, tile_h=16,
                                 inference=inference))

    with pytest.raises(RuntimeError, match="inference"):
        render(True).image.mean().backward()
    render(False).image.mean().backward()
    assert torch.isfinite(xyz.grad).all() and bool((xyz.grad != 0).any())


def test_apply_exposure_and_tau_match_jax():
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1, (3, 8, 6)).astype(np.float32)
    exp = rng.normal(size=(3, 4)).astype(np.float32)
    np.testing.assert_allclose(
        trender.apply_exposure(torch.as_tensor(img),
                               torch.as_tensor(exp)).numpy(),
        np.asarray(jrender.apply_exposure(jnp.asarray(img),
                                          jnp.asarray(exp))), atol=1e-6)
    tan = np.float32(0.47)
    for tau in (0.0, 3.0, 15.0):
        np.testing.assert_allclose(
            float(trender.tau_to_threshold(tau, torch.tensor(tan), 1920)),
            float(jrender.tau_to_threshold(tau, jnp.float32(tan), 1920)),
            rtol=1e-7)


def _points(n=300, seed=4):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    pts[:, 2] += 4.0
    return pts, rng.uniform(0, 1, (n, 3)).astype(np.float32)


def test_state_from_numpy_round_trips_jax_state():
    pts, cols = _points()
    js = jgm.create_from_points(pts, cols, capacity=400, sh_degree=2,
                                skybox_num=16, opacity_init=0.3)
    arrays = {k: np.asarray(getattr(js, k)) for k in
              ("xyz", "f_dc", "f_rest", "log_scale", "quat", "opacity_logit",
               "exposure", "alive", "nodes")}
    ts = convert.state_from_numpy(arrays, n_skybox=js.n_skybox, device=CPU)
    assert ts.n_skybox == 16 and ts.capacity == 400 and ts.sh_degree == 2
    for k, v in arrays.items():
        back = getattr(ts, k).numpy()
        assert back.dtype == v.dtype, k
        np.testing.assert_array_equal(back, v, err_msg=k)
    with pytest.raises(ValueError, match="nodes"):
        convert.state_from_numpy({k: v for k, v in arrays.items()
                                  if k != "nodes"}, n_skybox=16, device=CPU)
    ja, ta = jgm.activate(js), tgm.activate(ts)
    for k in ja._fields:
        np.testing.assert_allclose(getattr(ta, k).numpy(),
                                   np.asarray(getattr(ja, k)), atol=1e-6,
                                   err_msg=k)


def test_create_from_points_matches_jax():
    pts, cols = _points()
    js = jgm.create_from_points(pts, cols, capacity=400, sh_degree=3,
                                skybox_num=16, scene_radius=2.0,
                                scale_clip_max=0.5)
    ts = tgm.create_from_points(pts, cols, capacity=400, sh_degree=3,
                                skybox_num=16, scene_radius=2.0,
                                scale_clip_max=0.5, device=CPU)
    for k in ("xyz", "f_dc", "f_rest", "quat", "opacity_logit", "exposure",
              "alive", "nodes"):
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)), err_msg=k)
    np.testing.assert_allclose(ts.log_scale.numpy(), np.asarray(js.log_scale),
                               atol=1e-5)
    empty = tgm.empty_state(8, 1, n_exposures=2, device=CPU)
    jempty = jgm.empty_state(8, 1, n_exposures=2)
    for k in ("quat", "exposure", "log_scale", "nodes", "alive"):
        np.testing.assert_array_equal(getattr(empty, k).numpy(),
                                      np.asarray(getattr(jempty, k)))
