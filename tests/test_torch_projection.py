"""Port parity: camera matrices, compute_cov3d, project_gaussians and
sh_color against the JAX package on CPU (atol 1e-5) and against the numpy
transcription of forward.cu in test_projection_oracle.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hlod_gaussians_tpu.ops import gaussian_math as jgm
from hlod_gaussians_tpu.ops import quaternion as jq
from hlod_gaussians_tpu.ops import sh as jsh
from hlod_gaussians_tpu.utils import camera as jcam
from hlod_gaussians_torch.ops import gaussian_math as tgm
from hlod_gaussians_torch.ops import quaternion as tq
from hlod_gaussians_torch.ops import sh as tsh
from hlod_gaussians_torch.utils import camera as tcam
from test_projection_oracle import (H_IMG, W_IMG, oracle_preprocess,
                                    oracle_sh_color, scene)

CPU = torch.device("cpu")


def t(a):
    return torch.as_tensor(np.asarray(a))


def _cams():
    ang = 0.2
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]])
    args = (R, np.array([0.1, -0.2, 0.3]), 0.9, 0.7, W_IMG, H_IMG)
    return jcam.make_camera(*args), tcam.make_camera(*args, device=CPU)


def test_camera_matches_jax():
    jc, tc = _cams()
    assert (tc.width, tc.height) == (jc.width, jc.height)
    for k in ("world_view", "full_proj", "campos", "tan_fovx", "tan_fovy"):
        np.testing.assert_array_equal(getattr(tc, k).numpy(),
                                      np.asarray(getattr(jc, k)), err_msg=k)
    assert getattr(tc, "world_view").dtype == torch.float32


@pytest.mark.parametrize("antialiasing", [False, True])
def test_project_gaussians_matches_jax_and_oracle(antialiasing):
    pts, scales, quats, ops, cam = scene()
    _, tc = _cams()
    fx = W_IMG / (2 * cam.tan_fovx)
    fy = H_IMG / (2 * cam.tan_fovy)

    cov_j = jgm.compute_cov3d(jnp.asarray(scales), jnp.asarray(quats))
    cov_t = tgm.compute_cov3d(t(scales), t(quats))
    np.testing.assert_allclose(cov_t.numpy(), np.asarray(cov_j), atol=1e-5)

    pj = jgm.project_gaussians(
        jnp.asarray(pts), cov_j, jnp.asarray(ops), cam.world_view,
        cam.full_proj, W_IMG, H_IMG, fx, fy, cam.tan_fovx, cam.tan_fovy,
        antialiasing=antialiasing)
    pt = tgm.project_gaussians(
        t(pts), cov_t, t(ops), tc.world_view, tc.full_proj, W_IMG, H_IMG,
        tc.focal_x, tc.focal_y, tc.tan_fovx, tc.tan_fovy,
        antialiasing=antialiasing)
    for k in ("valid", "radius"):
        np.testing.assert_array_equal(getattr(pt, k).numpy(),
                                      np.asarray(getattr(pj, k)), err_msg=k)
    for k in ("xy", "depth", "conic", "opacity", "ext", "reff2"):
        a, b = getattr(pt, k).numpy(), np.asarray(getattr(pj, k))
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5, err_msg=k)
    assert pt.radius.dtype == torch.int32

    ora = oracle_preprocess(pts, scales, quats, ops, cam, fx, fy,
                            antialiasing=antialiasing)
    v = pt.valid.numpy()
    np.testing.assert_array_equal(v, ora["valid"])
    assert v.sum() > 30 and (~v).sum() > 3
    np.testing.assert_allclose(pt.xy.numpy()[v], ora["xy"][v], rtol=1e-4,
                               atol=2e-3)
    np.testing.assert_allclose(pt.conic.numpy()[v], ora["conic"][v],
                               rtol=2e-4, atol=1e-6)
    np.testing.assert_array_equal(pt.radius.numpy()[v],
                                  ora["radius"][v].astype(np.int32))
    np.testing.assert_allclose(pt.opacity.numpy()[v], ora["opacity"][v],
                               rtol=1e-5)
    # culled rows are sanitized exactly as in the JAX package
    np.testing.assert_array_equal(pt.conic.numpy()[~v],
                                  np.tile([1.0, 0.0, 1.0], ((~v).sum(), 1)))


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_sh_color_matches_jax_and_oracle(deg):
    rng = np.random.default_rng(3)
    n = 40
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    pts[:, 2] += 4.0
    shs = rng.normal(size=(n, 16, 3)).astype(np.float32) * 0.4
    campos = np.array([0.2, -0.1, 0.0], np.float32)
    got = tsh.sh_color(deg, t(shs), t(pts), t(campos)).numpy()
    ref = np.asarray(jsh.sh_color(deg, jnp.asarray(shs), jnp.asarray(pts),
                                  jnp.asarray(campos)))
    np.testing.assert_allclose(got, ref, atol=1e-5)
    want = np.stack([oracle_sh_color(deg, shs[i].astype(np.float64),
                                     pts[i].astype(np.float64),
                                     campos.astype(np.float64))
                     for i in range(n)])
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


def test_quaternion_ops_match_jax():
    rng = np.random.default_rng(6)
    a = rng.normal(size=(64, 4)).astype(np.float32)
    b = rng.normal(size=(64, 4)).astype(np.float32)
    np.testing.assert_allclose(tq.normalize(t(a)).numpy(),
                               np.asarray(jq.normalize(jnp.asarray(a))),
                               atol=1e-6)
    qa = np.asarray(jq.normalize(jnp.asarray(a)))
    m_t = tq.to_matrix(t(qa))
    np.testing.assert_allclose(m_t.numpy(),
                               np.asarray(jq.to_matrix(jnp.asarray(qa))),
                               atol=1e-6)
    np.testing.assert_allclose(
        tq.from_matrix(m_t).numpy(),
        np.asarray(jq.from_matrix(jnp.asarray(m_t.numpy()))), atol=1e-6)
    np.testing.assert_allclose(
        tq.multiply(t(a), t(b)).numpy(),
        np.asarray(jq.multiply(jnp.asarray(a), jnp.asarray(b))), atol=1e-5)
    # from_matrix inverts to_matrix up to the sign (w >= 0)
    back = tq.from_matrix(m_t).numpy()
    np.testing.assert_allclose(np.abs((back * qa).sum(-1)), 1.0, atol=1e-5)
