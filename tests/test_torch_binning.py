"""Port parity: bin_gaussians with circle and tight rects against the JAX
package — per-tile Gaussian lists in order, tile_starts/counts, overflow
and num_candidates, all exact. Both sides bin the same projected inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hlod_gaussians_tpu.ops import binning as jbin
from hlod_gaussians_tpu.ops import gaussian_math as jgm
from hlod_gaussians_tpu.utils.camera import make_camera
from hlod_gaussians_torch.ops import binning as tbin

W, H = 96, 64


def projected(n=150, seed=0, big=False):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)).astype(np.float32) * 1.2
    xyz[:, 2] = 4.0 + rng.uniform(-1, 1, n)
    scales = np.exp(rng.normal(size=(n, 3)) * 0.4
                    - (1.5 if big else 2.5)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    ops = rng.uniform(0.05, 0.99, n).astype(np.float32)
    cam = make_camera(np.eye(3), np.zeros(3), 0.9, 0.7, W, H)
    fx = W / (2 * cam.tan_fovx)
    fy = H / (2 * cam.tan_fovy)
    cov6 = jgm.compute_cov3d(jnp.asarray(scales), jnp.asarray(quats))
    p = jgm.project_gaussians(jnp.asarray(xyz), cov6, jnp.asarray(ops),
                              cam.world_view, cam.full_proj, W, H, fx, fy,
                              cam.tan_fovx, cam.tan_fovy)
    return {k: np.array(getattr(p, k))
            for k in ("xy", "depth", "radius", "valid", "ext", "reff2")}


def both(p, tile_w, tile_h, max_dup, tight):
    extra_j = dict(ext=jnp.asarray(p["ext"]), reff2=jnp.asarray(p["reff2"])) \
        if tight else {}
    extra_t = dict(ext=torch.as_tensor(p["ext"]),
                   reff2=torch.as_tensor(p["reff2"])) if tight else {}
    jb = jbin.bin_gaussians(jnp.asarray(p["xy"]), jnp.asarray(p["depth"]),
                            jnp.asarray(p["radius"]), jnp.asarray(p["valid"]),
                            W, H, tile_w, tile_h, max_dup, **extra_j)
    tb = tbin.bin_gaussians(torch.as_tensor(p["xy"]),
                            torch.as_tensor(p["depth"]),
                            torch.as_tensor(p["radius"]),
                            torch.as_tensor(p["valid"]),
                            W, H, tile_w, tile_h, max_dup, **extra_t)
    return jb, tb


@pytest.mark.parametrize("tight", [False, True], ids=["circle", "tight"])
@pytest.mark.parametrize("tile", [(16, 16), (32, 32), (16, 8)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_bin_gaussians_matches_jax(tight, tile):
    p = projected(big=True)
    jb, tb = both(p, tile[0], tile[1], 4096, tight)
    for k in ("tile_starts", "tile_counts", "num_dup", "num_candidates",
              "overflow"):
        np.testing.assert_array_equal(getattr(tb, k).numpy(),
                                      np.asarray(getattr(jb, k)), err_msg=k)
    nd = int(tb.num_dup)
    assert nd > 100
    # per-tile lists: the kept prefix of the sorted entries, in order
    for k in ("sorted_gid", "sorted_tile", "sorted_gen"):
        np.testing.assert_array_equal(getattr(tb, k).numpy()[:nd],
                                      np.asarray(getattr(jb, k))[:nd],
                                      err_msg=k)
    assert tb.sorted_gid.dtype == torch.int32
    # generation bookkeeping over the Gaussians that emit entries
    cnt = tb.gen_counts.numpy()
    np.testing.assert_array_equal(cnt, np.asarray(jb.gen_counts))
    live = cnt > 0
    np.testing.assert_array_equal(tb.order.numpy()[live],
                                  np.asarray(jb.order)[live])
    np.testing.assert_array_equal(tb.gen_offsets.numpy(),
                                  np.asarray(jb.gen_offsets))
    np.testing.assert_array_equal(tb.gen_valid.numpy(),
                                  np.asarray(jb.gen_valid))
    if tight:
        jc, _ = both(p, tile[0], tile[1], 4096, False)
        assert int(tb.num_dup) < int(jc.num_dup)


def test_overflow_matches_jax():
    p = projected(big=True)
    jb, tb = both(p, 16, 16, 64, tight=True)
    assert bool(tb.overflow) and bool(jb.overflow)
    np.testing.assert_array_equal(tb.num_candidates.numpy(),
                                  np.asarray(jb.num_candidates))
    np.testing.assert_array_equal(tb.tile_counts.numpy(),
                                  np.asarray(jb.tile_counts))
    nd = int(tb.num_dup)
    np.testing.assert_array_equal(tb.sorted_gid.numpy()[:nd],
                                  np.asarray(jb.sorted_gid)[:nd])
