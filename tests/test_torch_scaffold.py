"""Port parity for the creators deferred from the training slice:
`create_from_gaussian_ply` (a saved 3DGS PLY adopted verbatim),
`select_scaffold_ring` and `create_with_scaffold` (a chunk state
conditioned on a trained scaffold), against the JAX package on
tests/test_scaffold.py's scaffold, including `max_scaffold_rows` and a
degree-3 scaffold into a degree-1 chunk.

Tolerances: every field exact but the chunk points' kNN log-scales, which
are held to atol 1e-5 as in tests/test_torch_render.py (the two packages
sum the squared distances in different orders)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hlod_gaussians_tpu.data import ply as jply
from hlod_gaussians_tpu.models import gaussians as jgm
from hlod_gaussians_torch import convert
from hlod_gaussians_torch.data import ply
from hlod_gaussians_torch.models import gaussians as gm
from tests.test_torch_mcmc import leaves

CPU = torch.device("cpu")
FIELDS = ("xyz", "f_dc", "f_rest", "log_scale", "quat", "opacity_logit",
          "exposure", "alive", "nodes")


def assert_state_equal(ts, js, knn_rows=slice(0, 0)):
    """Every field of the port's state equal to the JAX state's, the
    log-scales of `knn_rows` (kNN-initialized) to atol 1e-5."""
    assert (ts.capacity, ts.sh_degree, ts.n_skybox, ts.n_scaffold) == \
        (js.capacity, js.sh_degree, js.n_skybox, js.n_scaffold)
    for k in FIELDS:
        got, ref = getattr(ts, k).numpy(), np.asarray(getattr(js, k))
        if k == "log_scale":
            np.testing.assert_allclose(got[knn_rows], ref[knn_rows],
                                       atol=1e-5)
            got, ref = got.copy(), ref.copy()
            got[knn_rows] = ref[knn_rows] = 0
        np.testing.assert_array_equal(got, ref, err_msg=k)


@pytest.mark.parametrize("k_rest", [0, 3, 15], ids=["sh0", "sh1", "sh3"])
def test_create_from_gaussian_ply_matches_jax(tmp_path, k_rest):
    rng = np.random.default_rng(k_rest)
    n = 20
    g = jply.GaussianPly(
        xyz=rng.normal(size=(n, 3)).astype(np.float32),
        f_dc=rng.normal(size=(n, 1, 3)).astype(np.float32),
        f_rest=rng.normal(size=(n, k_rest, 3)).astype(np.float32),
        opacity=rng.normal(size=(n,)).astype(np.float32),
        log_scale=rng.normal(size=(n, 3)).astype(np.float32),
        quat=rng.normal(size=(n, 4)).astype(np.float32) * 3)
    path = str(tmp_path / "g.ply")
    jply.save_gaussian_ply(path, g)
    js = jgm.create_from_gaussian_ply(jply.load_gaussian_ply(path), 32,
                                      n_exposures=2)
    ts = gm.create_from_gaussian_ply(ply.load_gaussian_ply(path), 32,
                                     n_exposures=2, device=CPU)
    assert_state_equal(ts, js)
    assert int(ts.alive.sum()) == n
    np.testing.assert_allclose(torch.linalg.norm(ts.quat[:n], dim=-1),
                               np.ones(n), atol=1e-6)
    with pytest.raises(ValueError, match="capacity"):
        gm.create_from_gaussian_ply(ply.load_gaussian_ply(path), 8,
                                    device=CPU)


def make_scaffold(sh_degree=1, n=40, n_sky=8, seed=0):
    """tests/test_scaffold.py's scaffold (rotations and SH rest perturbed so
    scaffold rows differ from a fresh init) as (JAX, port) states."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    pts[:, 2] += 4.0
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    js = jgm.create_from_points(pts, cols, capacity=64, sh_degree=sh_degree,
                                skybox_num=n_sky, scene_radius=2.0)
    js = dataclasses.replace(
        js, quat=js.quat + 0.01,
        f_rest=js.f_rest + jnp.asarray(rng.normal(
            size=js.f_rest.shape).astype(np.float32)))
    ts = convert.state_from_numpy(leaves(js)["gaussians"],
                                  n_skybox=js.n_skybox, device=CPU)
    return js, ts


def test_select_scaffold_ring_matches_jax():
    js, ts = make_scaffold()
    xyz = ts.xyz.numpy()
    for center, extent, n_sky in (((1.0, 0.0, 4.0), 1.0, 8),
                                  ((0.0, 0.0, 0.0), 1.5, 0),
                                  ((-1.0, 1.0, 4.0), 0.5, 3)):
        got = gm.select_scaffold_ring(xyz, np.array(center), extent, n_sky)
        ref = jgm.select_scaffold_ring(np.asarray(js.xyz), np.array(center),
                                       extent, n_sky)
        np.testing.assert_array_equal(got, ref)
        assert got[:n_sky].all()


SCAFFOLD_CASES = {
    "sh1_into_sh3": dict(scaffold_sh=1, sh_degree=3),
    "sh3_into_sh1": dict(scaffold_sh=3, sh_degree=1),
    "max_rows": dict(scaffold_sh=1, sh_degree=3, max_scaffold_rows=12),
    "max_rows_below_skybox": dict(scaffold_sh=1, sh_degree=1,
                                  max_scaffold_rows=4),
}


@pytest.mark.parametrize("case", list(SCAFFOLD_CASES))
def test_create_with_scaffold_matches_jax(case):
    spec = dict(SCAFFOLD_CASES[case])
    js, ts = make_scaffold(sh_degree=spec.pop("scaffold_sh"))
    center = np.array([1.0, 0.0, 4.0], np.float32)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-0.4, 0.4, (10, 3)).astype(np.float32) + center
    cols = rng.uniform(0, 1, (10, 3)).astype(np.float32)
    jout = jgm.create_with_scaffold(js, center, 1.0, pts, cols,
                                    capacity=128, n_exposures=2, **spec)
    tout = gm.create_with_scaffold(ts, center, 1.0, pts, cols, capacity=128,
                                   n_exposures=2, device=CPU, **spec)
    n_pre = tout.n_skybox + tout.n_scaffold
    assert_state_equal(tout, jout, knn_rows=slice(n_pre, n_pre + 10))
    assert tout.n_skybox == 8 and int(tout.alive.sum()) == n_pre + 10
    if "max_scaffold_rows" in spec:
        # every skybox row stays; the ring fills what is left of the cap
        assert tout.n_scaffold == max(spec["max_scaffold_rows"] - 8, 0)
    else:
        assert tout.n_scaffold > 0
    with pytest.raises(ValueError, match="capacity"):
        gm.create_with_scaffold(ts, center, 1.0, pts, cols, capacity=12,
                                device=CPU)
