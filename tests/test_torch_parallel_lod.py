"""Port parity for the tile-parallel LOD frame
(parallel/tile_parallel.render_lod_tile_parallel) against the JAX package
on the CPU: the replicated cut and lerp, then the banded blend with the LOD
alpha, on a Gloo world of two ranks (tests/torch_parallel_worker.py, a
file:// rendezvous under tmp_path) against the JAX package's frame on a
2-device tile mesh and the port's one-rank render_lod_masked, on
tests/test_parallel.py:170-215's 40-leaf tree: n_selected equal, images to
atol 2e-5. It has a file of its own because the JAX frame's compile takes
most of a minute (tests/test_torch_parallel.py holds the flat frame)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hlod_gaussians_tpu.hierarchy import build as jhb
from hlod_gaussians_tpu.hierarchy import cut as jhc
from hlod_gaussians_tpu.parallel import tile_parallel as jtp
from hlod_gaussians_tpu.utils import camera as jcam
from hlod_gaussians_torch import render
from hlod_gaussians_torch.config import RasterizerConfig
from hlod_gaussians_torch.hierarchy import cut as hc
from hlod_gaussians_torch.parallel.dryrun import spawn_world
from tests import torch_parallel_worker as worker
from tests.test_torch_parallel import CFG, JCFG, WORLD_TIMEOUT_S, H, W

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lod_frames(tmp_path_factory):
    """The tree, the JAX banded frame and the two ranks' frames."""
    import json

    d = tmp_path_factory.mktemp("lod_tp")
    n = 40
    rng = np.random.default_rng(21)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    pts[:, 2] += 4.0
    h = jhb.build_hierarchy(
        pts, np.full((n, 3), 0.05, np.float32),
        np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
        np.full((n,), 0.8, np.float32),
        rng.random((n, 1, 3)).astype(np.float32) - 0.5)
    params = dict(means3d=h.pos, scales=h.scale, quats=h.quat,
                  opacities=np.clip(h.opacity, 0, 1), shs=h.sh)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    m = h.nodes.shape[0]
    cam = jcam.make_camera(np.eye(3), np.zeros(3), 0.8, 0.8, W, H)
    cam_args = (cam.world_view, cam.full_proj, cam.campos, cam.tan_fovx,
                cam.tan_fovy)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]), ("tile",))
    img, n_sel, trunc = jtp.render_lod_tile_parallel(
        *jparams.values(), jnp.asarray(h.nodes), jnp.ones(m, bool),
        *cam_args, jnp.zeros(3), 0.01, mesh,
        interp_table=jhc.build_interp_table(jparams, jnp.asarray(h.nodes)),
        sh_degree=0, width=W, height=H, cfg=JCFG, k_max=256,
        use_frustum=False)
    ref = (np.asarray(img), int(n_sel), bool(trunc))

    z = {"lod/" + k: np.asarray(v, np.float32) for k, v in params.items()}
    z.update({"lod/nodes": h.nodes, "lod/alive": np.ones(m, bool),
              "lod/target": np.float32(0.01),
              "spec": json.dumps(dict(tile_cfg=CFG, tile_wh=[W, H]))})
    for k, v in zip(("wv", "fp", "campos", "tfx", "tfy"), cam_args):
        z["lod/" + k] = np.asarray(v)
    inputs = str(d / "inputs.npz")
    np.savez(inputs, **z)
    out = d / "w2"
    out.mkdir()
    spawn_world(worker.run_tasks, 2, (["tiles"], inputs, str(out), "cpu"),
                device="cpu", timeout_s=WORLD_TIMEOUT_S, tmpdir=str(d))
    return z, ref, [np.load(out / f"tiles_rank{r}.npz") for r in range(2)]


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_render_lod_tile_parallel_matches_jax(lod_frames, backend):
    """Each rank's assembled frame against the JAX package's and the
    port's one-rank render_lod_masked."""
    z, (img_ref, n_ref, trunc_ref), ranks = lod_frames
    t = lambda k: torch.as_tensor(z["lod/" + k])
    params = {k: t(k) for k in ("means3d", "scales", "quats", "opacities",
                                "shs")}
    one, n_one = render.render_lod_masked(
        *params.values(), t("nodes"), t("alive"), t("wv"), t("fp"),
        t("campos"), t("tfx"), t("tfy"), torch.zeros(3), 0.01, None, None,
        None, hc.build_interp_table(params, t("nodes")), sh_degree=0,
        width=W, height=H,
        cfg=RasterizerConfig(**dict(CFG, backend=backend)), k_max=256,
        use_frustum=False)
    for got in ranks:
        assert int(got[f"{backend}/lod_n"]) == n_ref == int(n_one) > 0
        assert not bool(got[f"{backend}/lod_trunc"]) and not trunc_ref
        np.testing.assert_allclose(got[f"{backend}/lod"], img_ref,
                                   atol=2e-5)
        np.testing.assert_allclose(got[f"{backend}/lod"],
                                   one.image.numpy(), atol=2e-5)
