"""Port parity for scale-out (hlod_gaussians_torch/parallel, the
multi-process branch of pipeline/full_train.run_pipeline and the
multi-process dry run) against the JAX package on the CPU.

The port's ranks are Gloo worlds of 2 and 4 processes started with
parallel.dryrun.spawn_world (a file:// rendezvous under tmp_path, one
PyTorch thread a rank, a deadline); their bodies live in
tests/torch_parallel_worker.py, which imports no JAX. JAX runs here, in
the parent, on the 8 virtual CPU devices of tests/conftest.py, with its
plain (xla) render path; the port renders with its pallas backend (its
kernel wrappers on their plain versions). Inputs are made with numpy from a
seed and handed to the ranks as .npz files; the ranks write their results
back the same way.

Tolerances are the train step's (tests/test_torch_train.py): the loss to
rtol 1e-5, Adam moments and xyz_grad_accum to atol 1e-4 after scaling by
the largest JAX magnitude, denom and max_radii exact, parameters within
1e-6 where the JAX gradient is large and within 2 lr elsewhere; images to
atol 2e-5 and n_selected exact."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hlod_gaussians_tpu.config import MeshConfig as JMesh
from hlod_gaussians_tpu.config import OptimizationConfig as JOpt
from hlod_gaussians_tpu.config import RasterizerConfig as JConfig
from hlod_gaussians_tpu.models import gaussians as jgm
from hlod_gaussians_tpu.parallel import chunk_parallel as jcp
from hlod_gaussians_tpu.parallel import data_parallel as jdp
from hlod_gaussians_tpu.parallel import distributed as jdist
from hlod_gaussians_tpu.parallel import tile_parallel as jtp
from hlod_gaussians_tpu.train import flat as jflat
from hlod_gaussians_tpu.utils import camera as jcam
from hlod_gaussians_torch import convert, optim, render
from hlod_gaussians_torch.config import (MeshConfig, OptimizationConfig,
                                         RasterizerConfig)
from hlod_gaussians_torch.parallel import chunk_parallel as cpar
from hlod_gaussians_torch.parallel import data_parallel as dp
from hlod_gaussians_torch.parallel import distributed as pdist
from hlod_gaussians_torch.parallel.dryrun import dryrun_multichip, spawn_world
from hlod_gaussians_torch.train import flat
from hlod_gaussians_torch.utils.camera import make_camera
from tests import torch_parallel_worker as worker
from tests.test_torch_train import leaves

CPU = torch.device("cpu")
W = H = 32
JCFG = JConfig(backend="xla", tile_w=16, tile_h=16, max_dup=2048)
CFG = dict(backend="pallas", tile_w=16, tile_h=16, max_dup=2048)
OPT = dict(position_lr_init=1e-3, iterations=200)
EXTENT = 5.0
SKY = 24            # skybox rows of the gauss-sharded scene (first shard)
WORLD_TIMEOUT_S = 240.0

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- scenes -----------------------------------------------------------------

def toy(seed=0, cap=128, n=32, **kw):
    """tests/test_parallel.py's toy scene (JAX state)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    pts[:, 2] += 4.0
    cols = rng.random((n, 3)).astype(np.float32)
    return jgm.create_from_points(pts, cols, capacity=cap, sh_degree=1,
                                  opacity_init=0.6, **kw)


def yaw_camera(a, x=0.0):
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]])
    c = np.array([x, 0.0, 0.0])
    return R, -R.T @ c


def views(poses, seed):
    """JAX cameras at ``poses`` and seeded random targets, and the same as
    stacked numpy arrays."""
    cams = [jcam.make_camera(R, T, 0.8, 0.8, W, H) for R, T in poses]
    gts = np.random.default_rng(seed).uniform(
        0, 1, (len(poses), 3, H, W)).astype(np.float32)
    arrs = dict(wv=np.stack([np.asarray(c.world_view) for c in cams]),
                fp=np.stack([np.asarray(c.full_proj) for c in cams]),
                campos=np.stack([np.asarray(c.campos) for c in cams]),
                tfx=np.asarray([float(c.tan_fovx) for c in cams], np.float32),
                tfy=np.asarray([float(c.tan_fovy) for c in cams], np.float32),
                gts=gts)
    return cams, arrs


def jax_dp(state, arrs, eidx, mesh_shape, use_exposure, skybox_locked,
           scale_big_gauss):
    """The JAX dp_train_step over a (data, gauss) mesh of virtual devices
    -> (its new state's leaves, loss). Its skybox_locked and
    scale_big_gauss are not static arguments of its jit, so only their
    defaults (False, True) can be passed: a traced bool raises."""
    assert not skybox_locked and scale_big_gauss
    mesh = jdp.make_mesh(*mesh_shape)
    ts = jdp.shard_train_state(jflat.init_flat_train(state), mesh)
    shard = jdp.batch_sharding(mesh)
    put = lambda k: jax.device_put(jnp.asarray(arrs[k]),
                                   shard(arrs[k].ndim))
    new, loss = jdp.dp_train_step(
        ts, put("wv"), put("fp"), put("campos"), put("tfx"), put("tfy"),
        put("gts"), jnp.zeros(3),
        jax.device_put(jnp.asarray(eidx, jnp.int32), shard(1)), EXTENT,
        opt=JOpt(**OPT), cfg=JCFG, width=W, height=H, k_max=128,
        sh_degree=1, use_exposure=use_exposure)
    return leaves(new), float(loss)


def stacked_leaves(bts):
    """leaves() of a chunk-stacked JAX state (its steps are [K] arrays)."""
    one = leaves(jcp.unstack_states(bts)[0])
    out = {k: np.asarray(getattr(bts, k)) for k in worker.STATS}
    return dict(
        gaussians={k: np.asarray(getattr(bts.gaussians, k))
                   for k in one["gaussians"]},
        adam=dict(m={k: np.asarray(v) for k, v in bts.adam.m.items()},
                  v={k: np.asarray(v) for k, v in bts.adam.v.items()},
                  step=np.asarray(bts.adam.step)),
        step=np.asarray(bts.step), **out)


def spec(**step):
    return json.dumps(dict(opt=OPT, cfg=CFG, step=dict(
        extent=EXTENT, width=W, height=H, k_max=128, sh_degree=1, **step)))


def state_entries(prefix, state, mesh=None, arrs=None, eidx=None, **step):
    out = worker.state_arrays(leaves(jflat.init_flat_train(state)), prefix)
    out[prefix + "n_skybox"] = np.int32(state.n_skybox)
    out[prefix + "spec"] = spec(**step)
    if mesh is not None:
        out[prefix + "mesh"] = np.asarray(mesh)
    if arrs is not None:
        out.update({prefix + k: v for k, v in arrs.items()})
        out[prefix + "eidx"] = np.asarray(eidx, np.int32)
    return out


STEP_DP = dict(use_exposure=True, skybox_locked=False, scale_big_gauss=True)
STEP_SAME = dict(use_exposure=False, skybox_locked=False,
                 scale_big_gauss=False)
STEP_CHUNK = dict(use_exposure=False, skybox_locked=False,
                  scale_big_gauss=False)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """The inputs of every world and the JAX package's results on them."""
    d = tmp_path_factory.mktemp("par")
    z, ref = {"bg": np.zeros(3, np.float32)}, {}

    # DP over two distinct views (mesh (2, 1)), with per-view exposures
    st = toy(seed=3, n_exposures=2)
    _, arrs = views([yaw_camera(-0.15), yaw_camera(0.15)], seed=1)
    z.update(state_entries("dp2/", st, (2, 1), arrs, [0, 1], **STEP_DP))
    ref["dp2"] = jax_dp(st, arrs, [0, 1], (2, 1), **STEP_DP)

    # DP on mesh (2, 2): gauss-sharded rows, with skybox rows
    st = toy(seed=4, n_exposures=2, skybox_num=SKY, scene_radius=0.5)
    _, arrs = views([yaw_camera(0.1), yaw_camera(-0.05, 0.2)], seed=2)
    z.update(state_entries("dp4/", st, (2, 2), arrs, [1, 0], **STEP_DP))
    ref["dp4"] = jax_dp(st, arrs, [1, 0], (2, 2), **STEP_DP)
    z.update(state_entries("dp4lock/", st, (2, 2), arrs, [1, 0],
                           **dict(STEP_DP, skybox_locked=True)))
    ref["dp4_input"] = leaves(jflat.init_flat_train(st))

    # four identical views over two ranks against one port train_step
    st = toy(seed=3)
    _, arrs = views([yaw_camera(0.0)] * 4, seed=3)
    arrs["gts"] = np.zeros_like(arrs["gts"])
    z.update(state_entries("same/", st, (2, 1), arrs, [0] * 4, **STEP_SAME))
    tts = convert.train_state_from_numpy(
        leaves(jflat.init_flat_train(st)), n_skybox=0, device=CPU)
    cam = make_camera(*yaw_camera(0.0), 0.8, 0.8, W, H, device=CPU)
    one, aux = flat.train_step(
        tts, cam.world_view, cam.full_proj, cam.campos, cam.tan_fovx,
        cam.tan_fovy, torch.zeros(3, H, W), torch.zeros(3), exposure_idx=0,
        scene_extent=EXTENT, opt=OptimizationConfig(**OPT),
        cfg=RasterizerConfig(**CFG), width=W, height=H, k_max=128,
        sh_degree=1, use_exposure=False, scale_big_gauss=False)
    ref["same"] = (worker.torch_leaves(one), float(aux.loss))

    # K = 4 chunks, a view each, on make_mesh(4, 1)
    chunk_states = [jflat.init_flat_train(toy(seed=10 + i)) for i in range(4)]
    _, arrs = views([yaw_camera(0.1 * i - 0.15) for i in range(4)], seed=4)
    stacked = jcp.stack_states(chunk_states)
    z.update({"chunks/" + k: v for k, v in
              worker.state_arrays(stacked_leaves(stacked), "").items()})
    z.update({"chunks/" + k: v for k, v in arrs.items()})
    z.update({"chunks/eidx": np.zeros(4, np.int32), "chunks/n_skybox": 0,
              "chunks/spec": spec(**STEP_CHUNK)})
    mesh = jdp.make_mesh(4, 1)
    bts = jcp.shard_chunk_states(stacked, mesh)
    j = lambda k: jnp.asarray(arrs[k])
    bts, jaux = jcp.chunk_parallel_step(
        bts, j("wv"), j("fp"), j("campos"), j("tfx"), j("tfy"), j("gts"),
        jnp.zeros(3), jnp.zeros(4, jnp.int32), EXTENT, opt=JOpt(**OPT),
        cfg=JCFG, width=W, height=H, k_max=128, sh_degree=1,
        use_exposure=False, scale_big_gauss=False)
    ref["chunk_step"] = [leaves(ts) for ts in jcp.unstack_states(bts)]
    ref["chunk_loss"] = np.asarray(jaux.loss)
    boosted = dataclasses.replace(
        bts, xyz_grad_accum=jnp.full_like(bts.xyz_grad_accum, 1e9),
        max_radii=jnp.full_like(bts.max_radii, 100.0))
    dens, n_split = jcp.chunk_parallel_densify(boosted, EXTENT,
                                               opt=JOpt(**OPT))
    ref["chunk_dens"] = [leaves(ts) for ts in jcp.unstack_states(dens)]
    ref["chunk_split"] = np.asarray(n_split)

    # a tile-parallel frame (tests/test_parallel.py:150-167's scene; the
    # LOD frame is in test_torch_parallel_lod.py)
    z.update(tile_inputs(ref))
    z["spec"] = json.dumps(dict(tile_cfg=CFG, tile_wh=[W, H]))
    inputs = str(d / "inputs.npz")
    np.savez(inputs, **z)
    return inputs, ref, d


def tile_inputs(ref):
    """The flat tile-parallel scene, and the JAX package's banded frame of
    it on a 2-device tile mesh into ``ref``."""
    z = {}
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]), ("tile",))
    act = jgm.activate(toy(seed=7, n=64))
    cam = jcam.make_camera(np.eye(3), np.zeros(3), 0.8, 0.8, W, H)
    flat_args = (act.means3d, act.scales, act.quats, act.opacities, act.shs,
                 act.valid, cam.world_view, cam.full_proj, cam.campos,
                 cam.tan_fovx, cam.tan_fovy)
    img, trunc = jtp.render_tile_parallel(
        *flat_args, jnp.zeros(3), mesh, sh_degree=1, width=W, height=H,
        cfg=JCFG, k_max=256)
    ref["tile_flat"] = (np.asarray(img), bool(trunc))
    for k, v in zip(("means3d", "scales", "quats", "opacities", "shs",
                     "valid", "wv", "fp", "campos", "tfx", "tfy"), flat_args):
        z["flat/" + k] = np.asarray(v)

    return z


def _world(refs, n, tasks, name):
    inputs, _, d = refs
    out = d / name
    out.mkdir()
    spawn_world(worker.run_tasks, n, (tasks, inputs, str(out), "cpu"),
                device="cpu", timeout_s=WORLD_TIMEOUT_S, tmpdir=str(d))
    return lambda tag, r: np.load(out / f"{tag}_rank{r}.npz")


@pytest.fixture(scope="module")
def world2(refs):
    return _world(refs, 2, ["dp:dp2/", "dp:same/", "mesh", "chunks", "tiles"],
                  "w2")


@pytest.fixture(scope="module")
def world4(refs):
    return _world(refs, 4, ["dp:dp4/", "dp:dp4lock/", "mesh"], "w4")


# ---- checks -----------------------------------------------------------------

def _scaled_close(got, ref, atol, err_msg):
    ref = np.asarray(ref, np.float64)
    scale = np.abs(ref).max() + 1e-12
    np.testing.assert_allclose(np.asarray(got) / scale, ref / scale,
                               atol=atol, err_msg=err_msg)


def assert_step_close(got, ref, step=0, extent=EXTENT):
    """The train step's tolerances (tests/test_torch_train.py)."""
    assert int(got["step"]) == int(ref["step"])
    assert int(got["adam"]["step"]) == int(ref["adam"]["step"])
    for k in ref["adam"]["m"]:
        _scaled_close(got["adam"]["m"][k], ref["adam"]["m"][k], 1e-4,
                      f"m {k}")
        _scaled_close(got["adam"]["v"][k], ref["adam"]["v"][k], 1e-4,
                      f"v {k}")
    _scaled_close(got["xyz_grad_accum"], ref["xyz_grad_accum"], 1e-4,
                  "xyz_grad_accum")
    np.testing.assert_array_equal(got["denom"], ref["denom"])
    np.testing.assert_array_equal(got["max_radii"], ref["max_radii"])
    lrs = optim.param_lrs(OptimizationConfig(**OPT), step, extent)
    for k in ref["adam"]["m"]:
        g, r = got["gaussians"][k], ref["gaussians"][k]
        m = np.abs(ref["adam"]["m"][k])      # 0.1 |grad| after one step
        big = m > 1e-3 * m.max()
        diff = np.abs(g - r)
        assert diff[big].max(initial=0.0) <= 1e-6, k
        assert diff.max(initial=0.0) <= 2 * lrs[k] + 1e-6, k
    for k in ("alive", "nodes"):
        np.testing.assert_array_equal(got["gaussians"][k],
                                      ref["gaussians"][k], err_msg=k)


# ---- config and assignment ---------------------------------------------------

def test_mesh_config_matches_jax(world4):
    """MeshConfig's fields and shape; make_mesh_from_config lays the world
    out as the JAX package's (data, tile) mesh, rank-major."""
    for kw in ({}, dict(data=2, tile=3, tile_axis="t")):
        assert dataclasses.asdict(MeshConfig(**kw)) == \
            dataclasses.asdict(JMesh(**kw))
        assert MeshConfig(**kw).shape == JMesh(**kw).shape
    jm = jdp.make_mesh_from_config(JMesh(data=2, tile=2))
    for r in range(4):
        got = world4("mesh", r)
        assert tuple(got["shape"]) == tuple(jm.devices.shape)
        assert tuple(got["dims"]) == jm.axis_names == ("data", "tile")
        assert tuple(got["coord"]) == (r // 2, r % 2)


@pytest.mark.parametrize("world", [1, 2, 3, 4, 5])
def test_process_chunk_assignment_matches_jax(world, monkeypatch):
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size",
                        lambda group=None: world)
    monkeypatch.setattr(jax, "process_count", lambda: world)
    for r in range(world):
        monkeypatch.setattr(torch.distributed, "get_rank",
                            lambda group=None, r=r: r)
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        for n_chunks in range(13):
            assert pdist.process_chunk_assignment(n_chunks) == \
                jdist.process_chunk_assignment(n_chunks), (r, n_chunks)


def test_replicate_and_local_batches(world2, world4):
    """replicate is rank 0's tensor everywhere; global_view_batch keeps the
    rank's own views; make_global_mesh lays the whole world on `data`; each
    rank of 2 and 4 takes its block of 7 chunks."""
    for world, n in ((world2, 2), (world4, 4)):
        blocks = []
        for r in range(n):
            got = world("mesh", r)
            assert tuple(got["global_shape"]) == (n, 1)
            assert tuple(got["global_dims"]) == ("data", "gauss")
            np.testing.assert_array_equal(got["replicated"], np.zeros(3))
            np.testing.assert_array_equal(got["local"], np.full((1, 2), r))
            blocks.append(got["chunks"].tolist())
        assert sum(blocks, []) == list(range(7))


# ---- data-parallel --------------------------------------------------------------

def test_dp_train_step_world_of_two_matches_jax(refs, world2):
    """Two ranks, a distinct view each with its own exposure, against the
    JAX step on make_mesh(2, 1); both ranks hold the same state."""
    ref, ref_loss = refs[1]["dp2"]
    for r in range(2):
        got = world2("dp_dp2", r)
        np.testing.assert_allclose(float(got["loss"]), ref_loss, rtol=1e-5)
        assert_step_close(worker.arrays_leaves(got, "full/"), ref)
        assert tuple(got["coord"]) == (r, 0)


def test_dp_train_step_gauss_sharded_matches_jax(refs, world4):
    """Four ranks as mesh (2, 2): each holds half the rows (the skybox rows
    in the first half); the rows reassembled by gauss
    coordinate equal the JAX step on make_mesh(2, 2), and both data
    replicas of a block agree bitwise."""
    ref, ref_loss = refs[1]["dp4"]
    shards = {}
    for r in range(4):
        got = world4("dp_dp4", r)
        np.testing.assert_allclose(float(got["loss"]), ref_loss, rtol=1e-5)
        d_i, g_i = (int(x) for x in got["coord"])
        assert (d_i, g_i) == (r // 2, r % 2)
        shard = worker.arrays_leaves(got, "shard/")
        assert shard["gaussians"]["xyz"].shape[0] == 64
        if g_i in shards:
            for k, v in shards[g_i]["gaussians"].items():
                np.testing.assert_array_equal(shard["gaussians"][k], v)
        shards[g_i] = shard
        assert_step_close(worker.arrays_leaves(got, "full/"), ref)
    whole = {k: np.concatenate([shards[0]["gaussians"][k],
                                shards[1]["gaussians"][k]])
             for k in ("xyz", "log_scale", "alive")}
    for k, v in whole.items():
        np.testing.assert_array_equal(
            v, worker.arrays_leaves(world4("dp_dp4", 0), "full/")
            ["gaussians"][k])


def test_dp_skybox_lock_on_gauss_shards(refs, world4):
    """skybox_locked on mesh (2, 2) (the JAX step cannot take it: it is not
    a static argument there): the skybox rows, all in the first shard,
    keep their parameters, and every other row equals the unlocked step's
    bitwise."""
    start = refs[1]["dp4_input"]["gaussians"]
    unlocked = worker.arrays_leaves(world4("dp_dp4", 0), "full/")
    free = unlocked["gaussians"]
    seen = unlocked["denom"][:SKY] > 0          # skybox rows in view
    assert seen.any()
    assert (free["xyz"][:SKY][seen] != start["xyz"][:SKY][seen]).any()
    for r in range(4):
        got = worker.arrays_leaves(world4("dp_dp4lock", r), "full/")
        for k in ("xyz", "f_dc", "f_rest", "log_scale", "quat",
                  "opacity_logit"):
            g = got["gaussians"][k]
            np.testing.assert_array_equal(g[:SKY], start[k][:SKY], err_msg=k)
            np.testing.assert_array_equal(g[SKY:], free[k][SKY:], err_msg=k)


def test_dp_identical_views_equal_one_train_step(refs, world2):
    """Four identical views over two ranks take the single-view step of
    flat.train_step (tests/test_parallel.py:61-93's check, in the port)."""
    ref, ref_loss = refs[1]["same"]
    got = worker.arrays_leaves(world2("dp_same", 0), "full/")
    np.testing.assert_allclose(float(world2("dp_same", 0)["loss"]),
                               ref_loss, rtol=1e-5)
    for k in ("xyz", "f_dc", "f_rest", "log_scale", "quat",
              "opacity_logit"):
        np.testing.assert_allclose(got["gaussians"][k],
                                   ref["gaussians"][k], atol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(got["denom"], 4 * ref["denom"])


def test_dp_train_step_in_one_process_equals_flat_step():
    """mesh=None (a world of one process) with one view is flat.train_step
    but for xyz_grad_accum, which sums instead of taking the max."""
    st = toy(seed=5)
    tts = convert.train_state_from_numpy(
        leaves(jflat.init_flat_train(st)), n_skybox=0, device=CPU)
    cam = make_camera(*yaw_camera(0.05), 0.8, 0.8, W, H, device=CPU)
    gt = torch.rand((3, H, W), generator=torch.Generator().manual_seed(0))
    kw = dict(scene_extent=EXTENT, opt=OptimizationConfig(**OPT),
              cfg=RasterizerConfig(**CFG), width=W, height=H, k_max=128,
              sh_degree=1, use_exposure=True)
    one, aux = flat.train_step(
        tts, cam.world_view, cam.full_proj, cam.campos, cam.tan_fovx,
        cam.tan_fovy, gt, torch.zeros(3), exposure_idx=0, **kw)
    b = lambda x: torch.as_tensor(x)[None]
    got, loss = dp.dp_train_step(
        tts, b(cam.world_view), b(cam.full_proj), b(cam.campos),
        b(cam.tan_fovx), b(cam.tan_fovy), gt[None], torch.zeros(3), [0],
        **kw)
    assert float(loss) == float(aux.loss)
    for k in ("xyz", "f_dc", "log_scale", "opacity_logit", "exposure"):
        assert torch.equal(getattr(got.gaussians, k),
                           getattr(one.gaussians, k)), k
    assert torch.equal(got.denom, one.denom)
    assert torch.equal(got.max_radii, one.max_radii)
    assert torch.equal(got.xyz_grad_accum, one.xyz_grad_accum)


def test_shard_and_gather_refuse_and_round_trip():
    """shard_rows takes each rank's block; a capacity the gauss axis does
    not divide is refused; the converter matches."""
    jts = jflat.init_flat_train(toy(seed=6, n_exposures=3, skybox_num=4,
                                    scene_radius=0.5))
    lv = leaves(jts)
    ts = convert.train_state_from_numpy(lv, n_skybox=4, device=CPU)
    parts = [dp.shard_rows(ts, i, 4) for i in range(4)]
    np.testing.assert_array_equal(
        torch.cat([p.gaussians.xyz for p in parts]).numpy(),
        lv["gaussians"]["xyz"])
    assert all(p.gaussians.exposure.shape == (3, 3, 4) for p in parts)
    assert all(p.adam.m["exposure"].shape == (3, 3, 4) for p in parts)
    conv = convert.sharded_train_state_from_numpy(
        lv, shard=2, n_shards=4, n_skybox=4, device=CPU)
    for k in ("xyz", "alive", "nodes"):
        assert torch.equal(getattr(conv.gaussians, k),
                           getattr(parts[2].gaussians, k))
    assert torch.equal(conv.adam.v["quat"], parts[2].adam.v["quat"])
    with pytest.raises(ValueError, match="divide"):
        dp.shard_rows(ts, 0, 3)


# ---- chunk-parallel ---------------------------------------------------------------

def test_chunk_parallel_step_matches_jax(refs, world2):
    """K = 4 chunks on two ranks (two each) against the JAX vmapped step
    on make_mesh(4, 1)."""
    ref = refs[1]
    for r in range(2):
        got = world2("chunks", r)
        np.testing.assert_allclose(got["loss"],
                                   ref["chunk_loss"][2 * r:2 * r + 2],
                                   rtol=1e-5)
        for i in range(2):
            assert_step_close(worker.arrays_leaves(got, f"step{i}/"),
                              ref["chunk_step"][2 * r + i])


def test_chunk_parallel_densify_matches_jax(refs, world2):
    """Densification of every chunk after the step (statistics raised so
    that every leaf qualifies): the same splits, rows and node tables."""
    ref = refs[1]
    for r in range(2):
        got = world2("chunks", r)
        np.testing.assert_array_equal(got["n_split"],
                                      ref["chunk_split"][2 * r:2 * r + 2])
        assert (got["n_split"] > 0).all()
        for i in range(2):
            g = worker.arrays_leaves(got, f"dens{i}/")
            j = ref["chunk_dens"][2 * r + i]
            for k in ("alive", "nodes"):
                np.testing.assert_array_equal(g["gaussians"][k],
                                              j["gaussians"][k])
            np.testing.assert_allclose(g["gaussians"]["xyz"],
                                       j["gaussians"]["xyz"], atol=1e-5)
            for part in ("m", "v"):
                for k, v in j["adam"][part].items():
                    _scaled_close(g["adam"][part][k], v, 1e-4, part + k)


def test_chunk_states_stack_and_shard():
    """stack / unstack / shard_chunk_states and the stacked converter:
    a K the data axis does not divide is refused."""
    jts = [jflat.init_flat_train(toy(seed=20 + i)) for i in range(3)]
    stacked = jcp.stack_states(jts)
    got = convert.stacked_train_state_from_numpy(
        stacked_leaves(stacked), n_skybox=0, device=CPU)
    assert got.step == (0, 0, 0) and got.gaussians.xyz.shape[0] == 3
    for i, ts in enumerate(cpar.unstack_states(got)):
        np.testing.assert_array_equal(ts.gaussians.xyz.numpy(),
                                      np.asarray(jts[i].gaussians.xyz))
    assert cpar.shard_chunk_states(got, None) is not None
    mesh = type("Mesh", (), dict(size=lambda self, d: 2,
                                 get_local_rank=lambda self, d: 1,
                                 get_group=lambda self, d: None))()
    with pytest.raises(ValueError, match="divide"):
        cpar.shard_chunk_states(got, mesh)
    two = cpar.shard_chunk_states(cpar.stack_states(
        cpar.unstack_states(got)[:2]), mesh)
    assert two.step == (0,) and torch.equal(
        two.gaussians.xyz[0], got.gaussians.xyz[1])


# ---- tile-parallel ----------------------------------------------------------------

@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_render_tile_parallel_matches_jax(refs, world2, backend):
    """The banded frame on two ranks against the JAX package's on a
    2-device tile mesh and against the port's one-rank render_arrays."""
    img_ref, trunc_ref = refs[1]["tile_flat"]
    z = np.load(refs[0])
    t = lambda k: torch.as_tensor(z["flat/" + k])
    one = render.render_arrays(
        t("means3d"), t("scales"), t("quats"), t("opacities"), t("shs"),
        t("valid"), t("wv"), t("fp"), t("campos"), t("tfx"), t("tfy"),
        torch.zeros(3), sh_degree=1, width=W, height=H,
        cfg=RasterizerConfig(**dict(CFG, backend=backend)), k_max=256)
    for r in range(2):
        got = world2("tiles", r)
        assert not bool(got[f"{backend}/flat_trunc"]) and not trunc_ref
        np.testing.assert_allclose(got[f"{backend}/flat"], img_ref,
                                   atol=2e-5)
        np.testing.assert_allclose(got[f"{backend}/flat"],
                                   one.image.numpy(), atol=2e-5)


def test_tile_rows_must_divide_over_bands():
    z = torch.zeros((1, 3))
    with pytest.raises(ValueError, match="divide"):
        render.render_arrays(
            z, z + 0.1, torch.tensor([[1.0, 0, 0, 0]]), torch.ones(1),
            torch.zeros(1, 4, 3), torch.ones(1, dtype=torch.bool),
            torch.eye(4), torch.eye(4), torch.zeros(3), torch.tensor(0.5),
            torch.tensor(0.5), torch.zeros(3), sh_degree=1, width=W,
            height=H, cfg=RasterizerConfig(**CFG), band=(0, 3))


# ---- the multi-process pipeline ------------------------------------------------------

@pytest.fixture(scope="module")
def pipeline_runs(tmp_path_factory):
    """run_pipeline on tests/test_torch_full_pipeline.py's two-cluster scene
    (two chunks, a few steps a stage): once in this process and once over
    a Gloo world of two ranks sharing one output directory."""
    from tests.test_torch_full_pipeline import pcfgs, scene_pair

    d = tmp_path_factory.mktemp("pipe_mp")
    _, (scene, tviews) = scene_pair()
    poses = scene_pair_poses()
    _, tp = pcfgs(coarse_iters=2, chunk_iters=3, post_iters=2)
    p = dict(pcfg=dataclasses.asdict(tp),
             opt=dict(iterations=50, densify_until_iter=0),
             post=dict(spt_root_volume=5e-3, min_spt_size=4),
             cfg=dict(backend="pallas", tile_w=16, tile_h=16, max_dup=8192))
    z = dict(spec=json.dumps(dict(pipeline=p, pipeline_out=str(d / "mp"))),
             **{"scene/points": scene.points, "scene/colors": scene.colors,
                "scene/extent": np.float32(scene.extent),
                "scene/R": np.stack([R for R, _, _ in poses]),
                "scene/T": np.stack([T for _, T, _ in poses]),
                "scene/centers": np.stack([c for _, _, c in poses]),
                "scene/images": np.stack([v.image.numpy() for v in tviews])})
    inputs = str(d / "inputs.npz")
    np.savez(inputs, **z)
    one = worker.run_scene_pipeline(np.load(inputs), str(d / "one"), CPU)
    (d / "mp").mkdir()
    out = d / "res"
    out.mkdir()
    spawn_world(worker.run_tasks, 2, (["pipeline"], inputs, str(out), "cpu"),
                device="cpu", timeout_s=WORLD_TIMEOUT_S, tmpdir=str(d))
    return one, d, [np.load(out / f"pipeline_rank{r}.npz") for r in range(2)]


def scene_pair_poses():
    """(R, T, center) of scene_pair's views, in its order."""
    from tests.test_torch_full_pipeline import CLUSTERS

    poses = []
    for x0 in CLUSTERS:
        for a in (-0.1, 0.1):
            R, T = yaw_camera(a, x0)
            poses.append((R, T, np.array([x0, 0.0, 0.0])))
    return poses


def test_run_pipeline_two_ranks_matches_one_process(pipeline_runs):
    """The two-rank run's merged.dhier equals the one-process run's: the
    node table and every field (the same CPU arithmetic on the same rank-
    independent seeds, so bitwise), rank 1 returns None, and each rank
    trained exactly its block of chunks."""
    from hlod_gaussians_torch.data import dhier as tdhier

    one, d, ranks = pipeline_runs
    assert bool(ranks[0]["returned"]) and not bool(ranks[1]["returned"])
    mp = tdhier.load_dhier(str(d / "mp" / "merged.dhier"))
    np.testing.assert_array_equal(mp.nodes, one.nodes)
    for k in ("pos", "quat", "log_scale", "opacity", "shs"):
        np.testing.assert_array_equal(getattr(mp, k), getattr(one, k),
                                      err_msg=k)
    assert open(d / "mp" / "merged.dhier", "rb").read() == \
        open(d / "one" / "merged.dhier", "rb").read()
    trained = []
    for r in range(2):
        rows = [json.loads(x) for x in
                open(d / "mp" / f"rank{r}.jsonl").read().splitlines()]
        trained.append(sorted({x["stage"] for x in rows
                               if x["stage"].startswith("chunk(")
                               and "n_rows" in x}))
    chunks = sorted(x for x in os.listdir(d / "mp") if x.startswith("chunk_"))
    assert len(chunks) == 2 and [len(t) for t in trained] == [1, 1]
    assert trained[0] != trained[1]
    assert os.path.exists(d / "mp" / "scaffold.npz")


def test_run_pipeline_multi_process_needs_an_output_dir(monkeypatch):
    """A world of two processes without a shared output directory is
    refused before any training."""
    from tests.test_torch_full_pipeline import port_run, scene_pair

    _, (ts, _) = scene_pair()
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size",
                        lambda group=None: 2)
    with pytest.raises(ValueError, match="shared output_dir"):
        port_run(ts, "", "")


# ---- the dry run ----------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(n, capfd):
    """The port's dryrun_multichip(n) on the CPU: the DP step (gauss axis 2
    wide at n = 4), the tile-parallel flat and LOD frames and the
    chunk-parallel step and densification pass their checks."""
    dryrun_multichip(n, device=CPU, timeout_s=WORLD_TIMEOUT_S)
    out = capfd.readouterr().out
    for what in ("DP mesh", "tile-parallel render OK",
                 "tile-parallel LOD OK", "chunk-parallel densify OK"):
        assert f"dryrun_multichip({n}): " in out and what in out, out
