"""Port parity for the pipeline entry points of pipeline/full_train.py against
the JAX package on the CPU (the JAX package's plain xla render path; the
port's pallas backend, i.e. its kernel wrappers on their plain versions):

* `train_flat_scene` over a few iterations, and `train_coarse_scaffold`
  with the JAX package's background draws replayed through ``bgs=``;
* `run_pipeline` on a two-cluster scene cut into two chunks, both packages
  starting from the scaffold .npz the JAX run wrote (``mcfg.scaffold_file``
  on the port's side): with no training iterations the merged .dhier
  equals JAX's (node table exact, floats to rtol 1e-6) and every chunk's
  center.txt, extent.txt and anchors.bin bytes are equal; with a few
  iterations a stage the merged node table is equal and the floats are
  within the train step's tolerance;
* resume (``skip_if_exists``: artifact mtimes unchanged, the merge
  byte-equal), ``keep_running`` past a chunk made to fail, and
  `run_pipeline_no_chunks` from a ``mcfg.pretrained`` PLY.

Tolerances are the train step's (test_torch_post.py): parameters within 2
lr a step plus 1e-6, and within 1e-6 a step where the reference gradient
is large (the chunk replays and the post stages, which are rerun from one
tree with every node's scales and rotation randomized); the kNN
log-scales of fresh rows to atol 1e-5, as test_torch_scaffold.py holds
them."""

import dataclasses
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hlod_gaussians_tpu.config import ModelConfig as JModel
from hlod_gaussians_tpu.config import OptimizationConfig as JOpt
from hlod_gaussians_tpu.config import PostConfig as JPost
from hlod_gaussians_tpu.config import RasterizerConfig as JConfig
from hlod_gaussians_tpu.data import dhier as jdhier
from hlod_gaussians_tpu.data import ply as jply
from hlod_gaussians_tpu.data.scene import SceneInfo as JScene
from hlod_gaussians_tpu.pipeline import full_train as jfull
from hlod_gaussians_tpu.utils import camera as jcam
from hlod_gaussians_torch import convert, optim, render
from hlod_gaussians_torch.config import (ModelConfig, OptimizationConfig,
                                         PostConfig, RasterizerConfig)
from hlod_gaussians_torch.data import dhier as tdhier
from hlod_gaussians_torch.data.scene import SceneInfo
from hlod_gaussians_torch.hierarchy import build as tbuild
from hlod_gaussians_torch.hierarchy import filter as flt
from hlod_gaussians_torch.models import gaussians as gm
from hlod_gaussians_torch.pipeline import chunking, full_train
from hlod_gaussians_torch.utils.camera import make_camera
from hlod_gaussians_torch.utils.metrics import MetricsLogger
from tests.jax_knn import knn_keeps_axis_max
from tests.test_torch_hier_build import _cov
from tests.test_torch_mcmc import leaves
from tests.test_torch_post import POST_FIELDS, assert_step_close

CPU = torch.device("cpu")
W = H = 64
# The JAX package's plain (xla) path: its pallas path's geometry gradients
# drift from its own xla path on chunk states with skybox rows (see
# test_jax_pallas_geometry_gradients_drift_with_a_skybox); the port runs its
# kernel wrappers, here on their plain versions.
JCFG = JConfig(backend="xla", tile_w=16, tile_h=16, max_dup=8192)
CFG = RasterizerConfig(backend="pallas", tile_w=16, tile_h=16, max_dup=8192)
EXTENT = 5.0
CLUSTERS = (-1.0, 1.0)
DHIER_FLOATS = ("pos", "quat", "log_scale", "opacity", "shs")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: PyTorch's intra-op threads only contend with the
    other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeInfo:
    """A scene camera carrying its ready view; R and T place its center for
    the chunker (tests/test_scaffold.py's stand-in)."""

    def __init__(self, v, campos):
        self.v = v
        self.R = np.eye(3)
        self.T = -np.asarray(campos, np.float64)


def scene_pair(n_pts=24, yaws=(-0.1, 0.1), seed=0):
    """Two point clusters at x = -1 and +1 (z = 4), two cameras looking at
    each from x = -1 / +1, their targets the port's plain render of the
    points (SH 1, opacity 0.8): the JAX and port (scene, views)."""
    rng = np.random.default_rng(seed)
    parts = []
    for x0 in CLUSTERS:
        p = rng.normal(size=(n_pts, 3)).astype(np.float32) * 0.3
        p[:, 0] += x0
        p[:, 2] += 4.0
        parts.append(p)
    pts = np.concatenate(parts)
    cols = rng.uniform(0.1, 0.9, pts.shape).astype(np.float32)
    truth = gm.create_from_points(pts, cols, capacity=64, sh_degree=1,
                                  opacity_init=0.8, device=CPU)
    act = gm.activate(truth)
    j_views, t_views, centers = [], [], []
    for x0 in CLUSTERS:
        for a in yaws:
            R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                          [-np.sin(a), 0, np.cos(a)]])
            c = np.array([x0, 0.0, 0.0])
            T = -R.T @ c
            cam = make_camera(R, T, 0.9, 0.9, W, H, device=CPU)
            img = render.render_arrays(
                act.means3d, act.scales, act.quats, act.opacities, act.shs,
                act.valid, cam.world_view, cam.full_proj, cam.campos,
                cam.tan_fovx, cam.tan_fovy, torch.zeros(3), sh_degree=1,
                width=W, height=H, cfg=CFG, k_max=256).image.numpy()
            i = len(t_views)
            t_views.append(dataclasses.replace(cam, image=torch.from_numpy(
                img), exposure_idx=i))
            j_views.append(jcam.make_camera(R, T, 0.9, 0.9, W, H,
                                            image=jnp.asarray(img),
                                            exposure_idx=i))
            centers.append(c)
    common = dict(points=pts, colors=cols, test_cameras=[], extent=EXTENT,
                  center=np.zeros(3, np.float32))
    j_scene = JScene(train_cameras=[FakeInfo(v, c) for v, c in
                                    zip(j_views, centers)], **common)
    t_scene = SceneInfo(train_cameras=[FakeInfo(v, c) for v, c in
                                       zip(t_views, centers)], **common)
    return (j_scene, j_views), (t_scene, t_views)


def pcfgs(**kw):
    spec = dict(coarse_iters=0, chunk_iters=0, post_iters=0, skybox_num=4,
                coarse_capacity=128, chunk_capacity=256, k_max=256,
                mh_walk=True, densification_interval=1000,
                post_densify_interval=1000, opacity_reset_interval=1000,
                chunk_size=1.1, chunk_point_padding=0.5)
    spec.update(kw)
    return jfull.PipelineConfig(**spec), full_train.PipelineConfig(**spec)


OPT = dict(iterations=50, densify_until_iter=0)
POST = dict(spt_root_volume=5e-3, min_spt_size=4)


def run_both(tmp_path, name, scaffold=None, **kw):
    """run_pipeline in both packages into tmp_path/name/{jax,torch}; the
    port reads the scaffold the JAX run wrote (or ``scaffold``)."""
    (js, _), (ts, _) = scene_pair()
    jp, tp = pcfgs(**kw)
    jdir, tdir = (str(tmp_path / name / k) for k in ("jax", "torch"))
    jm = jfull.run_pipeline(
        js, view_loader=lambda ci: ci.v, output_dir=jdir, pcfg=jp,
        opt=JOpt(**OPT), post=JPost(**POST), cfg=JCFG,
        mcfg=JModel(sh_degree=1, scaffold_file=scaffold or ""))
    scaffold = scaffold or os.path.join(jdir, "scaffold.npz")
    tm = full_train.run_pipeline(
        ts, view_loader=lambda ci: ci.v, output_dir=tdir, pcfg=tp,
        opt=OptimizationConfig(**OPT), post=PostConfig(**POST), cfg=CFG,
        mcfg=ModelConfig(sh_degree=1, scaffold_file=scaffold), device=CPU)
    return jm, tm, jdir, tdir, scaffold


def chunk_dirs(root):
    return sorted(d for d in os.listdir(root) if d.startswith("chunk_"))


@pytest.fixture(scope="module")
def zero_iter_runs(tmp_path_factory):
    # untrained states: the JAX kNN with the port's last cell for each axis
    # maximum (tests/jax_knn.py; the two kNNs are compared in
    # test_torch_knn.py)
    with knn_keeps_axis_max():
        return run_both(tmp_path_factory.mktemp("pipe"), "zero")


@pytest.fixture(scope="module")
def jax_knn_scaffold(tmp_path_factory):
    """The JAX package's zero-step scaffold from its own kNN init (each
    axis maximum wrapped, tests/jax_knn.py), as its run_pipeline writes
    it: the scaffold both packages' few-step runs start from."""
    from hlod_gaussians_tpu.utils import checkpoint as jckpt
    (js, jv), _ = scene_pair()
    jp, _ = pcfgs()
    ts = jfull.train_coarse_scaffold(
        jv, js.points, js.colors, js.extent, jp.coarse_iters,
        jp.coarse_capacity, opt=JOpt(**OPT), cfg=JCFG, pcfg=jp,
        skybox_num=jp.skybox_num)
    path = str(tmp_path_factory.mktemp("scaffold") / "scaffold.npz")
    jckpt.save_flat_state(path, ts)
    return path


def assert_dhier_close(t, j, atol=None, rtol=1e-6):
    """The node table exact; positions and SH to ``rtol`` (or within
    ``atol[field]`` after training); leaf scales, opacities and covariances
    likewise. Interior rotations, scales and opacities are left out: the
    reference's closed-form eigensolver (build.sym_eigh3) returns rounding
    noise for a merged covariance with a repeated eigenvalue, which is what
    two isotropic kNN-initialized leaves give (see
    test_reference_eigensolver_is_noise_on_repeated_eigenvalues)."""
    np.testing.assert_array_equal(t.nodes, j.nodes)
    leaf = j.nodes[:, 2] == 0

    def close(got, ref, k):
        if atol is None:
            # a covariance through two float32 rotations: ~1 ulp of 1
            np.testing.assert_allclose(got, ref, rtol=rtol, atol=1e-6
                                       if k == "cov" else 1e-7, err_msg=k)
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=atol[k],
                                       err_msg=k)
    close(t.pos, j.pos, "pos")
    close(t.shs, j.shs, "shs")
    close(t.log_scale[leaf], j.log_scale[leaf], "log_scale")
    close(t.opacity[leaf], j.opacity[leaf], "opacity")
    cov_t = _cov(np.exp(t.log_scale[leaf]), t.quat[leaf])
    cov_j = _cov(np.exp(j.log_scale[leaf]), j.quat[leaf])
    scale = np.abs(cov_j).max(axis=(1, 2), keepdims=True)
    close(cov_t / scale, cov_j / scale, "cov")


def test_run_pipeline_zero_iters_matches_jax(zero_iter_runs):
    jm, tm, jdir, tdir, _ = zero_iter_runs
    assert chunk_dirs(jdir) == chunk_dirs(tdir) == ["chunk_0_0", "chunk_1_0"]
    assert_dhier_close(tm, jm)
    for d in chunk_dirs(jdir):
        for f in ("center.txt", "extent.txt", "anchors.bin"):
            assert filecmp.cmp(os.path.join(jdir, d, f),
                               os.path.join(tdir, d, f), shallow=False), \
                (d, f)
        n = tdhier.load_dhier(os.path.join(tdir, d,
                                           "hierarchy.dhier_opt")).nodes
        np.testing.assert_array_equal(n, jdhier.load_dhier(os.path.join(
            jdir, d, "hierarchy.dhier_opt")).nodes)
        a = flt.read_anchors(os.path.join(tdir, d, "anchors.bin"))
        assert len(a) and a.min() >= 0 and a.max() < n.shape[0]
    # the merged file is the returned hierarchy
    back = tdhier.load_dhier(os.path.join(tdir, "merged.dhier"))
    np.testing.assert_array_equal(back.nodes, tm.nodes)
    np.testing.assert_array_equal(back.pos, tm.pos)


def test_reference_eigensolver_is_noise_on_repeated_eigenvalues():
    """Why interior rotations are not compared above: merging two
    isotropic Gaussians gives an isotropic covariance plus a rank-1 term,
    whose two smaller eigenvalues are equal. The closed-form sym_eigh3 of
    both packages then takes null vectors of a rank-1 matrix, i.e.
    rounding noise, and most results do not reconstruct the input."""
    from hlod_gaussians_tpu.hierarchy import build as jbuild
    from hlod_gaussians_torch.hierarchy import build as tbuild
    rng = np.random.default_rng(0)
    d = rng.normal(size=(200, 3))
    cov = (rng.uniform(0.01, 0.1, (200, 1, 1)) * np.eye(3)
           + 0.5 * d[:, :, None] * d[:, None, :]).astype(np.float32)

    def recon_err(evals, evecs):
        evals, evecs = np.asarray(evals), np.asarray(evecs)
        rec = np.einsum("nij,nj,nkj->nik", evecs, evals, evecs)
        return np.abs(rec - cov).max(axis=(1, 2)) / np.abs(cov).max(
            axis=(1, 2))
    e_j = recon_err(*jbuild.sym_eigh3(jnp.asarray(cov)))
    e_t = recon_err(*(x.numpy() for x in tbuild.sym_eigh3(
        torch.from_numpy(cov))))
    assert (e_j > 1e-2).mean() > 0.5 and (e_t > 1e-2).mean() > 0.5
    # a covariance with distinct eigenvalues is reconstructed by both
    aniso = (np.diag([0.01, 0.02, 0.04])[None]
             + 0.001 * d[:, :, None] * d[:, None, :]).astype(np.float32)
    cov = aniso
    assert recon_err(*jbuild.sym_eigh3(jnp.asarray(cov))).max() < 1e-4
    assert recon_err(*(x.numpy() for x in tbuild.sym_eigh3(
        torch.from_numpy(cov)))).max() < 1e-4


def step_atol(steps):
    """The train step's parameter tolerance over ``steps`` steps (2 lr a
    step plus 1e-6), the largest learning rate over those steps for each
    .dhier field; the activated opacity moves at most a quarter of its
    logit, and a normalized covariance at most its log-scales' and
    rotation's moves."""
    lrs = [optim.param_lrs(OptimizationConfig(**OPT), i, EXTENT)
           for i in range(steps)]
    lr = {k: max(x[k] for x in lrs) for k in lrs[0]}
    return dict(pos=2 * steps * lr["xyz"] + 1e-6,
                shs=2 * steps * lr["f_dc"] + 1e-6,
                log_scale=2 * steps * lr["log_scale"] + 1e-6,
                opacity=0.5 * steps * lr["opacity_logit"] + 1e-6,
                cov=2 * steps * (2 * lr["log_scale"] + 4 * lr["quat"])
                + 1e-6)


def assert_leaves_close(t, j, atol):
    """The node table exact and every leaf within ``atol``: a leaf's
    parameters move by at most the step tolerance whatever its gradient,
    while an interior node starts from the merge of nearly isotropic
    leaves, which the reference's eigensolver leaves undetermined."""
    np.testing.assert_array_equal(t.nodes, j.nodes)
    leaf = j.nodes[:, 2] == 0
    got = dict(pos=t.pos, shs=t.shs, log_scale=t.log_scale,
               opacity=t.opacity)
    for k, v in got.items():
        np.testing.assert_allclose(v[leaf], getattr(j, k)[leaf], rtol=0,
                                   atol=atol[k], err_msg=k)
    cov_t = _cov(np.exp(t.log_scale[leaf]), t.quat[leaf])
    cov_j = _cov(np.exp(j.log_scale[leaf]), j.quat[leaf])
    scale = np.abs(cov_j).max(axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(cov_t / scale, cov_j / scale, rtol=0,
                               atol=atol["cov"], err_msg="cov")


def kd_leaf_rows(g):
    """(rows, kd leaf slot of each) of the hierarchy build over a trained
    chunk state's live non-skybox rows."""
    alive = np.asarray(g.alive)
    rows = np.where(alive)[0]
    rows = rows[rows >= g.n_skybox]
    means = torch.as_tensor(np.asarray(g.xyz)[rows])
    scales = torch.exp(torch.as_tensor(np.asarray(g.log_scale)[rows]))
    seg, _ = tbuild.assign_kd_segments(means, scales,
                                       tbuild._num_levels(len(rows)))
    return rows, seg.numpy()


def replay_chunk(ci, scaffold, chunk_iters):
    """Chunk ``ci`` of run_both's scene trained by hand in both packages
    from one initial state (JAX's create_with_scaffold, converted): the
    (JAX, port) FlatTrainStates."""
    from hlod_gaussians_tpu.models import gaussians as jgm
    from hlod_gaussians_tpu.pipeline import chunking as jchunking
    from hlod_gaussians_tpu.utils import checkpoint as jckpt
    (js, _), (ts, _) = scene_pair()
    jp, tp = pcfgs()
    kw = dict(chunk_size=jp.chunk_size, point_padding=jp.chunk_point_padding,
              min_n_cams=1, min_points=1)
    jc = jchunking.make_chunks(js, **kw)[ci]
    tc = chunking.make_chunks(ts, **kw)[ci]
    pts, cols = js.points[jc.point_mask], js.colors[jc.point_mask]
    j0 = jgm.create_with_scaffold(
        jckpt.load_flat_state(scaffold).gaussians, jc.center,
        float(jc.extent[0]), pts, cols, jp.chunk_capacity, sh_degree=1,
        n_exposures=8,
        max_scaffold_rows=max(0, jp.chunk_capacity - len(pts) - 4096))
    t0 = convert.state_from_numpy(leaves(j0)["gaussians"],
                                  n_skybox=j0.n_skybox,
                                  n_scaffold=j0.n_scaffold, device=CPU)
    jt = jfull.train_flat_scene(
        [dataclasses.replace(c.v, exposure_idx=k)
         for k, c in enumerate(jc.cameras)], pts, cols, EXTENT, chunk_iters,
        jp.chunk_capacity, opt=JOpt(**OPT), cfg=JCFG, pcfg=jp, sh_degree=1,
        initial_state=j0)
    tt = full_train.train_flat_scene(
        [dataclasses.replace(c.v, exposure_idx=k)
         for k, c in enumerate(tc.cameras)], pts, cols, EXTENT, chunk_iters,
        tp.chunk_capacity, opt=OptimizationConfig(**OPT), cfg=CFG, pcfg=tp,
        sh_degree=1, initial_state=t0, device=CPU)
    return jt, tt


def record_post(monkeypatch):
    """Both packages' post_optimize wrapped: each call's (positional
    arguments, keywords) in call order under "jax" and "torch", and the
    unwrapped functions under "jax_fn" and "torch_fn"."""
    calls = dict(jax=[], torch=[], jax_fn=jfull.post_optimize,
                 torch_fn=full_train.post_optimize)
    for name, mod in (("jax", jfull), ("torch", full_train)):
        def wrapped(*a, _fn=mod.post_optimize, _name=name, **kw):
            calls[_name].append((a, kw))
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, "post_optimize", wrapped)
    return calls


def assert_post_replays(calls, seed=5):
    """Each post stage of the run held at the train step's tolerance, every
    node included: both packages' post_optimize rerun with the views and
    settings of their own call, from one tree — JAX's input tree with every
    node's scales and rotation randomized, since an isotropic node's (and a
    merged node's repeated-eigenvalue) rotation gradient is rounding noise
    (test_train_flat_scene's note) — end within 1e-6 a step where JAX's
    gradient is large and within 2 lr a step elsewhere
    (test_torch_post.assert_step_close). The port's own call started from
    the same node table, with the same extent, iterations and capacity."""
    assert len(calls["jax"]) == len(calls["torch"]) > 0
    rng = np.random.default_rng(seed)
    for (ja, jkw), (ta, tkw) in zip(calls["jax"], calls["torch"]):
        np.testing.assert_array_equal(ta[0].nodes, ja[0].nodes)
        assert ta[2:5] == ja[2:5]
        fields = {k: np.array(v) if isinstance(v, np.ndarray) else v
                  for k, v in ja[0]._asdict().items()}
        n = fields["nodes"].shape[0]
        fields["log_scale"] = (fields["log_scale"] + 0.4 * rng.normal(
            size=(n, 3))).astype(np.float32)
        q = rng.normal(size=(n, 4))
        fields["quat"] = (q / np.linalg.norm(q, axis=1, keepdims=True)
                          ).astype(np.float32)
        jts = calls["jax_fn"](jdhier.DHier(**fields), *ja[1:], **jkw)
        tts = calls["torch_fn"](tdhier.DHier(**fields), *ta[1:], **tkw)
        opt, extent, n_iters = tkw["opt"], ta[2], ta[3]
        lrs = {k: max(optim.param_lrs(opt, i, extent)[k]
                      for i in range(n_iters)) for k in POST_FIELDS}
        assert_step_close(tts, jts, lrs, steps=n_iters)


def test_run_pipeline_few_iters_matches_jax(tmp_path, jax_knn_scaffold,
                                            monkeypatch):
    """Three chunk steps and two post steps a chunk, from the same
    scaffold: the merged and chunk node tables equal and every leaf within
    the step tolerance. A hand replay of each chunk's training shows that
    both packages' trained states are within the step tolerance and put
    every row into the same kd leaf (the split axis follows the longest
    side of a box of mean +- 3 max scale, so a scale moved within the
    tolerance could turn it; the failure message names such rows); each
    post stage rerun with its recorded views and settings holds every node
    to the step tolerance (assert_post_replays)."""
    scaffold = jax_knn_scaffold
    steps = 3
    calls = record_post(monkeypatch)
    jm, tm, jdir, tdir, _ = run_both(tmp_path, "few", scaffold=scaffold,
                                     chunk_iters=steps, post_iters=2)
    assert_post_replays(calls)
    dirs = chunk_dirs(jdir)
    assert dirs == chunk_dirs(tdir) == ["chunk_0_0", "chunk_1_0"]
    atol = step_atol(steps + 2)
    assert_leaves_close(tm, jm, atol)
    lrs = {k: max(optim.param_lrs(OptimizationConfig(**OPT), i, EXTENT)[k]
                  for i in range(steps)) for k in POST_FIELDS}
    for ci, d in enumerate(dirs):
        assert_leaves_close(
            tdhier.load_dhier(os.path.join(tdir, d, "hierarchy.dhier_opt")),
            jdhier.load_dhier(os.path.join(jdir, d, "hierarchy.dhier_opt")),
            atol)
        jt, tt = replay_chunk(ci, scaffold, steps)
        assert_step_close(tt, jt, lrs, steps=steps)
        rows, seg_j = kd_leaf_rows(jt.gaussians)
        rows_t, seg_t = kd_leaf_rows(tt.gaussians)
        np.testing.assert_array_equal(rows_t, rows)
        assert (seg_t == seg_j).all(), (d, rows[seg_t != seg_j])


def test_train_step_on_a_chunk_state_matches_jax_xla(zero_iter_runs):
    """One flat step on chunk (0, 0)'s scaffold-conditioned state (skybox
    rows, isotropic kNN rows): the port's Adam moments match the JAX
    package's xla path to 1e-4 of the largest. The JAX pallas path's xyz
    and log-scale moments drift from its own xla path on this state (its
    colour and opacity moments agree), which is why the run_pipeline tests
    above hold the port to the xla path."""
    from hlod_gaussians_tpu.train import flat as jflat
    from hlod_gaussians_torch.train import flat
    j0, t0 = replay_chunk(0, zero_iter_runs[4], 0)
    (_, jv), (_, tv) = scene_pair()
    kw = dict(exposure_idx=0, scene_extent=EXTENT, width=W, height=H,
              k_max=256, sh_degree=1, skybox_locked=True)
    jm = {}
    for be in ("xla", "pallas"):
        js = jax.tree_util.tree_map(jnp.array, j0.gaussians)  # donated
        v = jv[0]
        jn, _ = jflat.train_step(
            jflat.init_flat_train(js), v.world_view, v.full_proj, v.campos,
            v.tan_fovx, v.tan_fovy, v.image, jnp.zeros(3), opt=JOpt(**OPT),
            cfg=dataclasses.replace(JCFG, backend=be), **kw)
        jm[be] = {k: np.asarray(m) for k, m in jn.adam.m.items()}
    v = tv[0]
    tn, _ = flat.train_step(
        flat.init_flat_train(t0.gaussians), v.world_view, v.full_proj,
        v.campos, v.tan_fovx, v.tan_fovy, v.image, torch.zeros(3),
        opt=OptimizationConfig(**OPT), cfg=CFG, **kw)

    def scaled(a, b):
        return np.abs(a - b).max() / (np.abs(b).max() + 1e-30)
    for k in ("xyz", "log_scale", "f_dc", "opacity_logit"):
        assert scaled(tn.adam.m[k].numpy(), jm["xla"][k]) < 1e-4, k
    assert scaled(jm["pallas"]["f_dc"], jm["xla"]["f_dc"]) < 1e-4
    assert scaled(jm["pallas"]["log_scale"], jm["xla"]["log_scale"]) > 0.1


def test_train_flat_scene_matches_jax():
    """Six steps with a densify at step 2 and an opacity reset at step 3,
    from one initial state (anisotropic, rotated rows): the states within
    the step tolerance (the densified rows and node table exact) and the
    log lines equal."""
    from hlod_gaussians_tpu.models import gaussians as jgm
    (_, jv), (_, tv) = scene_pair()
    jv, tv = jv[:2], tv[:2]
    pts = np.asarray(scene_pair()[1][0].points)[:24]
    cols = np.full_like(pts, 0.5)
    j0 = jgm.create_from_points(pts, cols, capacity=128, sh_degree=1,
                                n_exposures=8, scene_radius=EXTENT,
                                opacity_init=0.5)
    # anisotropic, rotated rows: an isotropic row's rotation gradient is
    # rounding noise (test_torch_post.py's note)
    rng = np.random.default_rng(4)
    j0 = dataclasses.replace(
        j0, log_scale=j0.log_scale + jnp.asarray(
            rng.normal(size=(128, 3)).astype(np.float32) * 0.4),
        quat=jnp.asarray(rng.normal(size=(128, 4)).astype(np.float32)))
    t0 = convert.state_from_numpy(leaves(j0)["gaussians"], n_skybox=0,
                                  device=CPU)
    pk = dict(k_max=256, mh_walk=False, densify_from_iter=0,
              densification_interval=2, opacity_reset_interval=3)
    ok = dict(iterations=50, densify_until_iter=10,
              densify_grad_threshold=1e-7)
    logs = {}
    for name in ("jax", "torch"):
        logs[name] = []

        class Log:
            def log(self, **kv):
                logs[name].append(kv)
        if name == "jax":
            jt = jfull.train_flat_scene(
                jv, pts, cols, EXTENT, 6, 128, opt=JOpt(**ok), cfg=JCFG,
                pcfg=jfull.PipelineConfig(**pk), sh_degree=1,
                initial_state=j0, logger=Log())
        else:
            tt = full_train.train_flat_scene(
                tv, pts, cols, EXTENT, 6, 128,
                opt=OptimizationConfig(**ok), cfg=CFG,
                pcfg=full_train.PipelineConfig(**pk), sh_degree=1,
                initial_state=t0, logger=Log(), device=CPU)
    assert int(tt.gaussians.alive.sum()) > len(pts)       # densified
    lrs = {k: max(optim.param_lrs(OptimizationConfig(**ok), i, EXTENT)[k]
                  for i in range(6)) for k in POST_FIELDS}
    assert_step_close(tt, jt, lrs, steps=6)
    assert [(r["stage"], r["it"], r["n_alive"]) for r in logs["torch"]] == \
        [(r["stage"], r["it"], r["n_alive"]) for r in logs["jax"]]
    np.testing.assert_allclose([r["loss"] for r in logs["torch"]],
                               [r["loss"] for r in logs["jax"]], rtol=1e-5)


def test_train_coarse_scaffold_matches_jax():
    """Four coarse steps with JAX's background draws (PRNGKey(seed + 7),
    one split a step) replayed through ``bgs``: the states within the step
    tolerance; the port's own draws come from its generator."""
    from hlod_gaussians_tpu.train import coarse as jcoarse
    from hlod_gaussians_torch.train import coarse
    (js, jv), (ts, tv) = scene_pair()
    pcfg = dict(k_max=256, mh_walk=True, seed=3)
    key = jax.random.PRNGKey(pcfg["seed"] + 7)
    bgs = []
    for _ in range(4):
        key, sub = jax.random.split(key)
        bgs.append(np.array(jax.random.uniform(sub, (3,))))
    with knn_keeps_axis_max():
        jt = jfull.train_coarse_scaffold(
            jv, js.points, js.colors, EXTENT, 4, 128, opt=JOpt(**OPT),
            cfg=JCFG, pcfg=jfull.PipelineConfig(**pcfg), skybox_num=4)
    tt = full_train.train_coarse_scaffold(
        tv, ts.points, ts.colors, EXTENT, 4, 128,
        opt=OptimizationConfig(**OPT), cfg=CFG,
        pcfg=full_train.PipelineConfig(**pcfg), skybox_num=4, bgs=bgs,
        device=CPU)
    copt = coarse.coarse_opt_config(OptimizationConfig(**OPT))
    lrs = {k: max(optim.param_lrs(copt, i, EXTENT)[k] for i in range(4))
           for k in POST_FIELDS}
    # the kNN log-scales of the fresh rows start within 1e-5
    # (test_torch_scaffold.py), so they are held to that plus the steps
    ls_t = tt.gaussians.log_scale.numpy()
    np.testing.assert_allclose(ls_t, np.asarray(jt.gaussians.log_scale),
                               rtol=0, atol=1e-5 + 8 * lrs["log_scale"])
    tt = dataclasses.replace(tt, gaussians=dataclasses.replace(
        tt.gaussians, log_scale=torch.as_tensor(np.asarray(
            jt.gaussians.log_scale))))
    assert_step_close(tt, jt, lrs, steps=4)
    assert jcoarse.coarse_opt_config(JOpt(**OPT)).position_lr_init == 0.0
    # without bgs the draws come from the port's generator: reproducible
    a = full_train.train_coarse_scaffold(
        tv, ts.points, ts.colors, EXTENT, 2, 128, cfg=CFG,
        pcfg=full_train.PipelineConfig(**pcfg), skybox_num=4, device=CPU)
    b = full_train.train_coarse_scaffold(
        tv, ts.points, ts.colors, EXTENT, 2, 128, cfg=CFG,
        pcfg=full_train.PipelineConfig(**pcfg), skybox_num=4, device=CPU)
    assert torch.equal(a.gaussians.f_dc, b.gaussians.f_dc)


def port_run(scene, out, scaffold, **kw):
    _, tp = pcfgs()
    return full_train.run_pipeline(
        scene, view_loader=lambda ci: ci.v, output_dir=out, pcfg=tp,
        opt=OptimizationConfig(**OPT), post=PostConfig(**POST), cfg=CFG,
        mcfg=ModelConfig(sh_degree=1, scaffold_file=scaffold), device=CPU,
        **kw)


def test_run_pipeline_resume_and_keep_running(tmp_path, zero_iter_runs,
                                              monkeypatch):
    """skip_if_exists over a finished run leaves every chunk artifact
    untouched and writes a byte-equal merge; keep_running logs a chunk made
    to fail and merges the others; without it the failure raises."""
    import shutil
    _, tm, _, tdir, scaffold = zero_iter_runs
    _, (ts, _) = scene_pair()
    out = str(tmp_path / "resume")
    shutil.copytree(tdir, out)
    arts = [os.path.join(out, d, f) for d in chunk_dirs(out)
            for f in ("hierarchy.dhier_opt", "center.txt", "extent.txt",
                      "anchors.bin")]
    mtimes = {f: os.stat(f).st_mtime_ns for f in arts}
    with open(os.path.join(out, "merged.dhier"), "rb") as f:
        first = f.read()
    os.remove(os.path.join(out, "merged.dhier"))
    again = port_run(ts, out, scaffold, skip_if_exists=True)
    assert {f: os.stat(f).st_mtime_ns for f in arts} == mtimes
    with open(os.path.join(out, "merged.dhier"), "rb") as f:
        assert f.read() == first
    np.testing.assert_array_equal(again.nodes, tm.nodes)

    train = full_train.train_flat_scene

    def failing(*a, stage="chunk", **kw):
        if stage == "chunk(0, 0)":
            raise RuntimeError("made to fail")
        return train(*a, stage=stage, **kw)
    monkeypatch.setattr(full_train, "train_flat_scene", failing)
    with pytest.raises(RuntimeError, match="made to fail"):
        port_run(ts, str(tmp_path / "stop"), scaffold)
    log = tmp_path / "metrics.jsonl"
    logger = MetricsLogger(str(log))
    out = str(tmp_path / "keep")
    m = port_run(ts, out, scaffold, keep_running=True, logger=logger)
    logger.close()
    assert chunk_dirs(out) == ["chunk_1_0"]
    one = tdhier.load_dhier(os.path.join(out, "chunk_1_0",
                                         "hierarchy.dhier_opt"))
    assert m.nodes.shape[0] == 1 + one.nodes.shape[0]
    errors = [r for r in map(__import__("json").loads,
                             log.read_text().splitlines()) if "error" in r]
    assert errors == [dict(errors[0], stage="chunk(0, 0)", error=1,
                           message="RuntimeError: made to fail")]


def test_run_pipeline_no_chunks_pretrained_matches_jax(tmp_path,
                                                      monkeypatch):
    """run_pipeline_no_chunks from a saved 3DGS PLY (mcfg.pretrained):
    anisotropic rotated points, two post steps; the node table equal, every
    node's position and SH and every leaf within the step tolerance, the
    post stage rerun with its recorded views and settings held node for
    node to the train step's tolerance (assert_post_replays), and the
    .dhier_opt written."""
    from hlod_gaussians_torch.data import ply
    calls = record_post(monkeypatch)
    (js, _), (ts, _) = scene_pair()
    rng = np.random.default_rng(6)
    n = 40
    g = jply.GaussianPly(
        xyz=(js.points[:n] + rng.normal(size=(n, 3)) * 0.05
             ).astype(np.float32),
        f_dc=rng.normal(size=(n, 1, 3)).astype(np.float32),
        f_rest=rng.normal(size=(n, 3, 3)).astype(np.float32) * 0.1,
        opacity=rng.normal(size=(n,)).astype(np.float32),
        log_scale=(rng.normal(size=(n, 3)) * 0.3 - 2.5).astype(np.float32),
        quat=rng.normal(size=(n, 4)).astype(np.float32))
    path = str(tmp_path / "pre.ply")
    jply.save_gaussian_ply(path, g)
    spec = dict(post_iters=2, skybox_num=4, coarse_capacity=64,
                chunk_capacity=128, k_max=256, mh_walk=True,
                post_densify_interval=1000)
    jo = jfull.run_pipeline_no_chunks(
        js, view_loader=lambda ci: ci.v, output_dir=str(tmp_path / "j"),
        pcfg=jfull.PipelineConfig(**spec), opt=JOpt(**OPT),
        post=JPost(**POST), cfg=JCFG,
        mcfg=JModel(sh_degree=1, pretrained=path))
    to = full_train.run_pipeline_no_chunks(
        ts, view_loader=lambda ci: ci.v, output_dir=str(tmp_path / "t"),
        pcfg=full_train.PipelineConfig(**spec),
        opt=OptimizationConfig(**OPT), post=PostConfig(**POST), cfg=CFG,
        mcfg=ModelConfig(sh_degree=1, pretrained=path), device=CPU)
    assert to.nodes.shape[0] == 2 * n - 1
    assert_post_replays(calls)
    atol = step_atol(2)
    assert_leaves_close(to, jo, atol)
    np.testing.assert_allclose(to.pos, jo.pos, rtol=0, atol=atol["pos"])
    np.testing.assert_allclose(to.shs, jo.shs, rtol=0, atol=atol["shs"])
    back = tdhier.load_dhier(str(tmp_path / "t" / "hierarchy.dhier_opt"))
    np.testing.assert_array_equal(back.nodes, to.nodes)
    assert ply.load_gaussian_ply(path).xyz.shape == (n, 3)
