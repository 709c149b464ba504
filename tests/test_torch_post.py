"""Port parity for hierarchy post-optimization: one `post_train_step`
against the JAX package's (pallas backend, Pallas kernels in interpret
mode, 64x64) with antialiasing on and off, the MCMC regularizers and the
exploration noise (JAX's normal draw injected as `eps`), over a state with
a skybox whose geometry gradients are zeroed; `densify_round` with JAX's
host draws injected; `state_to_dhier`, `rebuild_spt`, `sort_morton`,
`occlusion_cull` (the plain scan path on both sides of the CPU),
`view_schedule`; checkpoints written by each package and read by the other;
`post_optimize` for 6 iterations against the JAX loop; and a port-only
`post_optimize` through two MCMC rounds.

Tolerances are the train step's (test_torch_train.py): Adam moments (m =
0.1 g from zero moments) to atol 1e-4 after scaling by the largest JAX
magnitude; parameters to atol 1e-6 where |g| > 1e-3 max|g|, else within
2 lr a step (Adam's normalized step may flip sign on a near-zero gradient).
Tree surgery, permutations, masks and files match exactly; relocated
parameters as in test_torch_mcmc.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hlod_gaussians_tpu import optim as joptim
from hlod_gaussians_tpu.config import OptimizationConfig as JOpt
from hlod_gaussians_tpu.config import PostConfig as JPost
from hlod_gaussians_tpu.config import RasterizerConfig as JConfig
from hlod_gaussians_tpu.data import dhier as jdhier
from hlod_gaussians_tpu.hierarchy import spt as jspt
from hlod_gaussians_tpu.models import reorder as jreorder
from hlod_gaussians_tpu.pipeline import full_train as jfull
from hlod_gaussians_tpu.train import flat as jflat
from hlod_gaussians_tpu.train import post as jpost
from hlod_gaussians_tpu.utils import camera as jcam
from hlod_gaussians_tpu.utils import checkpoint as jckpt
from hlod_gaussians_tpu.utils import scheduler as jsched
from hlod_gaussians_torch import convert, optim, render
from hlod_gaussians_torch.config import (OptimizationConfig, PostConfig,
                                         RasterizerConfig)
from hlod_gaussians_torch.data import dhier as tdhier
from hlod_gaussians_torch.hierarchy import build as tbuild
from hlod_gaussians_torch.hierarchy import spt
from hlod_gaussians_torch.models import gaussians as gm
from hlod_gaussians_torch.models import reorder
from hlod_gaussians_torch.ops import rasterize_cuda
from hlod_gaussians_torch.pipeline import full_train
from hlod_gaussians_torch.train import post
from hlod_gaussians_torch.utils import checkpoint, scheduler
from hlod_gaussians_torch.utils.camera import make_camera
from tests.test_mcmc import check_invariants
from tests.test_torch_mcmc import assert_matches, leaves, recorded_draws

CPU = torch.device("cpu")
W = H = 64
SKY = 8
CAP = 256
EXTENT = 2.0
JCFG = JConfig(backend="pallas", tile_w=16, tile_h=16, max_dup=4096)
CFG = RasterizerConfig(backend="pallas", tile_w=16, tile_h=16, max_dup=4096)
# an SPT cut that forms real SPTs on the 129-node test tree
SPT_KW = dict(spt_root_volume=5e-3, min_spt_size=4,
              spt_target_granularity=0.05)
POST_FIELDS = ("xyz", "f_dc", "f_rest", "log_scale", "quat",
               "opacity_logit", "exposure")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: PyTorch's intra-op threads only contend with the
    other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dhier_pair(n=65, seed=0):
    """test_train_post.build_dhier's tree (SH 1) with anisotropic, rotated
    leaves (so rotations get real gradients) as the (JAX, port) DHier,
    built by the port's builder."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.6
    pts[:, 2] += 4.0
    scales = (0.06 * np.exp(rng.normal(size=(n, 3)) * 0.4)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    ops = rng.uniform(0.5, 0.95, n).astype(np.float32)
    shs = (rng.random((n, 4, 3)).astype(np.float32) - 0.5)
    h = tbuild.build_hierarchy(pts, scales, quats, ops, shs, device=CPU)
    fields = dict(
        sh_degree=1, pos=h.pos, quat=h.quat,
        log_scale=np.log(np.maximum(h.scale, 1e-9)).astype(np.float32),
        opacity=np.clip(h.opacity, 0.01, 0.99).astype(np.float32),
        shs=h.sh.astype(np.float32), nodes=h.nodes)
    return jdhier.DHier(**fields), tdhier.DHier(**fields)


def jax_state(d, cap=CAP, skybox=SKY):
    return jpost.create_from_dhier(d, capacity=cap, skybox_num=skybox,
                                   scene_radius=EXTENT, n_exposures=8)


def to_torch(jts):
    """A JAX PostTrainState (or GaussianState) as the port's."""
    if isinstance(jts, jpost.PostTrainState):
        arrays = leaves(jts.gaussians, jts.adam)
        arrays["step"] = int(jts.step)
        g = jts.gaussians
    else:
        arrays, g = leaves(jts), jts
    return convert.post_state_from_numpy(arrays, n_skybox=g.n_skybox,
                                         device=CPU)


def cameras(n=3):
    """(JAX, port) cameras at the origin, yawing 0.1 rad a view."""
    out = []
    for i in range(n):
        a = 0.1 * i
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]], np.float32)
        out.append((R, np.zeros(3, np.float32)))
    return out


def _scaled_close(got, ref, atol, err_msg):
    ref = np.asarray(ref)
    scale = np.abs(ref).max() + 1e-12
    np.testing.assert_allclose(np.asarray(got) / scale, ref / scale,
                               atol=atol, err_msg=err_msg)


def assert_step_close(tts, jts, lrs, steps=1):
    """The train step's tolerances over `steps` steps."""
    for k in POST_FIELDS:
        got = getattr(tts.gaussians, k).numpy()
        ref = np.asarray(getattr(jts.gaussians, k))
        gabs = np.abs(np.asarray(jts.adam.m[k]))
        big = gabs > 1e-3 * gabs.max()
        diff = np.abs(got - ref)
        assert diff[big].max(initial=0.0) <= 1e-6 * steps, k
        assert diff.max(initial=0.0) <= 2 * steps * lrs[k] + 1e-6, k
    for k in ("alive", "nodes"):
        np.testing.assert_array_equal(getattr(tts.gaussians, k).numpy(),
                                      np.asarray(getattr(jts.gaussians, k)))
    assert tts.step == int(jts.step) == tts.adam.step == int(jts.adam.step)


@pytest.fixture(scope="module")
def scene():
    """The tree, its forest and cut at camera 0, and a target image."""
    jd, td = dhier_pair()
    jst = jax_state(jd)
    forest = jpost.rebuild_spt(jst, post=JPost(**SPT_KW))
    (R, t), = cameras(1)
    jc = jcam.make_camera(R, t, 0.9, 0.9, W, H)
    cut = jspt.spt_cut(forest, jnp.zeros(CAP), jc.campos, jc.full_proj,
                       use_frustum=False)
    mask = np.array(cut.gaussian_mask)
    assert forest.n_spts > 0
    assert 0 < mask.sum() < np.asarray(jst.alive).sum() - SKY
    gt = np.random.default_rng(2).uniform(0, 1, (3, H, W)).astype(np.float32)
    return dict(jd=jd, td=td, mask=mask, gt=gt, R=R, t=t)


STEP_CASES = {
    "aa_on": dict(post=dict(SPT_KW), aa=True),
    "aa_off": dict(post=dict(SPT_KW), aa=False),
    "regularizers": dict(post=dict(SPT_KW, lambda_opacity=0.3,
                                   lambda_scaling=0.2), aa=True),
    "noise": dict(post=dict(SPT_KW, mcmc_noise_lr=5e5), aa=True),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_post_train_step_matches_jax(scene, case):
    spec = STEP_CASES[case]
    jst = jax_state(scene["jd"])
    pert = dict(f_dc=jst.f_dc + 0.3)
    if case == "noise":
        # low opacity everywhere but the skybox: the noise gate is open
        pert["opacity_logit"] = jnp.where(
            (jnp.arange(CAP) >= SKY)[:, None], -3.0, jst.opacity_logit)
    jts = jpost.init_post_train(dataclasses.replace(jst, **pert))
    tts = to_torch(jts)           # before the JAX step, which donates jts
    f_dc_in = tts.gaussians.f_dc.clone()
    jc = jcam.make_camera(scene["R"], scene["t"], 0.9, 0.9, W, H)
    tc = make_camera(scene["R"], scene["t"], 0.9, 0.9, W, H, device=CPU)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    eps = None
    if case == "noise":
        eps = np.array(jax.random.normal(
            jax.random.fold_in(jax.random.PRNGKey(0), 0), (CAP, 3)))
    # antialiasing on is the default: the call then has post_optimize's
    # form, and its loop test reuses this compiled step
    kw = dict(width=W, height=H, k_max=1024, sh_degree=1)
    if not spec["aa"]:
        kw["antialiasing"] = False

    jnew, jaux = jpost.post_train_step(
        jts, jnp.asarray(scene["mask"]), jc.world_view, jc.full_proj,
        jc.campos, jc.tan_fovx, jc.tan_fovy, jnp.asarray(scene["gt"]),
        jnp.asarray(bg), EXTENT, opt=JOpt(), post=JPost(**spec["post"]),
        cfg=JCFG, **kw)
    launches = (rasterize_cuda.blend_forward.launches,
                rasterize_cuda.blend_backward.launches)
    tnew, taux = post.post_train_step(
        tts, torch.as_tensor(scene["mask"]), tc.world_view, tc.full_proj,
        tc.campos, tc.tan_fovx, tc.tan_fovy, torch.as_tensor(scene["gt"]),
        torch.as_tensor(bg), EXTENT, opt=OptimizationConfig(),
        post=PostConfig(**spec["post"]), cfg=CFG,
        eps=None if eps is None else torch.as_tensor(eps), **kw)
    # CPU tensors: the plain versions, never a kernel launch
    assert launches == (rasterize_cuda.blend_forward.launches,
                        rasterize_cuda.blend_backward.launches)

    np.testing.assert_allclose(float(taux.loss), float(jaux.loss), rtol=1e-5)
    np.testing.assert_allclose(float(taux.l1), float(jaux.l1), rtol=1e-5)
    assert int(taux.n_rendered) == int(jaux.n_rendered) > 0
    assert not bool(taux.truncated) and not bool(jaux.truncated)
    for k in jnew.adam.m:
        _scaled_close(tnew.adam.m[k].numpy(), jnew.adam.m[k], 1e-4, f"m {k}")
        _scaled_close(tnew.adam.v[k].numpy(), jnew.adam.v[k], 1e-4, f"v {k}")
    lrs = optim.param_lrs(OptimizationConfig(), 0, EXTENT)
    assert_step_close(tnew, jnew, lrs)
    # the skybox trains colour, not geometry
    for k in ("xyz", "quat", "log_scale"):
        assert not tnew.adam.m[k][:SKY].any() and not np.asarray(
            jnew.adam.m[k])[:SKY].any(), k
    if case == "noise":
        # the noise moved rows beyond what Adam's step alone does
        moved = (tnew.gaussians.xyz - tts.gaussians.xyz).abs().max()
        assert float(moved) > 10 * lrs["xyz"]
    # the input state is left as it was
    assert torch.equal(tts.gaussians.f_dc, f_dc_in)


def test_densify_round_matches_jax(scene):
    """add_new_gs toward max_cap, then relocate_gs of dead leaves, with the
    JAX package's draws (test_train_post.test_densify_round's setup plus
    four dead leaves)."""
    jst = jax_state(scene["jd"], cap=1024, skybox=0)
    nodes = np.asarray(jst.nodes)
    leaf = np.where((nodes[:, gm.NODE_CHILD_COUNT] == 0)
                    & np.asarray(jst.alive))[0]
    logit = np.array(jst.opacity_logit)
    logit[leaf[::9][:4]] = -7.0
    jts = jpost.init_post_train(dataclasses.replace(
        jst, opacity_logit=jnp.asarray(logit)))
    tts = to_torch(jts)
    post_cfg = dict(max_cap=800, grow_fraction=0.2)
    with recorded_draws() as draws:
        jnew, jstats = jpost.densify_round(jts, jax.random.PRNGKey(0),
                                           post=JPost(**post_cfg),
                                           budget=256)
        jax.block_until_ready(jstats["size"])
    assert len(draws) == 2
    tnew, tstats = post.densify_round(
        tts, post=PostConfig(**post_cfg), budget=256,
        sampled=tuple(torch.tensor(s) for s in draws))
    assert {k: int(v) for k, v in tstats.items()} == \
        {k: int(v) for k, v in jstats.items()}
    assert int(tstats["n_added_pairs"]) > 0 and int(tstats["n_relocated"]) > 0
    assert_matches(tnew.gaussians, tnew.adam, jnew.gaussians, jnew.adam)
    check_invariants(tnew.gaussians)


def test_densify_round_without_mcmc_is_a_noop():
    """Without the MCMC flag the reference densifies nothing."""
    jst = jax_state(dhier_pair(n=9)[0], cap=64, skybox=0)
    tts = to_torch(jpost.init_post_train(jst))
    new, stats = post.densify_round(
        tts, post=PostConfig(mcmc_densification=False))
    assert new is tts and int(stats["size"]) == int(jst.alive.sum())
    assert stats["n_added_pairs"] == stats["n_relocated"] == 0


def test_state_to_dhier_and_rebuild_spt_match_jax(scene):
    jst = jax_state(scene["jd"])
    tst = to_torch(jst).gaussians
    jd2, td2 = jpost.state_to_dhier(jst), post.state_to_dhier(tst)
    for k in td2._fields:
        np.testing.assert_array_equal(np.asarray(getattr(td2, k)),
                                      np.asarray(getattr(jd2, k)), err_msg=k)
    jf = jpost.rebuild_spt(jst, post=JPost(**SPT_KW))
    tf = post.rebuild_spt(tst, post=PostConfig(**SPT_KW))
    assert tf.n_spts == jf.n_spts > 0
    for k in spt.SPTForest._fields:
        np.testing.assert_array_equal(getattr(tf, k).numpy(),
                                      np.asarray(getattr(jf, k)), err_msg=k)


def test_sort_morton_matches_jax(scene):
    """A state with a skybox, holes (dead rows between live ones) and
    seeded Adam moments: the permutation, the remapped node table and the
    permuted Adam rows equal."""
    jst = jax_state(scene["jd"])
    alive = np.array(jst.alive)
    alive[SKY + 40:SKY + 44] = False
    rng = np.random.default_rng(3)
    xyz = np.array(jst.xyz)
    xyz[~alive] = rng.normal(size=((~alive).sum(), 3))   # dead rows count
    jst = dataclasses.replace(jst, alive=jnp.asarray(alive),
                              xyz=jnp.asarray(xyz))
    jadam = joptim.init_adam(jst.params())
    jadam = jadam._replace(m={k: jnp.asarray(rng.normal(size=v.shape)
                                             .astype(np.float32))
                              for k, v in jadam.m.items()})
    tts = to_torch(jpost.PostTrainState(gaussians=jst, adam=jadam,
                                        step=jnp.int32(0)))
    js2, ja2 = jreorder.sort_morton(jst, jadam)
    ts2, ta2 = reorder.sort_morton(tts.gaussians, tts.adam)
    for k in ("xyz", "alive", "nodes", "f_dc", "opacity_logit"):
        np.testing.assert_array_equal(getattr(ts2, k).numpy(),
                                      np.asarray(getattr(js2, k)), err_msg=k)
    for k, ref in ja2.m.items():
        np.testing.assert_array_equal(ta2.m[k].numpy(), np.asarray(ref),
                                      err_msg=k)
    # skybox first, then the live rows, then the dead ones
    assert torch.equal(ts2.xyz[:SKY], tts.gaussians.xyz[:SKY])
    a = ts2.alive.numpy()
    n_live = int(a.sum())
    assert a[:n_live].all() and not a[n_live:].any()


def test_occlusion_cull_matches_jax(scene):
    jst = jax_state(scene["jd"])
    tst = to_torch(jst).gaussians
    jc = jcam.make_camera(scene["R"], scene["t"], 0.9, 0.9, W, H)
    tc = make_camera(scene["R"], scene["t"], 0.9, 0.9, W, H, device=CPU)
    cand = scene["mask"] | (np.arange(CAP) < SKY)
    ref = np.asarray(jreorder.occlusion_cull(
        jst, jnp.asarray(cand), jc.world_view, jc.full_proj, jc.campos,
        jc.tan_fovx, jc.tan_fovy))
    got = reorder.occlusion_cull(tst, torch.as_tensor(cand), tc.world_view,
                                 tc.full_proj, tc.campos, tc.tan_fovx,
                                 tc.tan_fovy).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < cand.sum()


@pytest.mark.parametrize("walk", [True, False], ids=["mh_walk", "epochs"])
def test_view_schedule_matches_jax(walk):
    centers = np.random.default_rng(5).normal(size=(12, 3))
    for seed in (0, 1, 7):
        np.testing.assert_array_equal(
            scheduler.view_schedule(centers, 12, 50, seed=seed, walk=walk),
            jsched.view_schedule(centers, 12, 50, seed=seed, walk=walk))


@pytest.mark.parametrize("kind", ["post", "flat"])
def test_checkpoints_cross_read(scene, tmp_path, kind):
    """Each package reads the other's .npz: every array equal, the step
    counters and the state kind kept."""
    jst = jax_state(scene["jd"])
    rng = np.random.default_rng(4)
    if kind == "post":
        jts = dataclasses.replace(jpost.init_post_train(jst),
                                  step=jnp.int32(7))
        tts = to_torch(jts)
    else:
        jts = dataclasses.replace(
            jflat.init_flat_train(jst), step=jnp.int32(3),
            denom=jnp.asarray(rng.integers(0, 5, CAP).astype(np.int32)),
            max_radii=jnp.asarray(rng.uniform(0, 4, CAP).astype(np.float32)))
        arrays = leaves(jst)
        arrays.update(step=3, xyz_grad_accum=np.asarray(jts.xyz_grad_accum),
                      denom=np.asarray(jts.denom),
                      max_radii=np.asarray(jts.max_radii))
        tts = convert.train_state_from_numpy(arrays, n_skybox=SKY,
                                             device=CPU)
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    jckpt.save_checkpoint(jpath, jts)
    checkpoint.save_checkpoint(tpath, tts)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    got = checkpoint.load_checkpoint(jpath, device=CPU)
    ref = jckpt.load_checkpoint(tpath)
    assert type(got).__name__ == type(ref).__name__ == type(jts).__name__
    assert got.step == int(ref.step) and got.gaussians.n_skybox == SKY
    for k in POST_FIELDS + ("alive", "nodes"):
        np.testing.assert_array_equal(getattr(got.gaussians, k).numpy(),
                                      np.asarray(getattr(ref.gaussians, k)))


def _views(scene, n=3):
    """(JAX, port) views: each camera's target the clean render of the
    tree (port, plain path) on CPU."""
    tst = to_torch(jax_state(scene["jd"])).gaussians
    act = gm.activate(tst)
    jviews, tviews = [], []
    for R, t in cameras(n):
        tc = make_camera(R, t, 0.9, 0.9, W, H, device=CPU)
        with torch.no_grad():
            gt = render.render_arrays(
                act.means3d, act.scales, act.quats, act.opacities, act.shs,
                act.valid, tc.world_view, tc.full_proj, tc.campos,
                tc.tan_fovx, tc.tan_fovy, torch.zeros(3), sh_degree=1,
                width=W, height=H, cfg=CFG).image.numpy()
        jviews.append(jcam.make_camera(R, t, 0.9, 0.9, W, H, image=gt))
        tviews.append(make_camera(R, t, 0.9, 0.9, W, H, image=gt,
                                  device=CPU))
    return jviews, tviews


def test_post_optimize_matches_jax(scene):
    """Six iterations of the loop, the densify interval past the end: the
    final state within the train step's tolerances of the JAX loop's."""
    jviews, tviews = _views(scene)
    pkw = dict(post_densify_interval=100, k_max=1024)
    jts = jfull.post_optimize(
        scene["jd"], jviews, EXTENT, 6, CAP, post=JPost(**SPT_KW),
        cfg=JCFG, pcfg=jfull.PipelineConfig(**pkw), skybox_num=SKY)
    steps = []

    class Log:
        def log(self, **kv):
            steps.append(kv)

    tts = full_train.post_optimize(
        scene["td"], tviews, EXTENT, 6, CAP, post=PostConfig(**SPT_KW),
        cfg=CFG, pcfg=full_train.PipelineConfig(**pkw), skybox_num=SKY,
        logger=Log(), log_every=1, device=CPU)
    assert [s["it"] for s in steps] == list(range(6))
    assert all(s["stage"] == "post" and not s["truncated"] for s in steps)
    assert all(0 < s["n_cut"] < CAP for s in steps)
    lrs = {k: max(optim.param_lrs(OptimizationConfig(), i, EXTENT)[k]
                  for i in range(6)) for k in POST_FIELDS}
    assert_step_close(tts, jts, lrs, steps=6)


def test_post_optimize_mcmc_rounds_keep_the_tree():
    """25 iterations on one view with a densify interval of 10: two MCMC
    rounds (growth and relocation of the dead leaves), each followed by an
    SPT rebuild; the tree keeps its invariants and the loss falls. (The
    growth adds no pair on a tree this small: 4,096 draws over 65 leaves
    sample no host exactly once.)"""
    jd, td = dhier_pair()
    op = td.opacity.copy()
    leaf = np.where(td.nodes[:, gm.NODE_CHILD_COUNT] == 0)[0]
    op[leaf[::7]] = 0.001                         # dead leaves to relocate
    td = td._replace(opacity=op)
    scene = dict(jd=jd)
    _, tviews = _views(scene, n=1)
    records = []

    class Log:
        def log(self, **kv):
            records.append(kv)

    pert = td._replace(shs=td.shs + np.float32(0.3))
    tts = full_train.post_optimize(
        pert, tviews, EXTENT, 25, 400, post=PostConfig(**SPT_KW), cfg=CFG,
        pcfg=full_train.PipelineConfig(post_densify_interval=10),
        logger=Log(), log_every=1, device=CPU)
    rounds = [r for r in records if r["stage"] == "post_densify"]
    losses = [r["loss"] for r in records if r["stage"] == "post"]
    assert len(losses) == 25
    assert [r["it"] for r in rounds] == [10, 20]
    assert rounds[0]["n_relocated"] > 0
    assert all(r["densify_s"] >= 0 and r["rebuild_s"] >= 0 for r in rounds)
    check_invariants(tts.gaussians)
    assert int(tts.gaussians.alive.sum()) == rounds[-1]["size"]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < 0.97 * np.mean(losses[:3]), losses


def test_metrics_match_jax(tmp_path):
    """MetricsLogger writes the JAX package's JSONL lines; a span records
    one host event under the profiler and none without it; the counters
    add up."""
    from hlod_gaussians_tpu.utils import metrics as jmetrics
    from hlod_gaussians_torch.utils import metrics
    lines = []
    for mod, name in ((metrics, "torch"), (jmetrics, "jax")):
        path = tmp_path / name / "m.jsonl"
        log = mod.MetricsLogger(str(path))
        log.log(stage="post", it=3, loss=np.float32(0.25), ts=1.0)
        log.log(stage="post_densify", it=10, n_relocated=4096, ts=2.0)
        log.close()
        lines.append(path.read_text())
    assert lines[0] == lines[1] and lines[0].count("\n") == 2
    from torch.profiler import ProfilerActivity, profile
    with metrics.span("hlod.untraced"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with metrics.span("hlod.cut"):
                pass
    names = [e.name for e in prof.events() if e.name.startswith("hlod.")]
    assert names == ["hlod.cut"] * 3
    before = metrics.counters["test.rows"]
    metrics.counters["test.rows"] += 5
    metrics.counters["test.rows"] += 2
    assert metrics.counters["test.rows"] - before == 7
