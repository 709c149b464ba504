"""Port parity for the evaluation harness and the viewer's maintenance:
gmsd and eval_views (tau sweep on the box metric, and the dynamic-limit
sweep) against the JAX package (PSNR and SSIM within 1e-4, gmsd within
1e-5, mean_rendered exact); incremental_cut_step masks and counts over ten
steps of a moving camera, ActiveRowCache transfers and BudgetController
targets, exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hlod_gaussians_tpu import eval as jeval
from hlod_gaussians_tpu import render as jrender
from hlod_gaussians_tpu.config import RasterizerConfig as JConfig
from hlod_gaussians_tpu.data import dhier as jdhier
from hlod_gaussians_tpu.models import gaussians as jgm
from hlod_gaussians_tpu.ops import perceptual as jperceptual
from hlod_gaussians_tpu.train import post as jpost
from hlod_gaussians_tpu.utils.camera import make_camera as jmake_camera
from hlod_gaussians_tpu.viewer import maintenance as jmaint
from hlod_gaussians_torch import eval as teval
from hlod_gaussians_torch.config import RasterizerConfig
from hlod_gaussians_torch.data import dhier as tdhier
from hlod_gaussians_torch.hierarchy import build as tbuild
from hlod_gaussians_torch.hierarchy import cut as tcut
from hlod_gaussians_torch.models.gaussians import NODE_CHILD_COUNT
from hlod_gaussians_torch.ops import perceptual as tperceptual
from hlod_gaussians_torch.train import post as tpost
from hlod_gaussians_torch.utils.camera import make_camera
from hlod_gaussians_torch.viewer import maintenance as tmaint

CPU = torch.device("cpu")
W, H = 64, 48


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: PyTorch's intra-op threads only contend with the
    other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hierarchy(n=64, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.6
    pts[:, 2] += 5.0
    sc = np.exp(rng.uniform(-3.2, -2.4, (n, 3))).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    op = rng.uniform(0.4, 0.9, n).astype(np.float32)
    sh = rng.normal(size=(n, 4, 3)).astype(np.float32) * 0.3
    return tbuild.build_hierarchy(pts, sc, q, op, sh, device=CPU)


def test_gmsd_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.random((3, 37, 50)).astype(np.float32)     # odd height: cropped
    b = np.clip(a + rng.normal(size=a.shape).astype(np.float32) * 0.05, 0,
                1)
    for x, y in ((a, b), (a, a)):
        got = float(tperceptual.gmsd(torch.as_tensor(x), torch.as_tensor(y)))
        ref = float(jperceptual.gmsd(jnp.asarray(x), jnp.asarray(y)))
        assert abs(got - ref) <= 1e-5, (got, ref)
    assert float(tperceptual.gmsd(torch.as_tensor(a),
                                  torch.as_tensor(a))) < 1e-6


@pytest.fixture(scope="module")
def eval_scene():
    """A built hierarchy as a state of both packages (converted as the JAX
    pipeline converts a build, pipeline/full_train.py:157-163), its boxes,
    two cameras and their leaf-only ground truth."""
    h = _hierarchy()
    d = tdhier.DHier(
        sh_degree=1, pos=h.pos, quat=h.quat,
        log_scale=np.log(np.maximum(h.scale, 1e-12)).astype(np.float32),
        opacity=np.clip(h.opacity, 1e-4, 1.0 - 1e-6).astype(np.float32),
        shs=h.sh, nodes=h.nodes)
    m = h.nodes.shape[0]
    tstate = tpost.create_from_dhier(d, capacity=m, device=CPU)
    jstate = jpost.create_from_dhier(jdhier.DHier(*d), capacity=m)
    poses = [(np.eye(3), np.zeros(3)), (np.eye(3), np.array([0.2, 0, 0.5]))]
    tcams = [make_camera(R, t, 0.9, 0.7, W, H, device=CPU) for R, t in poses]
    jcams = [jmake_camera(R, t, 0.9, 0.7, W, H) for R, t in poses]
    act = jgm.activate(jstate)
    leaves = jnp.asarray(h.nodes[:, NODE_CHILD_COUNT] == 0)
    # the leaves' render, noised (a render equal to the tau-0 cut's would
    # put PSNR at infinity)
    noise = np.random.default_rng(1).normal(size=(2, 3, H, W)) * 0.02
    gts = [np.clip(np.asarray(jrender.render_arrays(
        act.means3d, act.scales, act.quats, act.opacities, act.shs, leaves,
        c.world_view, c.full_proj, c.campos, c.tan_fovx, c.tan_fovy,
        jnp.zeros(3), sh_degree=1, width=W, height=H,
        cfg=JConfig(tile_w=16, tile_h=16, max_dup=8192), k_max=256).image)
        + nz, 0, 1).astype(np.float32) for c, nz in zip(jcams, noise)]
    boxes = (h.box_lo, h.box_hi, h.max_side)
    return tstate, jstate, tcams, jcams, gts, boxes


@pytest.mark.parametrize("protocol", ["tau_boxes", "dynamic_limits"])
def test_eval_views_matches_jax(eval_scene, protocol):
    tstate, jstate, tcams, jcams, gts, boxes = eval_scene
    if protocol == "tau_boxes":
        kw = dict(levels=(0.0, 3.0, 6.0, 15.0), level_is_tau=True,
                  boxes=boxes)
    else:
        kw = dict(levels=(0.0, 0.01, 0.1))
    kw.update(budget=256, k_max=256)
    t_warn, j_warn = [], []
    got = teval.eval_views(
        tstate, tcams, gts, cfg=RasterizerConfig(tile_w=16, tile_h=16,
                                                 max_dup=8192),
        warn=t_warn.append, **kw)
    ref = jeval.eval_views(
        jstate, jcams, gts, cfg=JConfig(tile_w=16, tile_h=16, max_dup=8192),
        warn=j_warn.append, **kw)
    assert len(t_warn) == len(j_warn) == 1          # LPIPS unavailable
    for g, r in zip(got, ref):
        assert g.level == r.level and g.lpips is None and r.lpips is None
        assert abs(g.psnr - r.psnr) <= 1e-4, (g, r)
        assert abs(g.ssim - r.ssim) <= 1e-4, (g, r)
        assert abs(g.gmsd - r.gmsd) <= 1e-5, (g, r)
        assert g.mean_rendered == r.mean_rendered
    rendered = [g.mean_rendered for g in got]
    assert rendered == sorted(rendered, reverse=True)
    assert rendered[0] > rendered[-1]
    assert got[0].psnr > 25.0 and got[0].psnr >= got[-1].psnr


def test_incremental_cut_step_matches_jax():
    h = _hierarchy(n=96, seed=5)
    c = h.nodes.shape[0]
    ms = h.scale.max(axis=1)
    t_in = [torch.as_tensor(x) for x in (h.nodes, h.pos, ms)]
    j_in = [jnp.asarray(x) for x in (h.nodes, h.pos, ms)]
    alive = np.ones(c, bool)
    t_active = torch.as_tensor(tmaint.initial_cut(h.nodes, alive))
    j_active = jnp.asarray(jmaint.initial_cut(h.nodes, alive))
    np.testing.assert_array_equal(t_active.numpy(), np.asarray(j_active))
    cache_rows = dict(pos=h.pos, sh=h.sh)
    t_cache = tmaint.ActiveRowCache(cache_rows, budget=c, device=CPU)
    j_cache = jmaint.ActiveRowCache(cache_rows, budget=c)
    moves = 0
    for k in range(10):
        # a camera walking in: the cut refines, then (target up) coarsens
        vp = np.array([0.02 * k, 0.0, 0.3 * k], np.float32)
        target = 1e-3 if k < 7 else 4e-3
        t_active, t_s, t_c = tmaint.incremental_cut_step(
            *t_in, torch.as_tensor(alive), t_active, torch.as_tensor(vp),
            target)
        j_active, j_s, j_c = jmaint.incremental_cut_step(
            *j_in, jnp.asarray(alive), j_active, jnp.asarray(vp), target)
        np.testing.assert_array_equal(t_active.numpy(), np.asarray(j_active))
        assert (int(t_s), int(t_c)) == (int(j_s), int(j_c)), k
        moves += int(t_s) + int(t_c)
        assert bool(tcut.is_hierarchy_cut(t_in[0], t_active,
                                          torch.as_tensor(alive)))
        mask = t_active.numpy()
        assert t_cache.update(mask) == j_cache.update(mask), k
        np.testing.assert_array_equal(t_cache.slot_rows(),
                                      j_cache.slot_rows())
        np.testing.assert_array_equal(t_cache.slot_valid.numpy(),
                                      np.asarray(j_cache.slot_valid))
        rows = t_cache.slot_rows()
        for key, host in cache_rows.items():
            dev = t_cache.device_rows()[key].numpy()
            np.testing.assert_array_equal(dev[rows >= 0], host[rows[rows >= 0]])
    assert moves > 0


def test_active_row_cache_budget_overflow_keeps_state():
    host = {"xyz": np.arange(64 * 3, dtype=np.float32).reshape(64, 3)}
    cache = tmaint.ActiveRowCache(host, budget=32, device=CPU)
    m = np.zeros(64, bool)
    m[:10] = True
    assert cache.update(m) == (10, 0)
    assert cache.update(m) == (0, 0)
    before = cache.slot_rows().copy()
    m[:33] = True
    with pytest.raises(RuntimeError):
        cache.update(m)
    np.testing.assert_array_equal(cache.slot_rows(), before)


def test_budget_controller_matches_jax():
    t = tmaint.BudgetController(budget=100, target=1e-3)
    j = jmaint.BudgetController(budget=100, target=1e-3)
    for n in (95, 95, 50, 10, 10, 10, 91, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0):
        assert t.update(n) == j.update(n)
