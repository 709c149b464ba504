"""Port parity for the flat training step: the losses (`ops/ssim.py`), the
learning-rate schedules and the sparse Adam (`optim.py`), one whole
`train.flat.train_step` from the same state (handed over with
`convert.train_state_from_numpy`) against the JAX package's with the pallas
backend (Pallas kernels in interpret mode), densification and the state
maintenance steps, a 30-step loss-decrease run (test_train_flat.py:42-64)
and the coarse trainer's frozen positions.

Tolerances: losses, rates and Adam to 1e-6; the train step's Adam moments
(m = 0.1 g from zero moments, so m holds the gradient) and densification
statistics to atol 1e-4 after scaling by the largest JAX magnitude. Its
parameters to atol 1e-6 where |g| > 1e-3 max|g|, else within 2 lr: Adam's
first step is lr * sign(g), so a near-zero gradient may flip sign.
Densification and maintenance match exactly, except opacity logits that go
through sigmoid and log: XLA's and PyTorch's float32 kernels for those
differ in the last bit, so they match to 4 ulp."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hlod_gaussians_tpu import optim as joptim
from hlod_gaussians_tpu import render as jrender
from hlod_gaussians_tpu.config import OptimizationConfig as JOpt
from hlod_gaussians_tpu.config import RasterizerConfig as JConfig
from hlod_gaussians_tpu.models import gaussians as jgm
from hlod_gaussians_tpu.ops import ssim as jssim
from hlod_gaussians_tpu.train import coarse as jcoarse
from hlod_gaussians_tpu.train import flat as jflat
from hlod_gaussians_tpu.utils import camera as jcam
from hlod_gaussians_torch import convert, optim, render
from hlod_gaussians_torch.config import OptimizationConfig, RasterizerConfig
from hlod_gaussians_torch.models import gaussians as gm
from hlod_gaussians_torch.ops import rasterize_cuda, ssim
from hlod_gaussians_torch.train import coarse, flat
from hlod_gaussians_torch.utils.camera import make_camera
from tests.jax_knn import knn_keeps_axis_max

CPU = torch.device("cpu")
W, H = 64, 64
JCFG = JConfig(backend="pallas", tile_w=16, tile_h=16, max_dup=4096)
CFG = RasterizerConfig(backend="pallas", tile_w=16, tile_h=16, max_dup=4096)
FIELDS = ("xyz", "f_dc", "f_rest", "log_scale", "quat", "opacity_logit",
          "exposure", "alive", "nodes")



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are tiny: PyTorch's intra-op threads only contend with
    the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def toy_state(n=64, cap=96, seed=0, skybox=0, opacity_init=0.5):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    pts[:, 2] += 4.0
    cols = rng.random((n, 3)).astype(np.float32)
    return jgm.create_from_points(pts, cols, capacity=cap, sh_degree=1,
                                  skybox_num=skybox, scene_radius=0.5,
                                  opacity_init=opacity_init)


def jax_camera():
    return jcam.make_camera(np.eye(3), np.zeros(3), fovx=0.8, fovy=0.8,
                            width=W, height=H)


def torch_camera():
    return make_camera(np.eye(3), np.zeros(3), 0.8, 0.8, W, H, device=CPU)


def leaves(jts):
    """The numpy leaves of a JAX FlatTrainState, in the layout of
    convert.train_state_from_numpy."""
    g = jts.gaussians
    return dict(
        gaussians={k: np.asarray(getattr(g, k)) for k in FIELDS},
        adam=dict(m={k: np.asarray(v) for k, v in jts.adam.m.items()},
                  v={k: np.asarray(v) for k, v in jts.adam.v.items()},
                  step=int(jts.adam.step)),
        xyz_grad_accum=np.asarray(jts.xyz_grad_accum),
        denom=np.asarray(jts.denom), max_radii=np.asarray(jts.max_radii),
        step=int(jts.step))


def to_torch(jts):
    g = jts.gaussians
    return convert.train_state_from_numpy(
        leaves(jts), n_skybox=g.n_skybox, n_scaffold=g.n_scaffold,
        device=CPU)


def test_losses_match_jax():
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 1, (3, 40, 56)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape).astype(np.float32) * 0.1, 0, 1)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for fn, jfn in ((ssim.ssim, jssim.ssim), (ssim.l1_loss, jssim.l1_loss),
                    (ssim.psnr, jssim.psnr)):
        np.testing.assert_allclose(float(fn(ta, tb)), float(jfn(ja, jb)),
                                   rtol=1e-6, err_msg=fn.__name__)
    assert float(ssim.ssim(ta, ta)) == pytest.approx(1.0, abs=1e-6)


def test_learning_rates_match_jax():
    opt = OptimizationConfig(position_lr_init=1e-3)
    jopt = JOpt(position_lr_init=1e-3)
    for step in (0, 1, 137, 4999, 5000, 29_999, 40_000):
        got = optim.param_lrs(opt, step, 5.0, lr_multiplier=0.5)
        ref = joptim.param_lrs(jopt, jnp.int32(step), jnp.float32(5.0),
                               lr_multiplier=0.5)
        assert got.keys() == ref.keys()
        for k in got:
            np.testing.assert_allclose(got[k], float(ref[k]), rtol=1e-6,
                                       err_msg=f"{k} at step {step}")
        np.testing.assert_allclose(
            optim.expon_lr(step, 1.0, 0.01, max_steps=30_000),
            float(joptim.expon_lr(step, 1.0, 0.01, max_steps=30_000)),
            rtol=1e-6)
    # the frozen rate (coarse xyz) is 0, not NaN
    assert optim.expon_lr(7, 0.0, 0.0) == 0.0 == float(
        joptim.expon_lr(7, 0.0, 0.0))


@pytest.mark.parametrize("step", [1, 7])
@pytest.mark.parametrize("mask", ["absent", "partial", "empty"])
def test_sparse_adam_matches_jax(mask, step):
    """The CPU path of sparse_adam_update (the plain chain) against the JAX
    package's, with no mask, a 60 % one and an empty one, at steps 1 and
    7."""
    rng = np.random.default_rng(5)
    c = 40
    shapes = dict(xyz=(c, 3), f_dc=(c, 1, 3), opacity_logit=(c, 1),
                  exposure=(3, 3, 4))
    f = lambda s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    p = {k: f(s) for k, s in shapes.items()}
    g = {k: f(s, 0.01) for k, s in shapes.items()}
    g["exposure"][1] = 0.0                 # an image without gradient
    m = {k: f(s, 0.01) for k, s in shapes.items()}
    v = {k: np.abs(f(s, 1e-4)) for k, s in shapes.items()}
    vis = dict(absent=None, partial=rng.random(c) < 0.6,
               empty=np.zeros(c, bool))[mask]
    lrs = optim.param_lrs(OptimizationConfig(), step, 3.0)
    lrs = {k: lrs[k] for k in shapes}
    t = lambda d: {k: torch.as_tensor(x) for k, x in d.items()}
    j = lambda d: {k: jnp.asarray(x) for k, x in d.items()}
    launches = optim.sparse_adam_cuda.launches
    got_p, got_s = optim.sparse_adam_update(
        t(p), t(g), optim.AdamState(m=t(m), v=t(v), step=step - 1),
        lrs, visible=None if vis is None else torch.as_tensor(vis))
    assert optim.sparse_adam_cuda.launches == launches   # CPU: the chain
    ref_p, ref_s = joptim.sparse_adam_update(
        j(p), j(g), joptim.AdamState(m=j(m), v=j(v),
                                     step=jnp.int32(step - 1)),
        {k: jnp.float32(x) for k, x in lrs.items()},
        visible=None if vis is None else jnp.asarray(vis))
    assert got_s.step == int(ref_s.step) == step
    for k in shapes:
        for name, a, b in (("p", got_p, ref_p), ("m", got_s.m, ref_s.m),
                           ("v", got_s.v, ref_s.v)):
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                       rtol=1e-6, atol=1e-9,
                                       err_msg=f"{name} {k}")
    # rows outside `visible` and the gradient-free image keep their values;
    # with no mask every row moves
    kept = np.zeros(c, bool) if vis is None else ~vis
    np.testing.assert_array_equal(got_p["xyz"].numpy()[kept], p["xyz"][kept])
    assert (got_s.m["xyz"].numpy()[~kept] != m["xyz"][~kept]).any(1).all()
    np.testing.assert_array_equal(got_p["exposure"].numpy()[1],
                                  p["exposure"][1])
    if vis is None:
        return
    zeroed = optim.zero_rows(got_s, torch.as_tensor(vis), keys=("xyz",))
    assert not zeroed.m["xyz"][torch.as_tensor(vis)].any()
    assert torch.equal(zeroed.m["f_dc"], got_s.m["f_dc"])


def _adam_inputs(c=8):
    z = lambda *s: torch.zeros(s)
    params = dict(xyz=z(c, 3), f_rest=z(c, 15, 3), exposure=z(1, 3, 4))
    grads = {k: torch.zeros_like(x) for k, x in params.items()}
    state = optim.init_adam(params)
    return params, grads, state, torch.ones(c, dtype=torch.bool)


@pytest.mark.parametrize("bad", ["float64", "noncontiguous", "shape", "cpu",
                                 "mask-dtype"])
def test_sparse_adam_cuda_checks_before_any_launch(bad, monkeypatch):
    """The kernel's wrapper refuses a tensor it cannot take, a float64 or
    non-contiguous one included, with a ValueError before it builds or
    launches anything."""
    params, grads, state, visible = _adam_inputs()
    if bad == "float64":
        grads["xyz"] = grads["xyz"].double()
    elif bad == "noncontiguous":
        state.m["f_rest"] = torch.zeros(8, 3, 15).transpose(1, 2)
    elif bad == "shape":
        state.v["xyz"] = torch.zeros(8, 4)
    elif bad == "mask-dtype":
        visible = visible.to(torch.uint8)
    # "cpu": every check passes but the device's

    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(rasterize_cuda, "_library", no_build)
    launches = optim.sparse_adam_cuda.launches
    rows = optim.counters["adam.rows_fused"]
    message = dict(float64="float32", noncontiguous="contiguous",
                   shape="shape", cpu="CUDA", **{"mask-dtype": "bool"})[bad]
    with pytest.raises(ValueError, match=message):
        optim.sparse_adam_cuda(params, grads, state,
                               dict.fromkeys(params, 1e-3), visible)
    assert optim.sparse_adam_cuda.launches == launches
    assert optim.counters["adam.rows_fused"] == rows


def _scaled_close(got, ref, atol, err_msg):
    ref = np.asarray(ref)
    scale = np.abs(ref).max() + 1e-12
    np.testing.assert_allclose(np.asarray(got) / scale, ref / scale,
                               atol=atol, err_msg=err_msg)


def test_train_step_matches_jax():
    state = toy_state()
    cam = jax_camera()
    act = jgm.activate(state)
    gt = np.asarray(jrender.render_arrays(
        act.means3d, act.scales, act.quats, act.opacities, act.shs,
        act.valid, cam.world_view, cam.full_proj, cam.campos, cam.tan_fovx,
        cam.tan_fovy, jnp.zeros(3), sh_degree=1, width=W, height=H,
        cfg=JConfig(tile_w=16, tile_h=16, max_dup=4096), k_max=256).image)
    pert = dataclasses.replace(
        state, f_dc=state.f_dc + 0.3,
        xyz=state.xyz + 0.02 * np.random.default_rng(1).normal(
            size=state.xyz.shape).astype(np.float32))
    jts = jflat.init_flat_train(pert)
    tts = to_torch(jts)          # before the JAX step, which donates jts
    xyz_in = tts.gaussians.xyz.clone()
    opt = OptimizationConfig(position_lr_init=1e-3, iterations=200)
    kw = dict(width=W, height=H, k_max=256, sh_degree=1, use_exposure=True,
              scale_big_gauss=True)
    bg = np.array([0.1, 0.2, 0.3], np.float32)

    jnew, jaux = jflat.train_step(
        jts, cam.world_view, cam.full_proj, cam.campos, cam.tan_fovx,
        cam.tan_fovy, jnp.asarray(gt), jnp.asarray(bg),
        exposure_idx=jnp.int32(0), scene_extent=5.0,
        opt=JOpt(position_lr_init=1e-3, iterations=200), cfg=JCFG, **kw)
    tc = torch_camera()
    launches = (rasterize_cuda.blend_forward.launches,
                rasterize_cuda.blend_backward.launches)
    tnew, taux = flat.train_step(
        tts, tc.world_view, tc.full_proj, tc.campos, tc.tan_fovx,
        tc.tan_fovy, torch.as_tensor(gt), torch.as_tensor(bg),
        exposure_idx=0, scene_extent=5.0, opt=opt, cfg=CFG, **kw)
    assert launches == (rasterize_cuda.blend_forward.launches,
                        rasterize_cuda.blend_backward.launches)

    np.testing.assert_allclose(float(taux.loss), float(jaux.loss), rtol=1e-5)
    assert int(taux.n_visible) == int(jaux.n_visible) > 0
    assert not bool(taux.truncated) and not bool(jaux.truncated)
    assert tnew.step == int(jnew.step) == 1
    assert tnew.adam.step == int(jnew.adam.step) == 1
    for k in jnew.adam.m:
        _scaled_close(tnew.adam.m[k].numpy(), jnew.adam.m[k], 1e-4, f"m {k}")
        _scaled_close(tnew.adam.v[k].numpy(), jnew.adam.v[k], 1e-4, f"v {k}")
    _scaled_close(tnew.xyz_grad_accum.numpy(), jnew.xyz_grad_accum, 1e-4,
                  "xyz_grad_accum")
    np.testing.assert_array_equal(tnew.denom.numpy(), np.asarray(jnew.denom))
    np.testing.assert_array_equal(tnew.max_radii.numpy(),
                                  np.asarray(jnew.max_radii))

    lrs = optim.param_lrs(opt, 0, 5.0)
    for k in jnew.adam.m:
        got = getattr(tnew.gaussians, k).numpy()
        ref = np.asarray(getattr(jnew.gaussians, k))
        gabs = np.abs(np.asarray(jnew.adam.m[k]))   # 0.1 |g|
        big = gabs > 1e-3 * gabs.max()
        diff = np.abs(got - ref)
        assert diff[big].max(initial=0.0) <= 1e-6, k
        assert diff.max(initial=0.0) <= 2 * lrs[k] + 1e-6, k
    for k in ("alive", "nodes"):
        np.testing.assert_array_equal(getattr(tnew.gaussians, k).numpy(),
                                      np.asarray(getattr(jnew.gaussians, k)))
    # the input state is left as it was
    assert torch.equal(tts.gaussians.xyz, xyz_in)


def _densify_state(cap=56, seed=2):
    """A state where the selection, the protected skybox rows, interior
    nodes and the capacity limit all matter."""
    st = toy_state(n=40, cap=cap, seed=seed, skybox=4)
    rng = np.random.default_rng(seed)
    logit = rng.normal(size=(cap, 1)).astype(np.float32) * 2.0
    nodes = np.asarray(st.nodes).copy()
    nodes[10:14, jgm.NODE_CHILD_COUNT] = 2              # interior nodes
    nodes[:, jgm.NODE_DEPTH] = rng.integers(0, 3, cap)
    st = dataclasses.replace(st, opacity_logit=jnp.asarray(logit),
                             nodes=jnp.asarray(nodes))
    jts = jflat.init_flat_train(st)
    m, v = ({k: jnp.asarray(rng.normal(size=x.shape).astype(np.float32))
             for k, x in jts.adam.m.items()} for _ in range(2))
    return dataclasses.replace(
        jts, adam=jts.adam._replace(m=m, v=v, step=jnp.int32(3)),
        xyz_grad_accum=jnp.asarray(rng.uniform(0, 0.01, cap)
                                   .astype(np.float32)),
        max_radii=jnp.asarray(rng.uniform(0, 6, cap).astype(np.float32)),
        denom=jnp.asarray(rng.integers(0, 5, cap).astype(np.int32)),
        step=jnp.int32(3))


def _assert_states_equal(tts, jts, ulp_fields=()):
    for k in FIELDS:
        got = getattr(tts.gaussians, k).numpy()
        ref = np.asarray(getattr(jts.gaussians, k))
        if k in ulp_fields:
            np.testing.assert_array_max_ulp(got, ref, maxulp=4)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=k)
    for part in ("m", "v"):
        for k, ref in getattr(jts.adam, part).items():
            np.testing.assert_array_equal(getattr(tts.adam, part)[k].numpy(),
                                          np.asarray(ref), err_msg=part + k)
    for k in ("xyz_grad_accum", "denom", "max_radii"):
        np.testing.assert_array_equal(getattr(tts, k).numpy(),
                                      np.asarray(getattr(jts, k)), err_msg=k)
    assert tts.step == int(jts.step)


@pytest.mark.parametrize("mode", ["split", "clone"])
def test_densify_matches_jax(mode):
    jts = _densify_state()
    tts = to_torch(jts)          # before the JAX step, which donates jts
    n_free = int((~tts.gaussians.alive).sum())
    opt = OptimizationConfig(densify_grad_threshold=0.01)
    tnew, tn = flat.densify_step(tts, 5.0, opt=opt, mode=mode)
    jnew, jn = jflat.densify_step(
        jts, 5.0, opt=JOpt(densify_grad_threshold=0.01), mode=mode)
    # some leaves qualify, and the free rows run out before the selection
    assert 0 < int(tn) == int(jn) == n_free // 2
    _assert_states_equal(tnew, jnew, ulp_fields=("opacity_logit",))


def test_reset_opacity_and_shrink_match_jax():
    jts = _densify_state()
    tts = to_torch(jts)
    _assert_states_equal(flat.reset_opacity(tts), jflat.reset_opacity(jts),
                         ulp_fields=("opacity_logit",))
    g = tts.gaussians
    for extent, frac in ((5.0, 0.02), (1.0, 0.1), (30.0, 0.02)):
        got = flat.shrink_big_gaussians(g.params(), g, extent, frac)
        ref = jflat.shrink_big_gaussians(jts.gaussians.params(),
                                         jts.gaussians, extent, frac)
        np.testing.assert_array_equal(got["log_scale"].numpy(),
                                      np.asarray(ref["log_scale"]))
    # skybox rows are never shrunk
    got = flat.shrink_big_gaussians(g.params(), g, 1e-3, 0.02)["log_scale"]
    assert torch.equal(got[:4], g.log_scale[:4])
    assert not torch.equal(got[4:], g.log_scale[4:])


def test_train_step_decreases_loss():
    """30 steps of the port's kernel path fit a perturbed scene back toward
    its own render (test_train_flat.py:42-64)."""
    state = to_torch(jflat.init_flat_train(toy_state())).gaussians
    cam = torch_camera()
    act = gm.activate(state)
    with torch.no_grad():
        gt = render.render_arrays(
            act.means3d, act.scales, act.quats, act.opacities, act.shs,
            act.valid, cam.world_view, cam.full_proj, cam.campos,
            cam.tan_fovx, cam.tan_fovy, torch.zeros(3), sh_degree=1,
            width=W, height=H, cfg=CFG).image
    noise = np.random.default_rng(1).normal(size=state.xyz.shape)
    pert = dataclasses.replace(
        state, f_dc=state.f_dc + 0.3,
        xyz=state.xyz + 0.02 * torch.as_tensor(noise.astype(np.float32)))
    ts = flat.init_flat_train(pert)
    opt = OptimizationConfig(position_lr_init=1e-3, iterations=200)
    losses = []
    for _ in range(30):
        ts, aux = flat.train_step(
            ts, cam.world_view, cam.full_proj, cam.campos, cam.tan_fovx,
            cam.tan_fovy, gt, torch.zeros(3), exposure_idx=0,
            scene_extent=5.0, opt=opt, cfg=CFG, width=W, height=H,
            sh_degree=1, use_exposure=False, scale_big_gauss=False)
        losses.append(float(aux.loss))
    assert losses[-1] < losses[0] * 0.7, losses
    assert np.isfinite(losses).all()
    assert ts.step == 30 and int(ts.denom.max()) == 30


def test_coarse_frozen_xyz_stays_finite():
    """The coarse init matches the JAX package's; the coarse stage freezes
    positions (lr_init = lr_final = 0), so xyz stays bit-identical over
    steps with a random background drawn from a seeded generator
    (test_train_flat.py:192-217)."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(24, 3)).astype(np.float32) * 0.5
    pts[:, 2] += 4.0
    cols = rng.random((24, 3)).astype(np.float32)
    ts = coarse.init_coarse(pts, cols, capacity=40, scene_radius=1.0,
                            skybox_num=8, device=CPU)
    # the JAX kNN with the port's last cell for each axis maximum
    # (tests/jax_knn.py; the two kNNs are compared in test_torch_knn.py)
    with knn_keeps_axis_max():
        jts = jcoarse.init_coarse(pts, cols, capacity=40, scene_radius=1.0,
                                  skybox_num=8)
    assert ts.gaussians.sh_degree == 1 and ts.gaussians.n_skybox == 8
    for k in FIELDS:
        np.testing.assert_allclose(getattr(ts.gaussians, k).numpy(),
                                   np.asarray(getattr(jts.gaussians, k)),
                                   atol=1e-5, err_msg=k)
    cam = torch_camera()
    xyz0 = ts.gaussians.xyz.clone()
    f_dc0 = ts.gaussians.f_dc.clone()
    gen = torch.Generator().manual_seed(0)
    opt_c = coarse.coarse_opt_config(OptimizationConfig())
    for _ in range(3):
        ts, aux = coarse.coarse_step(
            ts, (cam.world_view, cam.full_proj, cam.campos, cam.tan_fovx,
                 cam.tan_fovy), torch.zeros((3, H, W)), gen, 5.0,
            opt=opt_c, cfg=CFG, width=W, height=H, k_max=128)
        assert np.isfinite(float(aux.loss))
    assert torch.isfinite(ts.gaussians.xyz).all()
    assert torch.equal(ts.gaussians.xyz, xyz0)
    assert not torch.equal(ts.gaussians.f_dc, f_dc0)
