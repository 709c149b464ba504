"""Port parity for out-of-core post-optimization (train/offload.py) against
the JAX package, on the scenes of tests/test_offload.py at 48x48 with both
packages on the pallas backend (JAX's Pallas kernels in interpret mode, the
port's B1/B2 through their plain versions on CPU tensors).

Tolerances:
- the packed layout, the host store round trip, the slot tables, fetch and
  evict counts, CachedCutter's masks and selections: exact; its distances
  to 4 ulp (tests/test_torch_spt.py's rule);
- prefetch against no prefetch: bitwise;
- losses: rtol 1e-5 for one step, 1e-4 over the 9-iteration loop; the
  images the updated rows render: atol 2e-5;
- parameters and moments after a step: the post step's tolerances
  (tests/test_torch_post.py::assert_step_close): parameters to atol 1e-6 a
  step where |m| > 1e-3 max|m|, else within 2 lr a step; moments to atol
  1e-4 after scaling by the largest JAX magnitude.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hlod_gaussians_tpu import optim as joptim
from hlod_gaussians_tpu import render as jrender
from hlod_gaussians_tpu.config import PostConfig as JPost
from hlod_gaussians_tpu.config import RasterizerConfig as JConfig
from hlod_gaussians_tpu.data.dhier import DHier as JDHier
from hlod_gaussians_tpu.models import gaussians as jgm
from hlod_gaussians_tpu.train import offload as joff
from hlod_gaussians_tpu.train import post as jpost
from hlod_gaussians_tpu.utils import camera as jcam
from hlod_gaussians_torch import convert, optim, render
from hlod_gaussians_torch.config import (OptimizationConfig, PostConfig,
                                         RasterizerConfig)
from hlod_gaussians_torch.train import offload
from hlod_gaussians_torch.utils.camera import make_camera
from tests.test_spt import make_forest
from tests.test_torch_mcmc import leaves

CPU = torch.device("cpu")
W = H = 48
EXTENT = 2.0
BUDGET = 64
JCFG = JConfig(backend="pallas", tile_w=16, tile_h=16, max_dup=4096)
CFG = RasterizerConfig(backend="pallas", tile_w=16, tile_h=16, max_dup=4096)
STEP_KW = dict(width=W, height=H, k_max=128, sh_degree=1,
               scene_extent=EXTENT)
TRAINER_KW = dict(width=W, height=H, k_max=128, scene_extent=EXTENT)
# overlapping working sets over the live rows (tests/test_offload.py:170)
SETS = [np.arange(0, 32), np.arange(16, 40), np.arange(8, 36),
        np.arange(0, 24)]
KEYS = offload._ROW_KEYS


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: PyTorch's intra-op threads only contend with the
    other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def toy(seed, cap=256, n=48):
    """tests/test_offload.py's toy scene as (JAX state, port state, JAX
    camera, port camera)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    pts[:, 2] += 4.0
    cols = rng.random((n, 3)).astype(np.float32)
    jst = jgm.create_from_points(pts, cols, capacity=cap, sh_degree=1,
                                 opacity_init=0.7)
    tst = convert.state_from_numpy(leaves(jst)["gaussians"], n_skybox=0,
                                   device=CPU)
    args = (np.eye(3), np.zeros(3), 0.9, 0.9, W, H)
    return jst, tst, jcam.make_camera(*args), make_camera(*args, device=CPU)


def jcam_args(c):
    return (c.world_view, c.full_proj, c.campos, c.tan_fovx, c.tan_fovy)


def seeded_adam(jst, seed=1):
    rng = np.random.default_rng(seed)
    a = joptim.init_adam(jst.params())
    return a._replace(
        m={k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
           for k, v in a.m.items()},
        v={k: jnp.asarray(rng.uniform(size=v.shape).astype(np.float32))
           for k, v in a.v.items()},
        step=jnp.asarray(3, jnp.int32))


def port_adam(jadam):
    return optim.AdamState(
        m={k: torch.tensor(np.asarray(v)) for k, v in jadam.m.items()},
        v={k: torch.tensor(np.asarray(v)) for k, v in jadam.v.items()},
        step=int(jadam.step))


def lrs_over(steps, step0=0):
    return {k: max(optim.param_lrs(OptimizationConfig(), i, EXTENT)[k]
                   for i in range(step0, step0 + steps)) for k in KEYS}


def assert_rows_close(got, ref, lrs, steps=1):
    """(p, m, v) numpy dicts of the port against the JAX package's, at the
    post step's tolerances."""
    gp, gm_, gv = got
    rp, rm, rv = ref
    for k in KEYS:
        gabs = np.abs(rm[k])
        big = gabs > 1e-3 * gabs.max()
        diff = np.abs(gp[k] - rp[k])
        assert diff[big].max(initial=0.0) <= 1e-6 * steps, k
        assert diff.max(initial=0.0) <= 2 * steps * lrs[k] + 1e-6, k
        for name, g, r in (("m", gm_[k], rm[k]), ("v", gv[k], rv[k])):
            scale = np.abs(r).max() + 1e-30
            np.testing.assert_allclose(g / scale, r / scale, atol=1e-4,
                                       err_msg=f"{name} {k}")


def unpacked(data, sh_degree=1):
    p, m, v = offload.unpack_rows(torch.as_tensor(np.asarray(data)),
                                  sh_degree)
    return tuple({k: t.numpy() for k, t in d.items()} for d in (p, m, v))


def render_rows(p, rows, jc, tc):
    """The image of `rows` of the parameter dict p (numpy), rendered by the
    JAX package and by the port -> (JAX image, port image)."""
    valid = np.zeros(p["xyz"].shape[0], bool)
    valid[rows] = True
    q = p["quat"] / np.linalg.norm(p["quat"], axis=-1, keepdims=True)
    args = (p["xyz"], np.exp(p["log_scale"]), q,
            1 / (1 + np.exp(-p["opacity_logit"][:, 0])),
            np.concatenate([p["f_dc"], p["f_rest"]], axis=1), valid)
    kw = dict(sh_degree=1, width=W, height=H, k_max=128)
    ji = jrender.render_arrays(*map(jnp.asarray, args), *jcam_args(jc),
                               jnp.zeros(3), cfg=JCFG, **kw).image
    with torch.no_grad():
        ti = render.render_arrays(*map(torch.as_tensor, args),
                                  *jcam_args(tc), torch.zeros(3), cfg=CFG,
                                  **kw).image
    return np.asarray(ji), ti.numpy()


# ---- layout --------------------------------------------------------------

def test_pack_unpack_repack_bitwise():
    jst, tst, _, _ = toy(0)
    jadam = seeded_adam(jst)
    ref = joff.pack_store(jst, jadam)
    got = offload.pack_store(tst, port_adam(jadam))
    assert got.shape == ref.shape == (256, 69) and not got.is_pinned()
    np.testing.assert_array_equal(got.numpy(), ref)
    p, m, v = offload.unpack_rows(got, 1)
    for k in KEYS:
        assert torch.equal(p[k], getattr(tst, k)), k
        np.testing.assert_array_equal(m[k].numpy(), np.asarray(jadam.m[k]))
    np.testing.assert_array_equal(
        offload.pack_rows(p, m, v, 1).numpy(), ref)
    store = offload.PackedStore.from_state(tst, port_adam(jadam))
    assert store.capacity == 256 and store.step == 3
    # a JAX store carried over as it is
    jstore = joff.PackedStore.from_state(jst, jadam)
    carried = convert.packed_store_from_numpy(jstore.data, 1, jstore.step,
                                              device=CPU)
    np.testing.assert_array_equal(carried.data.numpy(), jstore.data)
    assert carried.step == 3 and carried.sh_degree == 1


def test_host_store_roundtrip():
    jst, tst, _, _ = toy(0)
    jadam = seeded_adam(jst)
    jstore = joff.to_host_store(jst, jadam)
    store = offload.to_host_store(tst, port_adam(jadam))
    assert store.step == int(jstore.step) == 3
    for group in ("params", "m", "v"):
        for k in KEYS:
            got = getattr(store, group)[k]
            assert got.shape[0] == 257 and not got[-1].any(), (group, k)
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(getattr(jstore, group)[k]))
    st2, adam2 = offload.from_host_store(store, tst)
    for k in KEYS:
        assert torch.equal(getattr(st2, k), getattr(tst, k)), k
        np.testing.assert_array_equal(adam2.m[k].numpy(),
                                      np.asarray(jadam.m[k]))
    assert torch.equal(st2.nodes, tst.nodes) and adam2.step == 3


# ---- the three step forms --------------------------------------------------

def _working_set():
    mask = np.zeros(256, bool)
    mask[:24] = True
    return mask


def _run_form(form, jst, tst, jc, tc, gt):
    """One step of `form` in both packages over the first 24 rows ->
    ((loss, n_vis, rows p/m/v) JAX, the same for the port, rows after)."""
    mask = _working_set()
    bg = np.zeros(3, np.float32)
    post = dict(lambda_opacity=0.01)
    jkw = dict(post=JPost(**post), cfg=JCFG, **STEP_KW)
    tkw = dict(post=PostConfig(**post), cfg=CFG, **STEP_KW)
    jargs = (*jcam_args(jc), jnp.asarray(gt), jnp.asarray(bg))
    targs = (*jcam_args(tc), torch.as_tensor(gt), torch.as_tensor(bg))
    if form == "host":
        jidx, jvalid = joff.cut_to_indices(jnp.asarray(mask), BUDGET)
        jstore, jloss, jvis = joff.make_offloaded_step(**jkw)(
            joff.to_host_store(jst), jidx, jvalid, *jargs)
        tidx, tvalid = offload.cut_to_indices(torch.as_tensor(mask), BUDGET)
        tstore, tloss, tvis = offload.make_offloaded_step(**tkw)(
            offload.to_host_store(tst), tidx, tvalid, *targs)
        assert tstore.step == int(jstore.step) == 1
        ref = tuple({k: np.asarray(getattr(jstore, g)[k])[:-1] for k in KEYS}
                    for g in ("params", "m", "v"))
        got = tuple({k: getattr(tstore, g)[k][:-1].numpy() for k in KEYS}
                    for g in ("params", "m", "v"))
        # padding lanes wrote row cap-1's unchanged values to the scratch row
        for k in KEYS:
            np.testing.assert_array_equal(
                tstore.params[k][-1].numpy(),
                np.asarray(jstore.params[k])[-1])
    elif form == "numpy":
        idx = np.concatenate([np.where(mask)[0],
                              np.full(BUDGET - 24, 256)]).astype(np.int32)
        jstore = joff.to_numpy_store(jst)
        jloss, jvis = joff.make_numpy_offloaded_step(**jkw)(
            jstore, idx, *jargs)
        tstore = offload.to_numpy_store(tst)
        tloss, tvis = offload.make_numpy_offloaded_step(**tkw)(
            tstore, idx, *targs)
        assert tstore.step == jstore.step == 1
        ref = (jstore.params, jstore.m, jstore.v)
        got = (tstore.params, tstore.m, tstore.v)
    else:
        idx = np.where(mask)[0].astype(np.int32)
        jstore = joff.PackedStore.from_state(jst)
        jd, jw = joff.make_packed_offloaded_step(**jkw)
        jloss, jvis = jw(jstore, jd(jstore, idx, *jargs))
        tstore = offload.PackedStore.from_state(tst)
        td, tw = offload.make_packed_offloaded_step(**tkw)
        tloss, tvis = tw(tstore, td(tstore, idx, *targs))
        assert tstore.step == jstore.step == 1
        ref, got = unpacked(jstore.data), unpacked(tstore.data.numpy())
    return (float(jloss), int(jvis), ref), (float(tloss), int(tvis), got)


@pytest.mark.parametrize("form", ["host", "numpy", "packed"])
def test_offloaded_step_matches_jax(form):
    jst, tst, jc, tc = toy(3)
    gt = np.full((3, H, W), 0.3, np.float32)
    before = offload.pack_store(tst).numpy()
    (jloss, jvis, ref), (tloss, tvis, got) = _run_form(form, jst, tst, jc,
                                                       tc, gt)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    assert tvis == jvis > 0
    assert_rows_close(got, ref, lrs_over(1))
    # rows outside the working set keep their values exactly
    p0 = unpacked(before)[0]
    for k in KEYS:
        np.testing.assert_array_equal(got[0][k][24:], p0[k][24:])
    assert not np.array_equal(got[0]["f_dc"][:24], p0["f_dc"][:24])
    ji, ti = render_rows(got[0], np.arange(24), jc, tc)
    jref, _ = render_rows(ref[0], np.arange(24), jc, tc)
    np.testing.assert_allclose(ti, jref, atol=2e-5)
    np.testing.assert_allclose(ji, jref, atol=2e-5)


# ---- the device-resident trainer --------------------------------------------

def _trainer_runs():
    jst, tst, jc, tc = toy(3)
    gt = np.full((3, H, W), 0.35, np.float32)
    jargs = (*jcam_args(jc), jnp.asarray(gt), jnp.zeros(3))
    targs = (*jcam_args(tc), torch.as_tensor(gt), torch.zeros(3))
    out = {}
    # the JAX trainer, its slot tables after every step
    jtr = joff.DeviceResidentTrainer(joff.PackedStore.from_state(jst),
                                     budget=BUDGET, cfg=JCFG, **TRAINER_KW)
    jlog = []
    for rows in SETS:
        loss, _ = jtr.step(rows.astype(np.int32), *jargs)
        jlog.append((float(loss), jtr.last_fetch, jtr.last_evict,
                     jtr.slot_of_row.copy(), jtr.row_of_slot.copy()))
    jtr.flush()
    out["jax"] = (jlog, jtr.store.data)
    for prefetch in (False, True):
        ttr = offload.DeviceResidentTrainer(
            offload.PackedStore.from_state(tst), budget=BUDGET, cfg=CFG,
            device=CPU, **TRAINER_KW)
        tlog = []
        for i, rows in enumerate(SETS):
            nxt = SETS[i + 1] if prefetch and i + 1 < len(SETS) else None
            loss, _ = ttr.step(rows, *targs, prefetch_rows=nxt)
            assert not bool(ttr.last_truncated)
            if nxt is not None:
                assert ttr._prefetched is not None
            tlog.append((float(loss), ttr.last_fetch, ttr.last_evict,
                         ttr.slot_of_row.copy(), ttr.row_of_slot.copy()))
        ttr.flush()
        out[prefetch] = (tlog, ttr.store.data.numpy(), ttr)
    # the port's sequential numpy paging over the same sets
    seq = offload.to_numpy_store(tst)
    step = offload.make_numpy_offloaded_step(cfg=CFG, **STEP_KW)
    for rows in SETS:
        step(seq, rows.astype(np.int32), *targs)
    out["seq"] = seq
    out["cams"] = (jc, tc)
    return out


@pytest.fixture(scope="module")
def trainer_runs():
    return _trainer_runs()


def test_trainer_matches_jax(trainer_runs):
    jlog, jdata = trainer_runs["jax"]
    tlog, tdata, _ = trainer_runs[False]
    assert [t[1] for t in tlog] == [j[1] for j in jlog] == [32, 8, 8, 8]
    assert [t[2] for t in tlog] == [j[2] for j in jlog]
    for (tl, _, _, tsor, tros), (jl, _, _, jsor, jros) in zip(tlog, jlog):
        np.testing.assert_array_equal(tsor, jsor)
        np.testing.assert_array_equal(tros, jros)
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert_rows_close(unpacked(tdata), unpacked(jdata), lrs_over(4), 4)
    jc, tc = trainer_runs["cams"]
    rows = np.arange(40)
    _, ti = render_rows(unpacked(tdata)[0], rows, jc, tc)
    ji, _ = render_rows(unpacked(jdata)[0], rows, jc, tc)
    np.testing.assert_allclose(ti, ji, atol=2e-5)


def test_trainer_matches_sequential_paging(trainer_runs):
    """Every row has one live copy, so the cached trainer's store equals
    sequential paging's (the JAX package's test_offload tolerance)."""
    p, m, _ = unpacked(trainer_runs[False][1])
    seq = trainer_runs["seq"]
    for k in ("xyz", "opacity_logit", "f_dc"):
        np.testing.assert_allclose(p[k], seq.params[k], rtol=2e-5,
                                   atol=2e-6)
    np.testing.assert_allclose(m["xyz"], seq.m["xyz"], rtol=2e-5,
                               atol=1e-7)
    assert trainer_runs[False][2].store.step == seq.step == 4


def test_trainer_prefetch_is_bitwise(trainer_runs):
    """step(prefetch_rows=next) gives the unpipelined results bit for bit,
    with the rows evicted at one step and needed at the next written back
    before they are gathered again."""
    plain, pre = trainer_runs[False], trainer_runs[True]
    np.testing.assert_array_equal(pre[1], plain[1])
    for a, b in zip(plain[0], pre[0]):
        assert a[:3] == b[:3]
        np.testing.assert_array_equal(a[3], b[3])


def test_trainer_over_budget_raises():
    """The JAX package's prepare() names an undefined variable when the
    working set exceeds the budget (NameError); the port raises
    RuntimeError with the counts."""
    jst, tst, _, _ = toy(0)
    rows = np.arange(40, dtype=np.int32)
    jtr = joff.DeviceResidentTrainer(joff.PackedStore.from_state(jst),
                                     budget=32, cfg=JCFG, **TRAINER_KW)
    with pytest.raises(NameError):
        jtr.prepare(rows)
    ttr = offload.DeviceResidentTrainer(offload.PackedStore.from_state(tst),
                                        budget=32, cfg=CFG, device=CPU,
                                        **TRAINER_KW)
    with pytest.raises(RuntimeError, match="working set 40 rows > budget 32"):
        ttr.prepare(rows)


# ---- cuts -----------------------------------------------------------------

def test_cut_to_indices_and_reuse_diff_match_jax():
    rng = np.random.default_rng(0)
    mask = rng.random(300) < 0.3
    for budget in (200, int(mask.sum()), 40):     # over-budget rows dropped
        ji, jv = joff.cut_to_indices(jnp.asarray(mask), budget)
        ti, tv = offload.cut_to_indices(torch.as_tensor(mask), budget)
        assert ti.dtype == torch.int32
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    prev = np.array([10.0, 20.0, 30.0, 5.0], np.float32)
    new = np.array([10.5, 40.0, 30.0, 4.4], np.float32)
    np.testing.assert_array_equal(
        offload.reuse_diff(None, torch.as_tensor(prev), torch.as_tensor(new),
                           0.9).numpy(),
        np.asarray(joff.reuse_diff(None, jnp.asarray(prev),
                                   jnp.asarray(new), 0.9)))


def test_cached_cutter_matches_jax():
    """tests/test_offload.py:256-301's moves: a small one reuses the cut
    distances, a large one re-cuts, and without the cache every cut is
    fresh. Masks and selections equal JAX's, distances to 4 ulp."""
    h, jforest = make_forest(n=257, seed=2)
    cap = h.nodes.shape[0]
    forest = convert.forest_from_numpy(
        {k: np.asarray(getattr(jforest, k)) for k in jforest._fields},
        device=CPU)
    proj = np.eye(4, dtype=np.float32)
    c0 = np.array([0.0, 0.0, -3.0], np.float32)
    moves = [c0, c0 + [0.0, 0.0, -0.05], c0 + [0.0, 0.0, -8.0], c0]
    for cache in (True, False):
        kw = dict(cache_spts=cache, reuse_spt_tolerance=0.9,
                  use_frustum_culling=False)
        jcut = joff.CachedCutter(jforest, cap, JPost(**kw))
        tcut = offload.CachedCutter(forest, cap, PostConfig(**kw))
        for campos in moves:
            jc = jcut.cut(jnp.asarray(campos, jnp.float32), jnp.asarray(proj))
            tc = tcut.cut(torch.as_tensor(campos, dtype=torch.float32),
                          torch.as_tensor(proj))
            assert int(tc.n_selected) == int(jc.n_selected) > 0
            np.testing.assert_array_equal(tc.gaussian_mask.numpy(),
                                          np.asarray(jc.gaussian_mask))
            np.testing.assert_array_equal(tc.spt_selected.numpy(),
                                          np.asarray(jc.spt_selected))
            # XLA fuses the norm differently per program (ROADMAP.md §C)
            np.testing.assert_array_max_ulp(tc.spt_distance.numpy(),
                                            np.asarray(jc.spt_distance),
                                            maxulp=4)


# ---- the composed loop ------------------------------------------------------

def test_post_optimize_offloaded_matches_jax():
    """test_offload.py:304's loop, 9 iterations over three views with the
    cache on: losses, the last fetch count and the flushed store."""
    h, jforest = make_forest(n=129, seed=4)
    cap = 1 << int(np.ceil(np.log2(h.nodes.shape[0] + 1)))
    d = JDHier(sh_degree=1, pos=h.pos, quat=h.quat,
               log_scale=np.log(np.maximum(h.scale, 1e-12)).astype(
                   np.float32),
               opacity=np.clip(h.opacity, 1e-4, 1 - 1e-6).astype(np.float32),
               shs=h.sh.astype(np.float32), nodes=h.nodes)
    jst = jpost.create_from_dhier(d, capacity=cap)
    tst = convert.state_from_numpy(leaves(jst)["gaussians"], n_skybox=0,
                                   device=CPU)
    forest = convert.forest_from_numpy(
        {k: np.asarray(getattr(jforest, k)) for k in jforest._fields},
        device=CPU)
    act = jgm.activate(jst)
    jviews, tviews = [], []
    for k in range(3):
        a = 0.05 * k
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]])
        jc = jcam.make_camera(R, np.zeros(3), 0.9, 0.9, W, H)
        img = jrender.render_arrays(
            act.means3d, act.scales, act.quats, act.opacities, act.shs,
            act.valid, *jcam_args(jc), jnp.zeros(3), sh_degree=1,
            width=W, height=H, cfg=JCFG, k_max=256).image * 0.7
        jviews.append(dataclasses.replace(jc, image=img))
        tviews.append(make_camera(R, np.zeros(3), 0.9, 0.9, W, H,
                                  image=np.asarray(img), device=CPU))
    kw = dict(cache_spts=True, use_frustum_culling=False, lambda_opacity=0.0)
    jtr, jlosses = joff.post_optimize_offloaded(
        joff.PackedStore.from_state(jst), jforest, jviews, budget=cap,
        post=JPost(**kw), cfg=JCFG, width=W, height=H, k_max=256,
        scene_extent=EXTENT, n_iters=9)
    jtr.flush()
    tstore = offload.PackedStore.from_state(tst)
    before = tstore.data.clone()
    ttr, tlosses = offload.post_optimize_offloaded(
        tstore, forest, tviews, budget=cap, post=PostConfig(**kw), cfg=CFG,
        width=W, height=H, k_max=256, scene_extent=EXTENT, n_iters=9,
        device=CPU)
    ttr.flush()
    tl = [float(x) for x in tlosses]
    np.testing.assert_allclose(tl, [float(x) for x in jlosses], rtol=1e-4)
    assert tl[-1] < tl[0]
    assert ttr.last_fetch == jtr.last_fetch <= 4
    assert not torch.equal(tstore.data, before)
    np.testing.assert_array_equal(ttr.slot_of_row, jtr.slot_of_row)
    assert_rows_close(unpacked(tstore.data.numpy()), unpacked(jtr.store.data),
                      lrs_over(9), 9)
