"""The CUDA blend kernels (B1 forward, B2 backward) against their plain
PyTorch versions on the card, and the differentiable kernel path against
the same render on the CPU, the post-optimization slice (SPT cuts, MCMC
relocation and growth, one post step) on the card against the CPU, and
the out-of-core trainer (pinned host store, device-resident row cache
with and without prefetch) on the card against the CPU, a tiny
run_pipeline on the card against the same run on the CPU, the train and
post steps and an MCMC round repeated bitwise in PyTorch's default mode,
GMSD at 1080p against the CPU under the default cuDNN TF32 setting, and
bench_torch.py's full-size step. Every
test here is marked `cuda` and skips
without a GPU: a CUDA kernel has no CPU mode. This file imports neither JAX
nor the JAX package, so it runs where only PyTorch is installed:

    PYTHONPATH=. python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from hlod_gaussians_torch import render
from hlod_gaussians_torch.config import OptimizationConfig, RasterizerConfig
from hlod_gaussians_torch.ops import gaussian_math, rasterize_cuda
from hlod_gaussians_torch.ops.binning import bin_gaussians
from hlod_gaussians_torch.ops.rasterize_xla import (blend_backward_plain,
                                                    blend_features,
                                                    blend_forward_plain)
from hlod_gaussians_torch.utils.camera import make_camera

W, H = 96, 64
ATOL = 2e-5
GRAD_ATOL = 3e-4     # per-entry gradients, scaled by the largest magnitude

CASES = {
    "16x16": dict(tile=(16, 16), n=300, seed=5),
    "32x32-lod": dict(tile=(32, 32), n=300, seed=7, lod=True),
    "8x128-lod": dict(tile=(8, 128), n=300, seed=9, lod=True),
    "16x16-dense": dict(tile=(16, 16), n=800, seed=3, big=True),
    "16x8-sticky": dict(tile=(16, 8), n=600, seed=7, stacked=True),
    # B2 runs 4 pixels a thread on the tiles above, 2 on 8x8 and 1 on 8x4
    # and 12x8; the sticky walk wraps B2's entry ring, and the 90x61 frames
    # cut the last tile row and column
    "8x4": dict(tile=(8, 4), n=300, seed=11),
    "8x4-sticky": dict(tile=(8, 4), n=300, seed=7, stacked=True),
    "8x8-lod": dict(tile=(8, 8), n=300, seed=13, lod=True),
    "12x8-ragged-lod": dict(tile=(12, 8), n=300, seed=17, lod=True,
                            frame=(90, 61)),
    "32x32-ragged": dict(tile=(32, 32), n=300, seed=19, frame=(90, 61)),
}
# B1 alone: its sticky stop past several 32-entry batches at 4 pixels a
# thread over two warps, and 60-pixel tiles, which it runs one pixel a
# thread in row order with a partial last warp (B2 takes none)
B1_CASES = dict(CASES, **{
    "16x16-sticky": dict(tile=(16, 16), n=600, seed=7, stacked=True),
    "10x6-partial-warp": dict(tile=(10, 6), n=300, seed=21),
    "10x6-ragged-lod": dict(tile=(10, 6), n=300, seed=23, lod=True,
                            frame=(90, 61)),
})


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(dev, tile, n, seed, big=False, lod=False, stacked=False,
            frame=(W, H)):
    width, height = frame
    rng = np.random.default_rng(seed)
    if stacked:
        xyz = np.zeros((n, 3), np.float32)
        xyz[:, :2] = rng.uniform(-0.02, 0.02, (n, 2))
        xyz[:, 2] = np.linspace(3.0, 5.0, n)
        scales = np.full((n, 3), 0.08, np.float32)
        quats = np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))
        ops = np.full((n,), 0.035, np.float32)
    else:
        xyz = rng.normal(size=(n, 3)).astype(np.float32) * 1.2
        xyz[:, 2] = 4.0 + rng.uniform(-1, 1, n)
        scales = np.exp(rng.normal(size=(n, 3)) * 0.4
                        - (1.5 if big else 2.5)).astype(np.float32)
        quats = rng.normal(size=(n, 4)).astype(np.float32)
        ops = rng.uniform(0.2, 0.95, n).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=dev)
    cam = make_camera(np.eye(3), np.zeros(3), 0.9, 0.7, width, height,
                      device=dev)
    p = gaussian_math.project_gaussians(
        t(xyz), gaussian_math.compute_cov3d(t(scales), t(quats)), t(ops),
        cam.world_view, cam.full_proj, width, height, cam.focal_x,
        cam.focal_y, cam.tan_fovx, cam.tan_fovy)
    ts = t(rng.uniform(0, 1, n).astype(np.float32)) if lod else None
    kids = t(rng.integers(0, 4, n).astype(np.int32)) if lod else None
    bins = bin_gaussians(p.xy, p.depth, p.radius, p.valid, width, height,
                         *tile, 1 << 16, ext=p.ext, reff2=p.reff2)
    feats = blend_features(p.xy, p.conic, p.opacity,
                           t(rng.uniform(0, 1, (n, 3)).astype(np.float32)),
                           1.0 / torch.clamp_min(p.depth, 1e-6), ts, kids)
    return (feats, bins.sorted_gid, bins.tile_starts, bins.tile_counts), \
        dict(width=width, height=height, tile_w=tile[0], tile_h=tile[1],
             use_lod=lod)


@pytest.mark.cuda
@pytest.mark.parametrize("want_seen", [True, False], ids=["seen", "noseen"])
@pytest.mark.parametrize("case", list(B1_CASES))
def test_cuda_kernel_matches_plain(case, want_seen, cuda_device):
    """Kernel B1 against blend_forward_plain: image and final T to 2e-5,
    n_contrib and seen exactly; two launches give the same bits."""
    args, kw = _inputs(cuda_device, **B1_CASES[case])
    kw["want_seen"] = want_seen
    launches = rasterize_cuda.blend_forward.launches
    got = rasterize_cuda.blend_forward(*args, **kw)
    again = rasterize_cuda.blend_forward(*args, **kw)
    torch.cuda.synchronize()
    assert rasterize_cuda.blend_forward.launches == launches + 2
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)
    ref = blend_forward_plain(*args, **kw)
    torch.testing.assert_close(got[0], ref[0], atol=ATOL, rtol=0)
    torch.testing.assert_close(got[1], ref[1], atol=ATOL, rtol=0)
    assert torch.equal(got[2], ref[2])
    if want_seen:
        assert torch.equal(got[3], ref[3]) and bool(got[3].any())
    else:
        assert got[3] is None


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_inputs(cuda_device):
    args, kw = _inputs(cuda_device, (16, 16), 50, 1)
    feats, gid, starts, counts = args
    with pytest.raises(ValueError, match="float32"):
        rasterize_cuda.blend_forward(feats.double(), gid, starts, counts,
                                     **kw)
    with pytest.raises(ValueError, match="contiguous"):
        rasterize_cuda.blend_forward(feats.t().contiguous().t(), gid, starts,
                                     counts, **kw)
    with pytest.raises(ValueError, match="tile_starts"):
        rasterize_cuda.blend_forward(feats, gid, starts[:-1], counts, **kw)
    with pytest.raises(ValueError, match="1024"):
        rasterize_cuda.blend_forward(feats, gid, starts, counts,
                                     **dict(kw, tile_w=64, tile_h=32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_backward_matches_plain(case, cuda_device):
    """Kernel B2 against blend_backward_plain on B1's own final_t and
    n_contrib and random cotangents; two launches give the same bits."""
    args, kw = _inputs(cuda_device, **CASES[case])
    _, final_t, n_contrib, _ = rasterize_cuda.blend_forward(*args, **kw)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    h, w = kw["height"], kw["width"]
    g_img4 = torch.randn((4, h, w), generator=gen, device=cuda_device)
    g_ft = torch.randn((h, w), generator=gen, device=cuda_device)
    bargs = args + (final_t, n_contrib, g_img4, g_ft)
    launches = rasterize_cuda.blend_backward.launches
    got = rasterize_cuda.blend_backward(*bargs, **kw)
    again = rasterize_cuda.blend_backward(*bargs, **kw)
    torch.cuda.synchronize()
    assert rasterize_cuda.blend_backward.launches == launches + 2
    ref = blend_backward_plain(*bargs, **kw)
    scale = float(ref.abs().max())
    assert scale > 0
    assert float((got - ref).abs().max()) <= GRAD_ATOL * scale
    assert torch.equal(got, again)
    with pytest.raises(ValueError, match="multiple of 32"):
        rasterize_cuda.blend_backward(*bargs, **dict(kw, tile_w=5, tile_h=5))


@pytest.mark.cuda
@pytest.mark.parametrize("lod", [False, True], ids=["flat", "lod"])
def test_cuda_render_grads_match_cpu(lod, cuda_device):
    """render_arrays (pallas backend) differentiated on the card (B1 + B2 +
    the per-Gaussian reduction) against the same render on the CPU (the
    plain versions), per input tensor scaled by its largest gradient; a
    second backward on the card gives the same bits."""
    rng = np.random.default_rng(4)
    n = 300
    xyz = rng.normal(size=(n, 3)).astype(np.float32) * 1.2
    xyz[:, 2] = 4.0 + rng.uniform(-1, 1, n)
    arrays = dict(
        means=xyz,
        scales=np.exp(rng.normal(size=(n, 3)) * 0.4 - 2.5).astype(np.float32),
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        opac=rng.uniform(0.2, 0.95, n).astype(np.float32),
        shs=(rng.normal(size=(n, 4, 3)) * 0.3).astype(np.float32))
    ts = rng.uniform(0, 1, n).astype(np.float32)
    kids = rng.integers(0, 4, n).astype(np.int32)
    tgt = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    cfg = RasterizerConfig(backend="pallas", tile_w=16, tile_h=16,
                           max_dup=1 << 16)
    grads = {}
    for dev in (torch.device("cpu"), cuda_device, cuda_device):
        leaves = {k: torch.as_tensor(v, device=dev).requires_grad_(True)
                  for k, v in arrays.items()}
        cam = make_camera(np.eye(3), np.zeros(3), 0.9, 0.7, W, H, device=dev)
        t = lambda a: torch.as_tensor(a, device=dev)
        out = render.render_arrays(
            leaves["means"], leaves["scales"], leaves["quats"],
            leaves["opac"], leaves["shs"],
            torch.ones(n, dtype=torch.bool, device=dev), cam.world_view,
            cam.full_proj, cam.campos, cam.tan_fovx, cam.tan_fovy,
            t(np.array([0.2, 0.1, 0.3], np.float32)),
            t(ts) if lod else None, t(kids) if lod else None,
            sh_degree=1, width=W, height=H, cfg=cfg, use_lod=lod)
        loss = (torch.abs(out.image - t(tgt)).mean()
                + 0.1 * out.invdepth.mean())
        launches = rasterize_cuda.blend_backward.launches
        loss.backward()
        assert rasterize_cuda.blend_backward.launches == launches + (
            dev.type == "cuda")
        got = {k: v.grad.cpu() for k, v in leaves.items()}
        if dev.type in grads and dev.type == "cuda":
            for k, v in got.items():
                assert torch.equal(v, grads["cuda"][k]), k
        grads[dev.type] = got
    for k, ref in grads["cpu"].items():
        got = grads["cuda"][k]
        assert torch.isfinite(got).all(), k
        scale = float(ref.abs().max())
        assert scale > 0 and float((got - ref).abs().max()) <= \
            GRAD_ATOL * scale, k


def _leaves(n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    pts[:, 2] += 5.0
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return (pts, np.exp(rng.normal(size=(n, 3)) * 0.3 - 2.5).astype(
        np.float32), q, rng.uniform(0.3, 0.9, n).astype(np.float32),
        (rng.normal(size=(n, 16, 3)) * 0.2).astype(np.float32))


@pytest.mark.cuda
def test_cuda_hierarchy_build_matches_cpu(cuda_device):
    """The build on the card gives the CPU build's tree node for node, and
    its moments to the oracle suite's tolerances (covariances compared as
    matrices: a near tie in the rotation alignment may pick another of the
    equivalent axis permutations)."""
    from hlod_gaussians_torch.hierarchy import build
    from hlod_gaussians_torch.ops.gaussian_math import compute_cov3d
    leaves = _leaves(1000, 3)               # not a power of two
    cpu = build.build_hierarchy(*leaves, device=torch.device("cpu"))
    gpu = build.build_hierarchy(*leaves, device=cuda_device)
    for k in ("nodes", "leaf_point"):
        np.testing.assert_array_equal(getattr(gpu, k), getattr(cpu, k))
    np.testing.assert_allclose(gpu.pos, cpu.pos, rtol=0, atol=2e-5)
    cov = [compute_cov3d(torch.as_tensor(h.scale), torch.as_tensor(h.quat))
           for h in (gpu, cpu)]
    ref = cov[1].abs().max(dim=1).values.clamp_min(1e-8)
    assert float(((cov[0] - cov[1]).abs().max(dim=1).values / ref).max()) \
        < 5e-3
    np.testing.assert_allclose(gpu.opacity, cpu.opacity, rtol=5e-3,
                               atol=1e-5)
    np.testing.assert_allclose(gpu.sh, cpu.sh, rtol=0, atol=1e-4)
    for k in ("box_lo", "box_hi", "max_side"):
        np.testing.assert_array_equal(getattr(gpu, k), getattr(cpu, k))


@pytest.mark.cuda
@pytest.mark.parametrize("crossover", [1e9, 0.0], ids=["masked", "budget"])
def test_cuda_stream_frames_match_cpu(crossover, cuda_device):
    """Three render_lod_stream frames on the card (kernel B1, feedback by a
    pinned copy and an event) against the CPU path: images to 1e-4 (the
    card's projection may round the last bit otherwise), the same cut sizes
    and regulation state after every frame."""
    from hlod_gaussians_torch.hierarchy import build, cut
    h = build.build_hierarchy(*_leaves(300, 5), device=torch.device("cpu"))
    keys = ("pos", "scale", "quat", "opacity", "sh")
    cfg = RasterizerConfig(backend="pallas", tile_w=16, tile_h=16,
                           max_dup=1 << 14)
    states, outs = {}, {}
    for dev in (torch.device("cpu"), cuda_device):
        t = {k: torch.as_tensor(getattr(h, k), device=dev) for k in keys}
        nodes = torch.as_tensor(h.nodes, device=dev)
        alive = torch.ones(h.nodes.shape[0], dtype=torch.bool, device=dev)
        itab = cut.build_interp_table(
            dict(means3d=t["pos"], scales=t["scale"], quats=t["quat"],
                 opacities=t["opacity"].clamp(0, 1), shs=t["sh"]), nodes)
        st, seq = {}, []
        for i, target in enumerate((1e-9, 3e-3, 3e-3)):
            cam = make_camera(np.eye(3), np.array([0.05 * i, 0.0, 0.0]),
                              0.9, 0.7, W, H, device=dev)
            launches = rasterize_cuda.blend_forward.launches
            with torch.no_grad():
                out, n_sel = render.render_lod_stream(
                    t["pos"], t["scale"], t["quat"], t["opacity"].clamp(0, 1),
                    t["sh"], nodes, alive, cam.world_view, cam.full_proj,
                    cam.campos, cam.tan_fovx, cam.tan_fovy,
                    torch.zeros(3, device=dev), target, st,
                    interp_table=itab, sh_degree=3, width=W, height=H,
                    cfg=cfg, use_frustum=False, min_budget=16, md_floor=256,
                    masked_crossover=crossover)
            assert rasterize_cuda.blend_forward.launches == launches + (
                dev.type == "cuda")
            state = {k: v for k, v in st.items() if k != "pending"}
            seq.append((out.image.cpu(), int(n_sel), bool(out.truncated),
                        dict(state, path=st["pending"][1:])))
        outs[dev.type] = seq
    for (gi, gn, gt, gs), (ci, cn, ct, cs) in zip(outs["cuda"], outs["cpu"]):
        assert (gn, gt, gs) == (cn, ct, cs)
        torch.testing.assert_close(gi, ci, atol=1e-4, rtol=0)


def _post_scene(dev, n=200, cap=512, seed=6):
    """A small post-optimization state (built tree, 8 skybox rows) on
    `dev`, its SPT forest and the working set of a camera at the origin."""
    from hlod_gaussians_torch.config import PostConfig
    from hlod_gaussians_torch.data.dhier import DHier
    from hlod_gaussians_torch.hierarchy import build, spt
    from hlod_gaussians_torch.train import post
    pts, scales, quats, ops, shs = _leaves(n, seed)
    h = build.build_hierarchy(pts, scales, quats, ops, shs[:, :4],
                              device=torch.device("cpu"))
    d = DHier(sh_degree=1, pos=h.pos, quat=h.quat,
              log_scale=np.log(h.scale).astype(np.float32),
              opacity=np.clip(h.opacity, 0.01, 0.99).astype(np.float32),
              shs=h.sh.astype(np.float32), nodes=h.nodes)
    state = post.create_from_dhier(d, cap, skybox_num=8, scene_radius=3.0,
                                   device=dev)
    pcfg = PostConfig(spt_root_volume=1e-2, min_spt_size=4,
                      spt_target_granularity=0.05)
    forest = post.rebuild_spt(state, post=pcfg)
    cam = make_camera(np.eye(3), np.zeros(3), 0.9, 0.7, W, H, device=dev)
    cut = spt.spt_cut(forest, cap, cam.campos, cam.full_proj)
    return state, forest, cam, cut, pcfg


@pytest.mark.cuda
def test_cuda_spt_cut_matches_cpu(cuda_device):
    """The SPT forest built for the card and its cuts (frustum on and off,
    three multipliers, the budgeted cut) equal the CPU's exactly."""
    from hlod_gaussians_torch.hierarchy import spt
    (_, f_cpu, cam_cpu, _, _), (_, f_gpu, cam_gpu, _, _) = (
        _post_scene(dev) for dev in (torch.device("cpu"), cuda_device))
    assert f_gpu.n_spts == f_cpu.n_spts > 0
    for k in spt.SPTForest._fields:
        assert torch.equal(getattr(f_gpu, k).cpu(), getattr(f_cpu, k)), k
    cap = 512
    for frustum in (True, False):
        for mult in (0.5, 1.0, 3.0):
            a = spt.spt_cut(f_cpu, cap, cam_cpu.campos, cam_cpu.full_proj,
                            mult, use_frustum=frustum)
            b = spt.spt_cut(f_gpu, cap, cam_gpu.campos, cam_gpu.full_proj,
                            mult, use_frustum=frustum)
            assert torch.equal(a.gaussian_mask, b.gaussian_mask.cpu())
            assert torch.equal(a.spt_selected, b.spt_selected.cpu())
            assert int(a.n_selected) == int(b.n_selected) > 0
    a = spt.spt_cut_budgeted(f_cpu, cap, cam_cpu.campos, cam_cpu.full_proj,
                             50)
    b = spt.spt_cut_budgeted(f_gpu, cap, cam_gpu.campos, cam_gpu.full_proj,
                             50)
    assert torch.equal(a.gaussian_mask, b.gaussian_mask.cpu())


@pytest.mark.cuda
def test_cuda_relocate_gs_matches_cpu(cuda_device):
    """add_new_gs and relocate_gs on the card with the CPU run's host draws
    give the CPU's node table and alive exactly, parameters to 4 ulp."""
    from hlod_gaussians_torch import optim
    from hlod_gaussians_torch.hierarchy import mcmc
    from hlod_gaussians_torch.models.gaussians import NODE_CHILD_COUNT
    draws, out = [], []
    sample_hosts = mcmc.sample_hosts

    def recorded(probs, k, generator=None):
        draws.append(sample_hosts(probs, k, generator))
        return draws[-1]

    for dev in (torch.device("cpu"), cuda_device):
        state = _post_scene(dev)[0]
        leaf = torch.nonzero((state.nodes[:, NODE_CHILD_COUNT] == 0)
                             & state.alive)[:, 0]
        logit = state.opacity_logit.clone()
        logit[leaf[::11]] = -7.0                       # dead leaves
        state = dataclasses.replace(state, opacity_logit=logit)
        adam = optim.init_adam(state.params())
        if not out:         # the CPU run: a seeded generator, recorded
            gen = torch.Generator().manual_seed(0)
            add_kw = rel_kw = dict(generator=gen)
            mcmc.sample_hosts = recorded
        else:
            add_kw = dict(sampled=draws[0].to(dev))
            rel_kw = dict(sampled=draws[1].to(dev))
        try:
            g2, adam2, n_add = mcmc.add_new_gs(state, adam, 20, budget=64,
                                               **add_kw)
            g3, _, n_rel = mcmc.relocate_gs(g2, adam2, budget=64,
                                            max_depth=20, **rel_kw)
        finally:
            mcmc.sample_hosts = sample_hosts
        out.append((g3, int(n_add), int(n_rel)))
    (a, na, ra), (b, nb, rb) = out
    assert (na, ra) == (nb, rb) and na > 0 and ra > 0
    for k in ("nodes", "alive"):
        assert torch.equal(getattr(a, k), getattr(b, k).cpu()), k
    for k in ("xyz", "log_scale", "opacity_logit", "f_dc", "quat"):
        np.testing.assert_array_max_ulp(getattr(b, k).cpu().numpy(),
                                        getattr(a, k).numpy(), maxulp=4)


@pytest.mark.cuda
def test_cuda_post_train_step_matches_cpu(cuda_device):
    """One post_train_step on the card (B1, B2, the reduction, antialiasing
    on, the skybox's geometry frozen) against the CPU step (plain
    versions): Adam moments scaled to 3e-4, parameters to 1e-6 where
    |g| > 1e-3 max|g| and within 2 lr elsewhere; one B1 and one B2
    launch."""
    from hlod_gaussians_torch import optim
    from hlod_gaussians_torch.train import post
    gt = np.random.default_rng(8).uniform(0, 1, (3, H, W)).astype(np.float32)
    new = []
    for dev in (torch.device("cpu"), cuda_device):
        state, _, cam, cut, pcfg = _post_scene(dev)
        ts = post.init_post_train(dataclasses.replace(
            state, f_dc=state.f_dc + 0.2))
        cfg = RasterizerConfig(backend="pallas", tile_w=16, tile_h=16,
                               max_dup=1 << 14)
        launches = (rasterize_cuda.blend_forward.launches,
                    rasterize_cuda.blend_backward.launches)
        ts, aux = post.post_train_step(
            ts, cut.gaussian_mask, cam.world_view, cam.full_proj, cam.campos,
            cam.tan_fovx, cam.tan_fovy, torch.as_tensor(gt, device=dev),
            torch.zeros(3, device=dev), 3.0, post=pcfg, cfg=cfg, width=W,
            height=H)
        n = int(dev.type == "cuda")
        assert (rasterize_cuda.blend_forward.launches,
                rasterize_cuda.blend_backward.launches) == (
            launches[0] + n, launches[1] + n)
        assert not bool(aux.truncated) and np.isfinite(float(aux.loss))
        new.append(ts)
    ref, got = new
    lrs = optim.param_lrs(OptimizationConfig(), 0, 3.0)
    for k, m_ref in ref.adam.m.items():
        for part in ("m", "v"):
            r = getattr(ref.adam, part)[k]
            err = float((getattr(got.adam, part)[k].cpu() - r).abs().max())
            assert err <= GRAD_ATOL * max(float(r.abs().max()), 1e-30), \
                (part, k)
        gabs = m_ref.abs()
        big = gabs > 1e-3 * gabs.max()
        diff = (getattr(got.gaussians, k).cpu()
                - getattr(ref.gaussians, k)).abs()
        assert not big.any() or float(diff[big].max()) <= 1e-6, k
        assert float(diff.max()) <= 2 * lrs[k] + 1e-6, k
    assert not got.adam.m["xyz"][:8].any()


def _offload_scene(dev, cap=256, n=48, seed=3):
    """tests/test_offload.py's toy scene: 48 points, SH 1, on `dev`."""
    from hlod_gaussians_torch.models import gaussians as gm
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    pts[:, 2] += 4.0
    cols = rng.random((n, 3)).astype(np.float32)
    state = gm.create_from_points(pts, cols, capacity=cap, sh_degree=1,
                                  opacity_init=0.7,
                                  device=torch.device("cpu"))
    state = dataclasses.replace(state, **{
        k: getattr(state, k).to(dev) for k in
        ("xyz", "f_dc", "f_rest", "log_scale", "quat", "opacity_logit",
         "exposure", "alive", "nodes")})
    cam = make_camera(np.eye(3), np.zeros(3), 0.9, 0.9, 48, 48, device=dev)
    return state, cam


@pytest.mark.cuda
def test_cuda_packed_store_is_pinned(cuda_device):
    """The host stores that serve the card are page-locked and hold the
    CPU's values; the CPU's are plain."""
    from hlod_gaussians_torch import convert
    from hlod_gaussians_torch.train import offload
    gpu, _ = _offload_scene(cuda_device)
    cpu, _ = _offload_scene(torch.device("cpu"))
    store = offload.PackedStore.from_state(gpu)
    ref = offload.PackedStore.from_state(cpu)
    assert store.data.is_pinned() and not ref.data.is_pinned()
    assert store.data.device.type == "cpu"
    assert torch.equal(store.data, ref.data)
    carried = convert.packed_store_from_numpy(ref.data.numpy(), 1,
                                              device=cuda_device)
    assert carried.data.is_pinned() and torch.equal(carried.data, ref.data)
    host = offload.to_host_store(gpu)
    assert all(t.is_pinned() for t in host.params.values())


@pytest.mark.cuda
def test_cuda_resident_trainer_matches_cpu(cuda_device):
    """DeviceResidentTrainer on the card over tests/test_offload.py's
    overlapping working sets, with and without prefetch: fetch and evict
    counts and slot tables equal the CPU trainer's, one B1 and one B2
    launch a step, prefetch bitwise equal to no prefetch, and the flushed
    store within the post step's tolerances of the CPU's (moments scaled
    to 3e-4, parameters to 1e-6 a step where |m| > 1e-3 max|m|, within 2 lr
    a step elsewhere)."""
    from hlod_gaussians_torch import optim
    from hlod_gaussians_torch.train import offload
    sets = [np.arange(0, 32), np.arange(16, 40), np.arange(8, 36),
            np.arange(0, 24)]
    cfg = RasterizerConfig(backend="pallas", tile_w=16, tile_h=16,
                           max_dup=4096)
    runs = {}
    for dev, prefetch in ((torch.device("cpu"), False),
                          (cuda_device, False), (cuda_device, True)):
        state, cam = _offload_scene(dev)
        tr = offload.DeviceResidentTrainer(
            offload.PackedStore.from_state(state), budget=64, cfg=cfg,
            width=48, height=48, k_max=128, scene_extent=2.0, device=dev)
        gt = torch.full((3, 48, 48), 0.35, device=dev)
        log = []
        for i, rows in enumerate(sets):
            nxt = sets[i + 1] if prefetch and i + 1 < len(sets) else None
            before = (rasterize_cuda.blend_forward.launches,
                      rasterize_cuda.blend_backward.launches)
            loss, _ = tr.step(rows, cam.world_view, cam.full_proj,
                              cam.campos, cam.tan_fovx, cam.tan_fovy, gt,
                              torch.zeros(3, device=dev), prefetch_rows=nxt)
            n = int(dev.type == "cuda")
            assert (rasterize_cuda.blend_forward.launches,
                    rasterize_cuda.blend_backward.launches) == (
                before[0] + n, before[1] + n)
            assert np.isfinite(float(loss)) and not bool(tr.last_truncated)
            log.append((tr.last_fetch, tr.last_evict, tr.slot_of_row.copy(),
                        tr.row_of_slot.copy()))
        tr.flush()
        runs[(dev.type, prefetch)] = (log, tr.store.data.clone())
    ref_log, ref = runs[("cpu", False)]
    got_log, got = runs[("cuda", False)]
    pre_log, pre = runs[("cuda", True)]
    assert [r[:2] for r in ref_log] == [g[:2] for g in got_log] == \
        [p[:2] for p in pre_log]
    for r, g in zip(ref_log, got_log):
        assert np.array_equal(r[2], g[2]) and np.array_equal(r[3], g[3])
    assert torch.equal(pre, got)
    rp, rm, rv = offload.unpack_rows(ref, 1)
    gp, gm_, gv = offload.unpack_rows(got, 1)
    steps = len(sets)
    for k in rp:
        lr = max(optim.param_lrs(OptimizationConfig(), i, 2.0)[k]
                 for i in range(steps))
        for r, g in ((rm[k], gm_[k]), (rv[k], gv[k])):
            assert float((g - r).abs().max()) <= GRAD_ATOL * max(
                float(r.abs().max()), 1e-30), k
        big = rm[k].abs() > 1e-3 * rm[k].abs().max()
        diff = (gp[k] - rp[k]).abs()
        assert not big.any() or float(diff[big].max()) <= 1e-6 * steps, k
        assert float(diff.max()) <= 2 * steps * lr + 1e-6, k


class _SceneCamera:
    """A scene camera carrying its ready view; R and T place its center for
    the chunker."""

    def __init__(self, v, center):
        self.v = v
        self.R = np.eye(3)
        self.T = -np.asarray(center, np.float64)


def _pipeline_scene(dev):
    """tests/test_torch_full_pipeline.py's two-cluster scene (two chunks)
    with its views on `dev`; the targets rendered on the CPU."""
    from hlod_gaussians_torch.data.scene import SceneInfo
    from hlod_gaussians_torch.models import gaussians as gm
    cpu = torch.device("cpu")
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.normal(size=(24, 3)).astype(np.float32) * 0.3
                          + np.array([x0, 0.0, 4.0], np.float32)
                          for x0 in (-1.0, 1.0)])
    cols = rng.uniform(0.1, 0.9, pts.shape).astype(np.float32)
    act = gm.activate(gm.create_from_points(pts, cols, capacity=64,
                                            sh_degree=1, opacity_init=0.8,
                                            device=cpu))
    cfg = RasterizerConfig(backend="pallas", tile_w=16, tile_h=16,
                           max_dup=8192)
    infos = []
    for x0 in (-1.0, 1.0):
        for a in (-0.1, 0.1):
            R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                          [-np.sin(a), 0, np.cos(a)]])
            c = np.array([x0, 0.0, 0.0])
            cam = make_camera(R, -R.T @ c, 0.9, 0.9, 64, 64, device=cpu)
            img = render.render_arrays(
                act.means3d, act.scales, act.quats, act.opacities, act.shs,
                act.valid, cam.world_view, cam.full_proj, cam.campos,
                cam.tan_fovx, cam.tan_fovy, torch.zeros(3), sh_degree=1,
                width=64, height=64, cfg=cfg).image.numpy()
            v = make_camera(R, -R.T @ c, 0.9, 0.9, 64, 64, image=img,
                            exposure_idx=len(infos), device=dev)
            infos.append(_SceneCamera(v, c))
    return SceneInfo(points=pts, colors=cols, train_cameras=infos,
                     test_cameras=[], extent=5.0,
                     center=np.zeros(3, np.float32))


@pytest.mark.cuda
def test_cuda_run_pipeline_matches_cpu(cuda_device, tmp_path, monkeypatch):
    """A tiny run_pipeline on the card (two chunks, three chunk and two
    post steps, both from the scaffold the CPU run wrote) against the same
    run on the CPU: the merged node table equal, and every leaf of the
    card's tree matched one to one by position to a leaf of the CPU's
    within the train step's tolerance (2 lr a step plus 1e-6). Leaves are
    matched, not compared row by row: a scale moved within the tolerance
    can turn a kd split's axis (its longest box side) and put rows into
    other leaves of the same tree shape; interior rotations and scales are
    not compared (tests/test_torch_full_pipeline.py says why). Each post
    stage is then held node for node: post_optimize rerun on the card and
    on the CPU with the views and settings of that device's own call, from
    the CPU call's tree with every node's scales and rotation randomized,
    ends within 1e-6 a step where the CPU's gradient is large and within 2
    lr a step elsewhere (test_torch_post.assert_step_close's rule)."""
    from hlod_gaussians_torch import optim
    from hlod_gaussians_torch.config import ModelConfig, PostConfig
    from hlod_gaussians_torch.data.dhier import DHier
    from hlod_gaussians_torch.pipeline import full_train
    spec = dict(coarse_iters=3, chunk_iters=3, post_iters=2, skybox_num=4,
                coarse_capacity=128, chunk_capacity=256, k_max=256,
                mh_walk=True, post_densify_interval=1000, chunk_size=1.1,
                chunk_point_padding=0.5)
    opt = OptimizationConfig(iterations=50, densify_until_iter=0)
    cfg = RasterizerConfig(backend="pallas", tile_w=16, tile_h=16,
                           max_dup=8192)
    post_fn = full_train.post_optimize
    calls = dict(cpu=[], cuda=[])
    out = {}
    for name, dev in (("cpu", torch.device("cpu")), ("cuda", cuda_device)):
        def recorded(*a, _name=name, **kw):
            calls[_name].append((a, kw))
            return post_fn(*a, **kw)
        monkeypatch.setattr(full_train, "post_optimize", recorded)
        scaffold = str(tmp_path / "cpu" / "scaffold.npz")
        out[name] = full_train.run_pipeline(
            _pipeline_scene(dev), view_loader=lambda ci: ci.v,
            output_dir=str(tmp_path / name),
            pcfg=full_train.PipelineConfig(**spec), opt=opt,
            post=PostConfig(spt_root_volume=5e-3, min_spt_size=4), cfg=cfg,
            mcfg=ModelConfig(sh_degree=1, scaffold_file=(
                scaffold if name == "cuda" else "")), device=dev)
    t, c = out["cuda"], out["cpu"]
    np.testing.assert_array_equal(t.nodes, c.nodes)
    lr = {k: max(optim.param_lrs(opt, i, 5.0)[k] for i in range(5))
          for k in ("xyz", "f_dc", "log_scale", "opacity_logit")}
    leaf = c.nodes[:, 2] == 0
    t_pos, c_pos = t.pos[leaf], c.pos[leaf]
    match = np.argmin(np.linalg.norm(t_pos[:, None] - c_pos[None], axis=-1),
                      axis=1)
    assert np.unique(match).size == match.size
    for k, lk, f in (("pos", "xyz", 2), ("shs", "f_dc", 2),
                     ("log_scale", "log_scale", 2),
                     ("opacity", "opacity_logit", 0.5)):
        np.testing.assert_allclose(getattr(t, k)[leaf],
                                   getattr(c, k)[leaf][match], rtol=0,
                                   atol=f * 5 * lr[lk] + 1e-6, err_msg=k)

    rng = np.random.default_rng(5)
    assert len(calls["cpu"]) == len(calls["cuda"]) == 2
    for (ca, ckw), (ta, tkw) in zip(calls["cpu"], calls["cuda"]):
        assert ta[2:5] == ca[2:5]
        fields = ca[0]._asdict()
        n = fields["nodes"].shape[0]
        fields["log_scale"] = (fields["log_scale"] + 0.4 * rng.normal(
            size=(n, 3))).astype(np.float32)
        q = rng.normal(size=(n, 4))
        fields["quat"] = (q / np.linalg.norm(q, axis=1, keepdims=True)
                          ).astype(np.float32)
        ref = post_fn(DHier(**fields), *ca[1:], **ckw)
        got = post_fn(DHier(**fields), *ta[1:], **tkw)
        n_iters = ca[3]
        for k in ("xyz", "f_dc", "f_rest", "log_scale", "quat",
                  "opacity_logit", "exposure"):
            lr_k = max(optim.param_lrs(opt, i, ca[2])[k]
                       for i in range(n_iters))
            g = getattr(got.gaussians, k).cpu().numpy()
            r = getattr(ref.gaussians, k).numpy()
            m = np.abs(ref.adam.m[k].numpy())
            big = m > 1e-3 * m.max()
            diff = np.abs(g - r)
            assert diff[big].max(initial=0.0) <= 1e-6 * n_iters, k
            assert diff.max(initial=0.0) <= 2 * n_iters * lr_k + 1e-6, k
        for k in ("alive", "nodes"):
            np.testing.assert_array_equal(
                getattr(got.gaussians, k).cpu().numpy(),
                getattr(ref.gaussians, k).numpy())


def _dp_views(dev, n=2):
    """n views of the offload toy scene, yawing, with seeded targets."""
    cams = []
    for a in np.linspace(-0.1, 0.1, n):
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]])
        cams.append(make_camera(R, np.zeros(3), 0.9, 0.9, 48, 48,
                                device=dev))
    st = lambda k: torch.stack([torch.as_tensor(getattr(c, k)) for c in cams])
    gts = np.random.default_rng(9).uniform(0, 1, (n, 3, 48, 48))
    return (st("world_view"), st("full_proj"), st("campos"), st("tan_fovx"),
            st("tan_fovy"), torch.as_tensor(gts.astype(np.float32),
                                             device=dev))


@pytest.mark.cuda
def test_cuda_dp_train_step_matches_cpu(cuda_device):
    """dp_train_step over two views in one process on the card (one B1 and
    one B2 launch a view) against the same step on the CPU: the loss to
    rtol 1e-5, Adam moments scaled to 3e-4, parameters to 1e-6 where the
    gradient is large and within 2 lr elsewhere, denom and max_radii
    exact."""
    from hlod_gaussians_torch import optim
    from hlod_gaussians_torch.parallel import data_parallel as dp
    from hlod_gaussians_torch.train import flat
    out = []
    for dev in (torch.device("cpu"), cuda_device):
        state, _ = _offload_scene(dev)
        ts = flat.init_flat_train(state)
        launches = (rasterize_cuda.blend_forward.launches,
                    rasterize_cuda.blend_backward.launches)
        new, loss = dp.dp_train_step(
            ts, *_dp_views(dev), torch.zeros(3, device=dev), [0, 0], 5.0,
            cfg=RasterizerConfig(backend="pallas", tile_w=16, tile_h=16,
                                 max_dup=1 << 14),
            width=48, height=48, k_max=256, sh_degree=1)
        n = 2 * int(dev.type == "cuda")
        assert (rasterize_cuda.blend_forward.launches,
                rasterize_cuda.blend_backward.launches) == (
            launches[0] + n, launches[1] + n)
        out.append((new, float(loss)))
    (ref, ref_loss), (got, loss) = out
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    lrs = optim.param_lrs(OptimizationConfig(), 0, 5.0)
    for k, m_ref in ref.adam.m.items():
        r = m_ref
        err = float((got.adam.m[k].cpu() - r).abs().max())
        assert err <= GRAD_ATOL * max(float(r.abs().max()), 1e-30), k
        big = r.abs() > 1e-3 * r.abs().max()
        diff = (getattr(got.gaussians, k).cpu()
                - getattr(ref.gaussians, k)).abs()
        assert not big.any() or float(diff[big].max()) <= 1e-6, k
        assert float(diff.max()) <= 2 * lrs[k] + 1e-6, k
    assert torch.equal(got.denom.cpu(), ref.denom)
    assert torch.equal(got.max_radii.cpu(), ref.max_radii)


@pytest.mark.cuda
def test_cuda_chunk_parallel_step_equals_train_step(cuda_device):
    """chunk_parallel_step of two chunks on the card equals each chunk's
    own flat.train_step bitwise (the same kernels on the same inputs)."""
    from hlod_gaussians_torch.parallel import chunk_parallel as cpar
    from hlod_gaussians_torch.train import flat
    cfg = RasterizerConfig(backend="pallas", tile_w=16, tile_h=16,
                           max_dup=1 << 14)
    states = [flat.init_flat_train(_offload_scene(cuda_device, seed=s)[0])
              for s in (3, 4)]
    views = _dp_views(cuda_device)
    kw = dict(width=48, height=48, k_max=256, sh_degree=1,
              use_exposure=False, cfg=cfg)
    bts, aux = cpar.chunk_parallel_step(
        cpar.stack_states(states), *views, torch.zeros(3, device=cuda_device),
        [0, 0], 5.0, **kw)
    for i, ts in enumerate(cpar.unstack_states(bts)):
        one, a = flat.train_step(
            states[i], *(v[i] for v in views[:5]), views[5][i],
            torch.zeros(3, device=cuda_device), exposure_idx=0,
            scene_extent=5.0, **kw)
        assert torch.equal(aux.loss[i], a.loss)
        for k in ("xyz", "f_dc", "log_scale", "opacity_logit", "quat"):
            assert torch.equal(getattr(ts.gaussians, k),
                               getattr(one.gaussians, k)), k


@pytest.mark.cuda
def test_cuda_tile_parallel_gloo_world_matches_one_rank(cuda_device,
                                                        tmp_path):
    """render_tile_parallel and render_lod_tile_parallel in a Gloo world
    of two ranks on the card (B1 on each band) against render_arrays and
    render_lod_masked on one rank: n_selected equal, images to 2e-5."""
    import json
    import os
    import sys
    from hlod_gaussians_torch.hierarchy import build as hb
    from hlod_gaussians_torch.hierarchy import cut as hc
    from hlod_gaussians_torch.models import gaussians as gm
    from hlod_gaussians_torch.parallel.dryrun import spawn_world
    # by file: another installed package may own the name `tests`; the
    # spawned ranks inherit this sys.path
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_parallel_worker as worker

    state, cam = _offload_scene(torch.device("cpu"))
    act = gm.activate(state)
    z = {"flat/" + k: getattr(act, k).numpy() for k in
         ("means3d", "scales", "quats", "opacities", "shs", "valid")}
    rng = np.random.default_rng(21)
    pts = rng.normal(size=(40, 3)).astype(np.float32) * 0.5
    pts[:, 2] += 4.0
    h = hb.build_hierarchy(
        pts, np.full((40, 3), 0.05, np.float32),
        np.tile(np.array([1, 0, 0, 0], np.float32), (40, 1)),
        np.full((40,), 0.8, np.float32),
        rng.random((40, 1, 3)).astype(np.float32) - 0.5,
        device=torch.device("cpu"))
    params = dict(means3d=h.pos, scales=h.scale, quats=h.quat,
                  opacities=np.clip(h.opacity, 0, 1), shs=h.sh)
    z.update({"lod/" + k: np.asarray(v, np.float32)
              for k, v in params.items()})
    z.update({"lod/nodes": h.nodes, "lod/alive": np.ones(len(h.nodes), bool),
              "lod/target": np.float32(0.01)})
    for pre in ("flat/", "lod/"):
        for k, v in (("wv", cam.world_view), ("fp", cam.full_proj),
                     ("campos", cam.campos), ("tfx", cam.tan_fovx),
                     ("tfy", cam.tan_fovy)):
            z[pre + k] = v.numpy()
    # 6 tile rows of 8 pixels, 3 a band
    cfg = dict(backend="pallas", tile_w=16, tile_h=8, max_dup=1 << 14)
    z["spec"] = json.dumps(dict(tile_cfg=cfg, tile_wh=[48, 48]))
    np.savez(tmp_path / "in.npz", **z)
    launches = rasterize_cuda.blend_forward.launches
    spawn_world(worker.run_tasks, 2, (["tiles"], str(tmp_path / "in.npz"),
                                      str(tmp_path), "cuda"),
                device=cuda_device, timeout_s=300.0, tmpdir=str(tmp_path))
    t = lambda k: torch.as_tensor(z[k], device=cuda_device)
    with torch.no_grad():
        one = render.render_arrays(
            *(t("flat/" + k) for k in ("means3d", "scales", "quats",
                                       "opacities", "shs", "valid", "wv",
                                       "fp", "campos", "tfx", "tfy")),
            torch.zeros(3, device=cuda_device), sh_degree=1, width=48,
            height=48, cfg=RasterizerConfig(**cfg))
        lp = {k: t("lod/" + k) for k in params}
        lod, n_sel = render.render_lod_masked(
            *lp.values(), t("lod/nodes"), t("lod/alive"),
            *(t("lod/" + k) for k in ("wv", "fp", "campos", "tfx", "tfy")),
            torch.zeros(3, device=cuda_device), 0.01, None, None, None,
            hc.build_interp_table(lp, t("lod/nodes")), sh_degree=0,
            width=48, height=48, cfg=RasterizerConfig(**cfg),
            use_frustum=False)
    assert rasterize_cuda.blend_forward.launches == launches + 2
    for r in range(2):
        got = np.load(tmp_path / f"tiles_rank{r}.npz")
        assert not bool(got["pallas/flat_trunc"])
        np.testing.assert_allclose(got["pallas/flat"],
                                   one.image.cpu().numpy(), atol=ATOL)
        assert int(got["pallas/lod_n"]) == int(n_sel) > 0
        np.testing.assert_allclose(got["pallas/lod"],
                                   lod.image.cpu().numpy(), atol=ATOL)


@pytest.mark.cuda
def test_cuda_viewer_frames_match_cpu(cuda_device, tmp_path):
    """make_viewer's render_fn on the card against the same viewer on the
    CPU, over the same requests (a plain view, the SPT colours, a
    frozen cut): frames within 1 LSB, one B1 launch a frame."""
    import argparse
    from hlod_gaussians_torch import cli
    from hlod_gaussians_torch.data import dhier
    from hlod_gaussians_torch.hierarchy import build as hb
    from hlod_gaussians_torch.viewer.server import ViewerServer

    rng = np.random.default_rng(3)
    pts = rng.normal(size=(48, 3)).astype(np.float32) * 0.6
    pts[:, 2] += 4.0
    h = hb.build_hierarchy(
        pts, np.exp(rng.normal(size=(48, 3)) * 0.3 - 2.2).astype(np.float32),
        np.tile(np.array([1, 0, 0, 0], np.float32), (48, 1)),
        rng.uniform(0.4, 0.9, 48).astype(np.float32),
        (rng.random((48, 4, 3)).astype(np.float32) - 0.5) * 0.6,
        device=torch.device("cpu"))
    path = str(tmp_path / "t.dhier")
    dhier.save_dhier(path, dhier.DHier(
        sh_degree=1, pos=h.pos, quat=h.quat,
        log_scale=np.log(np.maximum(h.scale, 1e-12)).astype(np.float32),
        opacity=np.clip(h.opacity, 1e-4, 1 - 1e-6).astype(np.float32),
        shs=h.sh.astype(np.float32), nodes=h.nodes))
    wv = np.eye(4)
    wv[3, 2] = 0.0
    proj = np.asarray(make_camera(np.eye(3), np.zeros(3), 0.9, 0.7, 64, 48,
                                  device=torch.device("cpu")).full_proj)
    msgs = []
    for sliders in ({}, {"render_SPTs": 1}, {"freeze_view": 1}):
        m = dict(resolution_x=64, resolution_y=48, fov_x=0.9, fov_y=0.7,
                 z_near=0.01, z_far=100.0, slider=sliders,
                 view_matrix=list((wv * [1, -1, -1, 1]).flatten()),
                 view_projection_matrix=list((proj * [1, -1, 1, 1])
                                             .flatten()))
        msgs.append(ViewerServer.decode_camera(m))
    frames = {}
    for dev in (torch.device("cpu"), cuda_device):
        args = argparse.Namespace(hierarchy=path, host="127.0.0.1", port=0,
                                  backend="pallas", occlusion_cull=False)
        srv, render_fn = cli.make_viewer(args, dev)
        launches = rasterize_cuda.blend_forward.launches
        frames[dev.type] = [render_fn(cam, opts) for cam, opts in msgs]
        assert rasterize_cuda.blend_forward.launches == launches + (
            len(msgs) if dev.type == "cuda" else 0)
        srv.close()
    for a, b in zip(frames["cuda"], frames["cpu"]):
        assert a.shape == (48, 64, 3)
        assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1


@pytest.mark.cuda
def test_cuda_gmsd_matches_cpu_under_default_tf32(cuda_device):
    """GMSD of a seeded 1920x1080 pair on the card, under PyTorch's
    default cuDNN settings (allow_tf32 on, as a user's `eval` runs),
    against the CPU within 1e-5: the bound at which the CPU port holds to
    the JAX package (tests/test_torch_eval_viewer.py)."""
    from hlod_gaussians_torch.ops.perceptual import gmsd
    rng = np.random.default_rng(3)
    a = rng.random((3, 1080, 1920)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape).astype(np.float32) * 0.05, 0,
                1)
    cudnn = torch.backends.cudnn
    for x, y in ((a, b), (a, a)):
        ref = float(gmsd(torch.as_tensor(x), torch.as_tensor(y)))
        with cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                         allow_tf32=True):
            got = float(gmsd(torch.as_tensor(x, device=cuda_device),
                             torch.as_tensor(y, device=cuda_device)))
        assert abs(got - ref) <= 1e-5, (got, ref)


def _bench_flat_state(dev, stride=4):
    """Every stride-th Gaussian of the bench scene as a flat train state."""
    import bench_torch
    from hlod_gaussians_torch import convert
    from hlod_gaussians_torch.train import flat
    scene = {k: v[::stride] for k, v in bench_torch.bench_scene(
        100_000).items()}
    n = scene["xyz"].shape[0]
    arrays = dict(scene, exposure=np.eye(3, 4, dtype=np.float32)[None],
                  alive=np.ones(n, bool), nodes=np.full((n, 6), -1, np.int32))
    return flat.init_flat_train(convert.state_from_numpy(
        arrays, n_skybox=0, device=dev))


def _states_equal(a, b, fields):
    return {k: torch.equal(getattr(a, k), getattr(b, k)) for k in fields}


@pytest.mark.cuda
@pytest.mark.parametrize("step", ["post", "flat"])
def test_cuda_steps_are_repeatable_in_default_mode(step, cuda_device):
    """Two post_train_step (flat.train_step) calls from identical inputs on
    the card, in PyTorch's default mode (no deterministic algorithms, cuDNN
    free to choose): bitwise-equal losses, images, parameters and Adam
    moments. B2 uses no atomics and the per-Gaussian reduction is segment
    sums of sorted entries."""
    from hlod_gaussians_torch.train import flat, post
    assert not torch.are_deterministic_algorithms_enabled()
    bg = torch.zeros(3, device=cuda_device)
    if step == "post":
        state, _, cam, cut, pcfg = _post_scene(cuda_device, n=4000,
                                               cap=1 << 13)
        ts = post.init_post_train(dataclasses.replace(
            state, f_dc=state.f_dc + 0.2))
        gt = torch.as_tensor(np.random.default_rng(8).uniform(
            0, 1, (3, H, W)).astype(np.float32), device=cuda_device)

        def run():
            return post.post_train_step(
                ts, cut.gaussian_mask, cam.world_view, cam.full_proj,
                cam.campos, cam.tan_fovx, cam.tan_fovy, gt, bg, 3.0,
                post=pcfg, cfg=RasterizerConfig(tile_w=16, tile_h=16,
                                                max_dup=1 << 16),
                width=W, height=H)
    else:
        ts = _bench_flat_state(cuda_device)
        cam = make_camera(np.eye(3), np.zeros(3), 1.2, 0.8, 1920, 1080,
                          device=cuda_device)
        gt = torch.as_tensor(np.random.default_rng(8).uniform(
            0, 1, (3, 1080, 1920)).astype(np.float32), device=cuda_device)

        def run():
            return flat.train_step(
                ts, cam.world_view, cam.full_proj, cam.campos, cam.tan_fovx,
                cam.tan_fovy, gt, bg, exposure_idx=0, scene_extent=8.0,
                cfg=RasterizerConfig(backend="pallas", tile_w=32, tile_h=32,
                                     max_dup=352 * 1024, tight_binning=True),
                width=1920, height=1080, sh_degree=3)
    (a, aux_a), (b, aux_b) = run(), run()
    assert not bool(aux_a.truncated)
    assert torch.equal(aux_a.loss, aux_b.loss)
    assert torch.equal(aux_a.image, aux_b.image)
    fields = list(a.gaussians.params())
    assert all(_states_equal(a.gaussians, b.gaussians, fields).values())
    for part in ("m", "v"):
        for k, v in getattr(a.adam, part).items():
            assert torch.equal(v, getattr(b.adam, part)[k]), (part, k)


@pytest.mark.cuda
def test_cuda_mcmc_round_is_repeatable_in_default_mode(cuda_device):
    """sample_hosts over 2^22 rows, twice from one seed, draws the same
    rows (its CDF is an integer prefix sum; torch.multinomial's float scan
    on CUDA is not repeatable), and densify_round, grow and relocate, twice
    from one state and seed gives bitwise-equal trees and parameters."""
    from hlod_gaussians_torch.hierarchy import mcmc
    from hlod_gaussians_torch.models.gaussians import NODE_CHILD_COUNT
    from hlod_gaussians_torch.train import post
    probs = torch.rand((1 << 22,), generator=torch.Generator(
        device=cuda_device).manual_seed(3), device=cuda_device) ** 4
    draws = [mcmc.sample_hosts(probs, 8192, torch.Generator(
        device=cuda_device).manual_seed(0)) for _ in range(2)]
    assert torch.equal(draws[0], draws[1])

    state, _, _, _, pcfg = _post_scene(cuda_device, n=4000, cap=1 << 13)
    leaf = torch.nonzero((state.nodes[:, NODE_CHILD_COUNT] == 0)
                         & state.alive)[:, 0]
    logit = state.opacity_logit.clone()
    logit[leaf[::11]] = -7.0                                  # dead leaves
    ts = post.init_post_train(dataclasses.replace(state,
                                                  opacity_logit=logit))
    pcfg = dataclasses.replace(pcfg, grow_fraction=0.05)
    out = [post.densify_round(ts, torch.Generator(
        device=cuda_device).manual_seed(1), post=pcfg, budget=512)
        for _ in range(2)]
    (a, sa), (b, sb) = out
    assert int(sa["n_added_pairs"]) > 0 and int(sa["n_relocated"]) > 0
    assert all(int(sa[k]) == int(sb[k]) for k in sa)
    fields = list(a.gaussians.params()) + ["nodes", "alive"]
    assert all(_states_equal(a.gaussians, b.gaussians, fields).values())


@pytest.mark.cuda
def test_cuda_bench_step_is_untruncated(cuda_device):
    """bench_torch.py's step at its full size (1920x1080, the 100k-Gaussian
    bench scene, max_dup 352*1024) renders without truncation, and one
    step launches B1 and B2 once each and gives finite gradients."""
    import bench_torch
    leaves, render_fn = bench_torch.bench_step(
        cuda_device, width=1920, height=1080, n_pts=100_000,
        max_dup=352 * 1024)
    with torch.no_grad():
        out = render_fn(*leaves)
    assert not bool(out.truncated)
    assert tuple(out.image.shape) == (3, 1080, 1920)
    launches = (rasterize_cuda.blend_forward.launches,
                rasterize_cuda.blend_backward.launches)
    loss, grads = bench_torch.step_grads(render_fn, leaves)
    assert (rasterize_cuda.blend_forward.launches,
            rasterize_cuda.blend_backward.launches) == (
        launches[0] + 1, launches[1] + 1)
    assert np.isfinite(float(loss.detach()))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
