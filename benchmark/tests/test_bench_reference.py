"""The plain reference agrees with the port at a tiny size: the flat
render, the training step's loss and gradients, and the LOD stream frame
(the port's kernel wrappers run their plain versions on CPU tensors)."""

import math

import torch

from conftest import TINY

from benchmark.harness import core, data, reference

CPU = torch.device("cpu")


def _flat(seed=3):
    cfg = dict(core.cell_parts(core.load_bench(), "train-flat3M-1080p")[1],
               **TINY["train-flat3M-1080p"]["config"])
    return cfg, data.flat_scene(cfg, seed, CPU)


def _port_render(cfg, scene, cam):
    from hlod_gaussians_torch import render
    from hlod_gaussians_torch.config import RasterizerConfig
    means, scales, quats, op, shs = reference.activate(scene)
    rc = RasterizerConfig(backend="pallas", tile_w=cfg["tile"][0],
                          tile_h=cfg["tile"][1], max_dup=cfg["max_dup"])
    return render.render_arrays(
        means, scales, quats, op, shs, torch.ones_like(op, dtype=torch.bool),
        cam.view, cam.full_proj, cam.campos, torch.tensor(cam.tan_fovx),
        torch.tensor(cam.tan_fovy), torch.zeros(3), sh_degree=3,
        width=cam.width, height=cam.height, cfg=rc)


def test_flat_render_matches_the_port():
    cfg, scene = _flat()
    cam = data.yaw_camera(0.02, cfg["width"], cfg["height"], cfg["fovx"],
                          cfg["fovy"], CPU)
    port = _port_render(cfg, scene, cam)
    ref = reference.render(*reference.activate(scene), 3, cam,
                           tuple(cfg["tile"]))
    assert not bool(port.truncated)
    assert float(ref.mean()) > 0.01            # the frame is not empty
    assert float((port.image - ref).abs().max()) < 1e-5


def test_training_gradients_match_the_port():
    from hlod_gaussians_torch.config import (OptimizationConfig,
                                             RasterizerConfig)
    from hlod_gaussians_torch.models.gaussians import GaussianState
    from hlod_gaussians_torch.train import flat
    cfg, scene = _flat(4)
    traffic = core.cell_parts(core.load_bench(), "train-flat3M-1080p")[2]
    cam = data.yaw_camera(0.0, cfg["width"], cfg["height"], cfg["fovx"],
                          cfg["fovy"], CPU)
    gt = reference.render(*reference.activate(scene), 3, cam,
                          tuple(cfg["tile"]))
    start = data.perturb(scene, traffic, 4, CPU)
    n = start["xyz"].shape[0]
    g = GaussianState(**{k: start[k] for k in reference.LEAVES},
                      alive=torch.ones(n, dtype=torch.bool),
                      nodes=torch.full((n, 6), -1, dtype=torch.int32))
    params = {k: p.detach().requires_grad_(True)
              for k, p in g.params().items()}
    loss, _ = flat.step_loss(
        g, params, torch.zeros((n, 2)), cam.view, cam.full_proj, cam.campos,
        torch.tensor(cam.tan_fovx), torch.tensor(cam.tan_fovy), gt,
        torch.zeros(3), exposure_idx=0,
        opt=OptimizationConfig(**traffic["optimizer"]),
        cfg=RasterizerConfig(backend="pallas", tile_w=16, tile_h=16,
                             max_dup=cfg["max_dup"]),
        width=cfg["width"], height=cfg["height"], k_max=384, sh_degree=3,
        use_exposure=True, antialiasing=False)
    got = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    ref_loss, ref_g, _ = reference.loss_and_grads(
        start, cam, gt, 3, tuple(cfg["tile"]), traffic["optimizer"])
    assert math.isclose(float(loss.detach()), float(ref_loss), rel_tol=1e-5)
    for k in reference.LEAVES:
        scale = float(ref_g[k].abs().max())
        assert scale > 0, k
        assert float((got[k] - ref_g[k]).abs().max()) <= 1e-3 * scale, k


def test_lod_frame_matches_the_stream():
    from hlod_gaussians_torch import render
    from hlod_gaussians_torch.config import RasterizerConfig
    from hlod_gaussians_torch.hierarchy import cut
    cfg = dict(core.cell_parts(core.load_bench(),
                               "serve-lod8M-1080p-tau0")[1],
               **TINY["serve-lod8M-1080p-tau0"]["config"])
    tree = data.build_tree(*data.lod_leaves(cfg, 5, CPU))
    cut.sanity_check_hierarchy(tree["nodes"], tree["alive"])
    cam = data.yaw_camera(0.04, cfg["width"], cfg["height"], cfg["fovx"],
                          cfg["fovy"], CPU)
    for tau in (0.0, 3.0):
        target = 2.0 * (tau + 0.5) * cam.tan_fovx / (0.5 * cam.width)
        out, n_sel = render.render_lod_stream(
            tree["pos"], tree["scale"], tree["quat"], tree["opacity"],
            tree["sh"], tree["nodes"], tree["alive"], cam.view,
            cam.full_proj, cam.campos, torch.tensor(cam.tan_fovx),
            torch.tensor(cam.tan_fovy), torch.zeros(3), target, {},
            interp_table=cut.build_interp_table(
                dict(means3d=tree["pos"], scales=tree["scale"],
                     quats=tree["quat"], opacities=tree["opacity"],
                     shs=tree["sh"]), tree["nodes"]),
            sh_degree=3, width=cam.width, height=cam.height,
            cfg=RasterizerConfig(backend="pallas", tile_w=16, tile_h=16,
                                 max_dup=cfg["max_dup"]),
            use_frustum=False)
        ref, n_ref = reference.lod_frame(tree, cam, target, (16, 16), 3)
        assert int(n_sel) == n_ref > 0
        assert float((ref > 0).float().mean()) > 0.2     # not empty
        assert float((out.image - ref).abs().max()) < 1e-5
        assert torch.equal(reference.to_uint8(out.image),
                           reference.to_uint8(ref))


def test_tree_over_the_leaves():
    cfg = dict(core.cell_parts(core.load_bench(),
                               "serve-lod8M-1080p-tau0")[1],
               **TINY["serve-lod8M-1080p-tau0"]["config"])
    leaves = data.lod_leaves(cfg, 6, CPU)
    tree = data.build_tree(*leaves)
    n = leaves[0].shape[0]
    assert tree["nodes"].shape == (2 * n - 1, 6)
    # the leaves are the inputs, permuted
    got = tree["pos"][n - 1:]
    assert torch.equal(torch.sort(got[:, 0]).values,
                       torch.sort(leaves[0][:, 0]).values)
    # a parent's mean is a weighted mean of its children's
    par = torch.arange(n - 1)
    kids = torch.stack([tree["pos"][2 * par + 1], tree["pos"][2 * par + 2]])
    eps = 1e-4 * (1 + kids.abs().max())
    assert bool((tree["pos"][par] >= kids.min(0).values - eps).all())
    assert bool((tree["pos"][par] <= kids.max(0).values + eps).all())
    assert float(tree["opacity"].max()) <= 1.0
