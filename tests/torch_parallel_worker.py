"""Rank bodies of the torch.distributed worlds that tests/test_torch_parallel.py
and tests/test_torch_cuda.py spawn (hlod_gaussians_torch.parallel.dryrun
.spawn_world). This module imports neither JAX nor the JAX package, so the
spawned ranks do not either; pytest does not collect it.

Each task reads its inputs from an .npz the parent wrote and writes each
rank's results to ``<out>/<task>_rank<r>.npz``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

STATS = ("xyz_grad_accum", "denom", "max_radii")


# ---- train states as flat npz entries -----------------------------------

def state_arrays(leaves: dict, prefix: str = "") -> dict:
    """The leaves of a FlatTrainState (test_torch_train.leaves' layout) as
    flat npz entries under ``prefix``."""
    out = {f"{prefix}g/{k}": v for k, v in leaves["gaussians"].items()}
    for part in ("m", "v"):
        out.update({f"{prefix}{part}/{k}": v
                    for k, v in leaves["adam"][part].items()})
    out.update({f"{prefix}{k}": leaves[k] for k in STATS})
    out[f"{prefix}adam_step"] = np.asarray(leaves["adam"]["step"])
    out[f"{prefix}step"] = np.asarray(leaves["step"])
    return out


def arrays_leaves(z, prefix: str = "") -> dict:
    """The inverse of state_arrays."""
    def part(p):
        return {k[len(prefix) + len(p):]: np.asarray(z[k]) for k in z.keys()
                if k.startswith(prefix + p)}
    return dict(gaussians=part("g/"),
                adam=dict(m=part("m/"), v=part("v/"),
                          step=np.asarray(z[prefix + "adam_step"])),
                **{k: np.asarray(z[prefix + k]) for k in STATS},
                step=np.asarray(z[prefix + "step"]))


def torch_leaves(ts) -> dict:
    """A port FlatTrainState's tensors in the same layout."""
    g = ts.gaussians
    fields = ("xyz", "f_dc", "f_rest", "log_scale", "quat", "opacity_logit",
              "exposure", "alive", "nodes")
    c = lambda t: t.detach().cpu().numpy()
    return dict(gaussians={k: c(getattr(g, k)) for k in fields},
                adam=dict(m={k: c(v) for k, v in ts.adam.m.items()},
                          v={k: c(v) for k, v in ts.adam.v.items()},
                          step=ts.adam.step),
                **{k: c(getattr(ts, k)) for k in STATS}, step=ts.step)


def _load_state(z, prefix, device):
    from hlod_gaussians_torch import convert
    return convert.train_state_from_numpy(
        arrays_leaves(z, prefix), n_skybox=int(z[prefix + "n_skybox"]),
        device=device)


def _views(z, prefix, device):
    t = lambda k: torch.as_tensor(z[prefix + k], device=device)
    return (t("wv"), t("fp"), t("campos"), t("tfx"), t("tfy"), t("gts"),
            torch.as_tensor(z["bg"], device=device),
            [int(i) for i in z[prefix + "eidx"]])


def _cfgs(z, prefix):
    """The step settings stored under prefix + "spec": (optimization
    config, rasterizer config, the step's keywords)."""
    from hlod_gaussians_torch.config import (OptimizationConfig,
                                             RasterizerConfig)
    spec = json.loads(str(z[prefix + "spec"]))
    return (OptimizationConfig(**spec["opt"]),
            RasterizerConfig(**spec["cfg"]), spec["step"])


# ---- tasks ----------------------------------------------------------------

def task_dp(rank, n, z, device, prefix):
    """dp_train_step on mesh (n_data, n_gauss) from the stored state; the
    global views split over data. Writes the rank's shard, its mesh
    coordinates and the loss."""
    from hlod_gaussians_torch.parallel import data_parallel as dp

    opt, cfg, kw = _cfgs(z, prefix)
    n_data, n_gauss = (int(x) for x in z[prefix + "mesh"])
    mesh = dp.make_mesh(n_data, n_gauss)
    ts = dp.shard_train_state(_load_state(z, prefix, device), mesh)
    wv, fp, cp, tfx, tfy, gts, bg, eidx = _views(z, prefix, device)
    mine = dp.batch_sharding(mesh)
    new, loss = dp.dp_train_step(
        ts, mine(wv), mine(fp), mine(cp), mine(tfx), mine(tfy), mine(gts),
        bg, mine(eidx), kw["extent"], mesh=mesh, opt=opt, cfg=cfg,
        width=kw["width"], height=kw["height"], k_max=kw["k_max"],
        sh_degree=kw["sh_degree"], use_exposure=kw["use_exposure"],
        skybox_locked=kw["skybox_locked"],
        scale_big_gauss=kw["scale_big_gauss"])
    full = dp.gather_train_state(new, mesh)
    return dict(state_arrays(torch_leaves(new), "shard/"),
                **state_arrays(torch_leaves(full), "full/"),
                loss=np.float32(loss.item()),
                coord=np.asarray(mesh.get_coordinate()),
                dims=np.asarray(mesh.mesh_dim_names))


def task_mesh(rank, n, z, device):
    """make_mesh_from_config, make_global_mesh, global_view_batch,
    replicate and process_chunk_assignment in this world."""
    from hlod_gaussians_torch.config import MeshConfig
    from hlod_gaussians_torch.parallel import data_parallel as dp
    from hlod_gaussians_torch.parallel import distributed as pdist

    mesh = dp.make_mesh_from_config(MeshConfig(data=n // 2, tile=2))
    got = pdist.replicate(mesh, np.full(3, rank, np.float32), device=device)
    local = pdist.global_view_batch(mesh, np.full((1, 2), rank, np.float32),
                                    device=device)
    world = pdist.make_global_mesh()
    return dict(shape=np.asarray(tuple(mesh.shape)),
                dims=np.asarray(mesh.mesh_dim_names),
                global_shape=np.asarray(tuple(world.shape)),
                global_dims=np.asarray(world.mesh_dim_names),
                coord=np.asarray(mesh.get_coordinate()),
                replicated=got.cpu().numpy(), local=local.cpu().numpy(),
                chunks=np.asarray(pdist.process_chunk_assignment(7)))


def task_chunks(rank, n, z, device):
    """chunk_parallel_step and chunk_parallel_densify: K chunks over the
    data ranks."""
    from hlod_gaussians_torch import convert
    from hlod_gaussians_torch.parallel import chunk_parallel as cpar
    from hlod_gaussians_torch.parallel import data_parallel as dp

    opt, cfg, kw = _cfgs(z, "chunks/")
    mesh = dp.make_mesh(n, 1)
    leaves = arrays_leaves(z, "chunks/")
    bts = convert.stacked_train_state_from_numpy(
        leaves, n_skybox=int(z["chunks/n_skybox"]), device=device)
    bts = cpar.shard_chunk_states(bts, mesh)
    mine = dp.batch_sharding(mesh)
    wv, fp, cp, tfx, tfy, gts, bg, eidx = _views(z, "chunks/", device)
    stepped, aux = cpar.chunk_parallel_step(
        bts, mine(wv), mine(fp), mine(cp), mine(tfx), mine(tfy), mine(gts),
        bg, mine(eidx), kw["extent"], opt=opt, cfg=cfg, width=kw["width"],
        height=kw["height"], k_max=kw["k_max"], sh_degree=kw["sh_degree"],
        use_exposure=kw["use_exposure"],
        scale_big_gauss=kw["scale_big_gauss"])
    boosted = cpar.stack_states([
        _boost(ts) for ts in cpar.unstack_states(stepped)])
    dens, n_split = cpar.chunk_parallel_densify(boosted, kw["extent"],
                                                opt=opt)
    out = dict(loss=aux.loss.cpu().numpy(), n_split=n_split.cpu().numpy())
    for name, st in (("step", stepped), ("dens", dens)):
        for i, ts in enumerate(cpar.unstack_states(st)):
            out.update(state_arrays(torch_leaves(ts), f"{name}{i}/"))
    return out


def _boost(ts):
    """Densify statistics that select every leaf (the JAX dry run's)."""
    import dataclasses
    return dataclasses.replace(
        ts, xyz_grad_accum=torch.full_like(ts.xyz_grad_accum, 1e9),
        max_radii=torch.full_like(ts.max_radii, 100.0))


def task_tiles(rank, n, z, device):
    """render_tile_parallel of the stored flat scene ("flat/") and
    render_lod_tile_parallel of the stored tree ("lod/"), whichever the
    inputs hold, over the n ranks with the pallas and xla backends; the
    LOD frame's lod_preprocess kernel launches under "lod_fused"."""
    import dataclasses

    from hlod_gaussians_torch.config import RasterizerConfig
    from hlod_gaussians_torch.hierarchy import cut as hc
    from hlod_gaussians_torch.ops.lod_preprocess import lod_preprocess
    from hlod_gaussians_torch.parallel import data_parallel as dp
    from hlod_gaussians_torch.parallel import tile_parallel as tp

    spec = json.loads(str(z["spec"]))
    cfg = RasterizerConfig(**spec["tile_cfg"])
    w, h = spec["tile_wh"]
    mesh = dp.make_mesh(1, n, gauss_axis="tile")
    t = lambda k: torch.as_tensor(z[k], device=device)
    bg = torch.zeros(3, device=device)
    out = {}
    for backend in ("pallas", "xla"):
        c = dataclasses.replace(cfg, backend=backend)
        with torch.no_grad():
            if "flat/means3d" in z:
                img, trunc = tp.render_tile_parallel(
                    t("flat/means3d"), t("flat/scales"), t("flat/quats"),
                    t("flat/opacities"), t("flat/shs"), t("flat/valid"),
                    t("flat/wv"), t("flat/fp"), t("flat/campos"),
                    t("flat/tfx"), t("flat/tfy"), bg, mesh, sh_degree=1,
                    width=w, height=h, cfg=c, k_max=256)
                out.update({f"{backend}/flat": img.cpu().numpy(),
                            f"{backend}/flat_trunc": bool(trunc)})
            if "lod/nodes" in z:
                params = {k: t("lod/" + k) for k in
                          ("means3d", "scales", "quats", "opacities", "shs")}
                table = hc.build_interp_table(params, t("lod/nodes"))
                fused = lod_preprocess.launches
                img_l, n_sel, trunc_l = tp.render_lod_tile_parallel(
                    params["means3d"], params["scales"], params["quats"],
                    params["opacities"], params["shs"], t("lod/nodes"),
                    t("lod/alive"), t("lod/wv"), t("lod/fp"),
                    t("lod/campos"), t("lod/tfx"), t("lod/tfy"), bg,
                    float(z["lod/target"]), mesh, interp_table=table,
                    sh_degree=0, width=w, height=h, cfg=c, k_max=256,
                    use_frustum=False)
                out.update({f"{backend}/lod": img_l.cpu().numpy(),
                            f"{backend}/lod_n": int(n_sel),
                            f"{backend}/lod_trunc": bool(trunc_l),
                            f"{backend}/lod_fused":
                                lod_preprocess.launches - fused})
    return out


def task_pipeline(rank, n, z, device):
    """run_pipeline over the stored two-cluster scene; each rank logs its
    stages to rank<r>.jsonl in the shared output directory."""
    from hlod_gaussians_torch.utils.metrics import MetricsLogger

    spec = json.loads(str(z["spec"]))
    out_dir = spec["pipeline_out"]
    logger = MetricsLogger(os.path.join(out_dir, f"rank{rank}.jsonl"))
    try:
        merged = run_scene_pipeline(z, out_dir, device, logger)
    finally:
        logger.close()
    return dict(returned=merged is not None)


class SceneInfoCamera:
    """A scene camera carrying its ready view; R and T place its center
    for the chunker (tests/test_torch_full_pipeline.FakeInfo's layout)."""

    def __init__(self, v, campos):
        self.v = v
        self.R = np.eye(3)
        self.T = -np.asarray(campos, np.float64)


def run_scene_pipeline(z, out_dir, device, logger=None):
    """run_pipeline on the scene stored under "scene/" with the stored
    settings (the same call in one process and in every rank)."""
    from hlod_gaussians_torch.config import (ModelConfig, OptimizationConfig,
                                             PostConfig, RasterizerConfig)
    from hlod_gaussians_torch.data.scene import SceneInfo
    from hlod_gaussians_torch.pipeline import full_train
    from hlod_gaussians_torch.utils.camera import make_camera

    spec = json.loads(str(z["spec"]))
    p = spec["pipeline"]
    infos = []
    for i, (R, T, c, img) in enumerate(zip(z["scene/R"], z["scene/T"],
                                           z["scene/centers"],
                                           z["scene/images"])):
        v = make_camera(R, T, 0.9, 0.9, img.shape[2], img.shape[1],
                        image=torch.as_tensor(img, device=device),
                        exposure_idx=i, device=device)
        infos.append(SceneInfoCamera(v, c))
    scene = SceneInfo(points=z["scene/points"], colors=z["scene/colors"],
                      train_cameras=infos, test_cameras=[],
                      extent=float(z["scene/extent"]),
                      center=np.zeros(3, np.float32))
    return full_train.run_pipeline(
        scene, view_loader=lambda ci: ci.v, output_dir=out_dir,
        pcfg=full_train.PipelineConfig(**p["pcfg"]),
        opt=OptimizationConfig(**p["opt"]), post=PostConfig(**p["post"]),
        cfg=RasterizerConfig(**p["cfg"]),
        mcfg=ModelConfig(sh_degree=1), logger=logger, device=device)


TASKS = dict(dp=task_dp, mesh=task_mesh, chunks=task_chunks,
             tiles=task_tiles, pipeline=task_pipeline)


def run_tasks(rank: int, n: int, tasks, inputs: str, out_dir: str,
              device: str) -> None:
    """The spawn_world target: run each named task ("dp:<prefix>" passes
    the prefix of its stored state) and write its results."""
    z = np.load(inputs)
    dev = torch.device(device)
    for task in tasks:
        name, _, arg = task.partition(":")
        res = TASKS[name](rank, n, z, dev, *((arg,) if arg else ()))
        tag = task.replace(":", "_").replace("/", "")
        np.savez(os.path.join(out_dir, f"{tag}_rank{rank}.npz"), **res)
