"""Multi-process dry run and the world launcher (port of
`dryrun_multichip`, __graft_entry__.py:60-205, and of
scripts/multihost_dryrun.py).

`spawn_world(fn, n, args)` starts n processes (`spawn`), joins each to a
Gloo world through a ``file://`` rendezvous and runs ``fn(rank, n,
*args)`` in every one, with a deadline for the whole world.
`dryrun_multichip(n)` runs, in a world of n ranks, one data-parallel step
on a toy scene (the gauss axis 2 wide when n is even and at least 4), a
tile-parallel flat frame and a tile-parallel LOD frame of a 24-leaf tree,
and a chunk-parallel step with its densification, and checks what the JAX
dry run checks: a finite loss, the shapes, a non-empty cut, no truncation
and some split.

    python -m hlod_gaussians_torch.parallel.dryrun 4          # on the card
    python -m hlod_gaussians_torch.parallel.dryrun 4 --cpu
"""

from __future__ import annotations

import datetime
import math
import os
import tempfile
import time
from typing import Callable, Sequence

import numpy as np
import torch


def _rank_entry(fn, rank, n, rendezvous, device, backend, timeout_s,
                threads, args):
    torch.set_num_threads(threads)
    from hlod_gaussians_torch.parallel import distributed as pdist
    pdist.initialize(init_method="file://" + rendezvous, world_size=n,
                     rank=rank, backend=backend, device=device,
                     timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn(rank, n, *args)
    finally:
        torch.distributed.destroy_process_group()


def spawn_world(fn: Callable, n: int, args: Sequence = (), *,
                device=torch.device("cuda"), backend: str = "gloo",
                timeout_s: float = 600.0, threads: int = 1,
                tmpdir: str = None) -> None:
    """Run ``fn(rank, n, *args)`` in n spawned processes joined to one
    ``backend`` world whose ranks run on ``device`` (the card by default).
    ``fn`` and ``args`` must pickle (a module-level function). Raises if a
    rank fails or the world outlives ``timeout_s``; every process is ended
    before it returns."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=tmpdir) as d:
        rendezvous = os.path.join(d, "rendezvous")
        procs = [ctx.Process(target=_rank_entry, args=(
            fn, r, n, rendezvous, str(device), backend, timeout_s, threads,
            tuple(args))) for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.0))
        finally:
            late = [p for p in procs if p.is_alive()]
            for p in late:
                p.terminate()
            for p in late:
                p.join(10.0)
        if late:
            raise TimeoutError(f"{len(late)} of {n} ranks still running "
                               f"after {timeout_s:.0f} s")
        failed = [(r, p.exitcode) for r, p in enumerate(procs)
                  if p.exitcode != 0]
        if failed:
            raise RuntimeError(f"ranks failed (rank, exit code): {failed}")


def toy_inputs(n_pts=256, cap=512, width=64, height=64, sh_degree=1, seed=0,
               device=torch.device("cuda")):
    """The JAX dry run's toy scene (__graft_entry__._toy_inputs): n_pts
    normal points at z = 4 and a camera at the origin, on ``device`` (the
    card by default)."""
    from hlod_gaussians_torch.models import gaussians as gm
    from hlod_gaussians_torch.utils.camera import make_camera

    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n_pts, 3)).astype(np.float32)
    pts[:, 2] += 4.0
    cols = rng.random((n_pts, 3)).astype(np.float32)
    state = gm.create_from_points(pts, cols, capacity=cap,
                                  sh_degree=sh_degree, opacity_init=0.7,
                                  device=device)
    cam = make_camera(np.eye(3), np.zeros(3), fovx=0.9, fovy=0.9,
                      width=width, height=height, device=device)
    return state, cam


def lod_tree(device):
    """The JAX dry run's 24-leaf tree (__graft_entry__.py:142-157): the
    built hierarchy's parameters, node table and alive mask on device."""
    from hlod_gaussians_torch.hierarchy import build as hb

    rng = np.random.default_rng(5)
    n = 24
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    pts[:, 2] += 4.0
    h = hb.build_hierarchy(
        pts, np.full((n, 3), 0.05, np.float32),
        np.tile(np.asarray([1, 0, 0, 0], np.float32), (n, 1)),
        np.full((n,), 0.8, np.float32),
        rng.random((n, 1, 3)).astype(np.float32) - 0.5, device=device)
    t = lambda a: torch.as_tensor(np.asarray(a), device=device)
    params = dict(means3d=t(h.pos), scales=t(h.scale), quats=t(h.quat),
                  opacities=t(np.clip(h.opacity, 0, 1)), shs=t(h.sh))
    m = h.nodes.shape[0]
    return params, t(h.nodes), torch.ones(m, dtype=torch.bool, device=device)


def _dryrun_rank(rank: int, n: int, device: str) -> None:
    import dataclasses

    from hlod_gaussians_torch.config import MeshConfig, RasterizerConfig
    from hlod_gaussians_torch.hierarchy import cut as hc
    from hlod_gaussians_torch.models import gaussians as gm
    from hlod_gaussians_torch.parallel import chunk_parallel as cpar
    from hlod_gaussians_torch.parallel import data_parallel as dp
    from hlod_gaussians_torch.parallel import tile_parallel as tp
    from hlod_gaussians_torch.train import flat

    dev = torch.device(device)
    say = print if rank == 0 else (lambda *a, **k: None)
    n_gauss = 2 if n % 2 == 0 and n >= 4 else 1
    n_data = n // n_gauss
    mesh = dp.make_mesh(n_data, n_gauss)

    width = height = 32
    cfg = RasterizerConfig(backend="pallas", tile_w=16, tile_h=8,
                           max_dup=1 << 12)
    state, cam = toy_inputs(n_pts=64, cap=128, width=width, height=height,
                            device=dev)
    ts = dp.shard_train_state(flat.init_flat_train(state), mesh)
    one = lambda x: torch.as_tensor(x, device=dev)[None]   # one view a rank
    new_ts, loss = dp.dp_train_step(
        ts, one(cam.world_view), one(cam.full_proj), one(cam.campos),
        one(cam.tan_fovx), one(cam.tan_fovy),
        torch.zeros((1, 3, height, width), device=dev),
        torch.zeros(3, device=dev), [0], 5.0, mesh=mesh, cfg=cfg,
        width=width, height=height, k_max=64, sh_degree=1,
        use_exposure=False)
    if not math.isfinite(float(loss)) or new_ts.step != 1:
        raise AssertionError(f"dp step: loss {float(loss)}, step "
                             f"{new_ts.step}")
    say(f"dryrun_multichip({n}): DP mesh={tuple(mesh.shape)} "
        f"loss={float(loss):.4f} OK", flush=True)

    # one frame banded across the tile axis
    t = math.gcd(n, 4)
    tile_mesh = dp.make_mesh_from_config(MeshConfig(data=n // t, tile=t))
    act = gm.activate(dp.gather_gaussians(new_ts.gaussians, mesh))
    with torch.no_grad():
        img, trunc = tp.render_tile_parallel(
            act.means3d, act.scales, act.quats, act.opacities, act.shs,
            act.valid, cam.world_view, cam.full_proj, cam.campos,
            cam.tan_fovx, cam.tan_fovy, torch.zeros(3, device=dev),
            tile_mesh, sh_degree=1, width=width, height=height, cfg=cfg,
            k_max=64)
    if tuple(img.shape) != (3, height, width) or bool(trunc):
        raise AssertionError(f"tile-parallel: {tuple(img.shape)}, "
                             f"truncated {bool(trunc)}")
    say(f"dryrun_multichip({n}): tile-parallel render OK ({t} bands)",
        flush=True)

    # a LOD frame: replicated cut and lerp, banded blend with the LOD alpha
    params, nodes, alive = lod_tree(dev)
    table = hc.build_interp_table(params, nodes)
    with torch.no_grad():
        img_l, n_sel, trunc_l = tp.render_lod_tile_parallel(
            params["means3d"], params["scales"], params["quats"],
            params["opacities"], params["shs"], nodes, alive,
            cam.world_view, cam.full_proj, cam.campos, cam.tan_fovx,
            cam.tan_fovy, torch.zeros(3, device=dev), 0.01, tile_mesh,
            interp_table=table, sh_degree=0, width=width, height=height,
            cfg=cfg, k_max=64, use_frustum=False)
    if (tuple(img_l.shape) != (3, height, width) or int(n_sel) <= 0
            or bool(trunc_l)):
        raise AssertionError(f"tile-parallel LOD: {tuple(img_l.shape)}, "
                             f"n_sel {int(n_sel)}, truncated "
                             f"{bool(trunc_l)}")
    say(f"dryrun_multichip({n}): tile-parallel LOD OK "
        f"(n_sel={int(n_sel)})", flush=True)

    # chunk-parallel: one chunk a data rank
    k = n_data
    chunks = [flat.init_flat_train(toy_inputs(
        n_pts=32, cap=64, width=width, height=height, seed=i,
        device=dev)[0]) for i in range(k)]
    bts = cpar.shard_chunk_states(cpar.stack_states(chunks), mesh)
    k_local = len(bts.step)
    rep = lambda x: torch.stack([torch.as_tensor(x, device=dev)] * k_local)
    bts2, aux = cpar.chunk_parallel_step(
        bts, rep(cam.world_view), rep(cam.full_proj), rep(cam.campos),
        rep(cam.tan_fovx), rep(cam.tan_fovy),
        torch.zeros((k_local, 3, height, width), device=dev),
        torch.zeros(3, device=dev), [0] * k_local, 5.0, cfg=cfg,
        width=width, height=height, k_max=64, sh_degree=1,
        use_exposure=False)
    if not bool(torch.isfinite(aux.loss).all()):
        raise AssertionError(f"chunk-parallel loss {aux.loss.tolist()}")
    say(f"dryrun_multichip({n}): chunk-parallel({k}) OK", flush=True)

    bts3 = dataclasses.replace(
        bts2, xyz_grad_accum=torch.full_like(bts2.xyz_grad_accum, 1e9),
        max_radii=torch.full_like(bts2.max_radii, 100.0))
    _, n_split = cpar.chunk_parallel_densify(bts3, 5.0)
    if int(n_split.sum()) <= 0:
        raise AssertionError("densify split nothing")
    say(f"dryrun_multichip({n}): chunk-parallel densify OK "
        f"(splits={n_split.tolist()})", flush=True)


def dryrun_multichip(n: int, device=torch.device("cuda"),
                     timeout_s: float = 600.0) -> None:
    """The multi-process dry run in a Gloo world of n ranks on ``device``
    (every rank on the same device)."""
    spawn_world(_dryrun_rank, n, (str(device),), device=device,
                timeout_s=timeout_s)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int, nargs="?", default=4)
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args()
    dryrun_multichip(a.n, torch.device("cpu") if a.cpu
                     else torch.device("cuda"))
