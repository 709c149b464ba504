#!/usr/bin/env python3
"""Bisect a pipeline run's quality between its chunk trees and its merged
tree, on a directory kept by `scripts/torch_pipeline_full_steps.py --keep
DIR` (the chunk_*/hierarchy.dhier_opt and center.txt files, merged.dhier,
and views.npz: the ring test views' cameras and ground-truth images).

    python3 scripts/torch_merge_bisect.py DIR [--taus 0 3 15] [--cpu-views N]
        [--dump PATH] [--region F] [--out PATH] [--device cuda|cpu]
        [--budget N] [--max-dup N]

For each chunk c, over the ring test views of the shell its leaves hold, it
prints the PSNR and the mean cut size (n_selected) at each tau of five
trees, each isolating one stage of the consolidation:

    T0  chunk c's own tree                      the baseline
    T1  merge.reweight_chunk(d_c, c, centers)   the falloff and the splice
    T2  the merged tree, every row outside chunk c's subtree at opacity 0
                                                the graft, the global root
                                                and the re-indexing
    T3  the merged tree                         the other chunks' nodes
    T4  T3 with a budget of the merged state's capacity (2^23 at the
        full count), so no node is dropped      the over-budget drop

The first row that falls more than 4 dB below the row above names the
stage. The merge is first recomputed from the chunk trees and checked equal
to merged.dhier, which also fixes each chunk's subtree rows. With
``--cpu-views N`` the first ring test view of each of the first N shells
is rendered again at tau 3 from T3 on the CPU through the plain versions, beside the
device's PSNR on the same views (a fault on the device's path shows as a
gap). ``--dump PATH`` writes T3's tau-3 render inputs on the first ring
test view (the cut's rows after interpolation, ts, kids, the camera, the
device's image and the ground truth) as a small .npz for a render by
another package. ``--region F`` splits T0's and T3's error at the first tau
between the frame's central square (|x| and |y| under F of the half
width and height: the ring test views look at their shell's center, and
in the pipeline scene 0.41 spans the chunk, 1.45 of its extent at the
cameras' 3.5) and the rest of the frame, which holds the neighbouring
shells. Writes the table as JSON to --out (default
chiprun_out/merge_bisect.json).
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TAUS = (0.0, 3.0, 15.0)
DROP_DB = 4.0
TREES = ("T0", "T1", "T2", "T3", "T4")


def save_views(path, views, shells, shell_centers):
    """The views' cameras, ground-truth images, shells (indices into
    `shell_centers`) and the shells' centers as one .npz."""
    def host(t):
        return t.detach().cpu().numpy()
    np.savez(path, shell=np.asarray(shells, np.int32),
             shell_centers=np.asarray(shell_centers, np.float32),
             width=np.asarray([v.width for v in views], np.int32),
             height=np.asarray([v.height for v in views], np.int32),
             world_view=np.stack([host(v.world_view) for v in views]),
             full_proj=np.stack([host(v.full_proj) for v in views]),
             campos=np.stack([host(v.campos) for v in views]),
             tan_fov=np.stack([[float(v.tan_fovx), float(v.tan_fovy)]
                               for v in views]).astype(np.float32),
             image=np.stack([host(v.image) for v in views]))


def load_views(path, dev):
    """(views as Cameras with their images on `dev`, shells [V], shell
    centers [S,3])."""
    import torch
    from hlod_gaussians_torch.utils.camera import Camera
    z = np.load(path)

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev)
    views = [Camera(width=int(z["width"][i]), height=int(z["height"][i]),
                    world_view=t(z["world_view"][i]),
                    full_proj=t(z["full_proj"][i]), campos=t(z["campos"][i]),
                    tan_fovx=t(z["tan_fov"][i, 0]),
                    tan_fovy=t(z["tan_fov"][i, 1]), image=t(z["image"][i]),
                    exposure_idx=i)
             for i in range(len(z["shell"]))]
    return views, z["shell"], z["shell_centers"]


def load_run(run_dir):
    """(chunk names, chunk trees, centers [K,3], merged tree) of a kept
    run, the chunks in run_pipeline's merge order."""
    from hlod_gaussians_torch.data import dhier as dhier_io
    from hlod_gaussians_torch.pipeline import chunking
    names = sorted(n for n in os.listdir(run_dir) if n.startswith("chunk_")
                   and os.path.exists(os.path.join(run_dir, n,
                                                   "hierarchy.dhier_opt")))
    dirs = [os.path.join(run_dir, n) for n in names]
    chunks = [dhier_io.load_dhier(os.path.join(d, "hierarchy.dhier_opt"))
              for d in dirs]
    merged = dhier_io.load_dhier(os.path.join(run_dir, "merged.dhier"))
    return names, chunks, chunking.load_chunk_centers(dirs), merged


def subtree_rows(merged):
    """[(first row, end row)] of each chunk's subtree under the global root,
    in graft order (merge_hierarchies appends the chunks in order)."""
    from hlod_gaussians_torch.models.gaussians import (NODE_FIRST_CHILD,
                                                       NODE_NEXT_SIBLING)
    roots, r = [], int(merged.nodes[0, NODE_FIRST_CHILD])
    while r > 0:
        roots.append(r)
        r = int(merged.nodes[r, NODE_NEXT_SIBLING])
    ends = roots[1:] + [merged.nodes.shape[0]]
    return list(zip(roots, ends))


def only_rows(d, lo, hi):
    """`d` with every row outside [lo, hi) at opacity 0."""
    op = np.zeros_like(d.opacity)
    op[lo:hi] = d.opacity[lo:hi]
    return d._replace(opacity=op)


def chunk_shell(chunk_center, shell_centers):
    """The shell whose center is nearest the chunk's in x and y (a chunk's
    center lies below its shell, at the cameras' height)."""
    d = shell_centers[:, :2] - np.asarray(chunk_center)[None, :2]
    return int(np.argmin(np.linalg.norm(d, axis=1)))


def structure(d):
    """Counts that tell a malformed tree: roots, depth, leaves, leaves'
    mean opacity, and rows unreachable from a root."""
    from hlod_gaussians_torch.models.gaussians import (NODE_CHILD_COUNT,
                                                       NODE_DEPTH,
                                                       NODE_PARENT)
    leaf = d.nodes[:, NODE_CHILD_COUNT] == 0
    return dict(nodes=int(d.nodes.shape[0]),
                roots=int((d.nodes[:, NODE_PARENT] < 0).sum()),
                depth=int(d.nodes[:, NODE_DEPTH].max()),
                unplaced=int((d.nodes[:, NODE_DEPTH] < 0).sum()),
                leaves=int(leaf.sum()),
                leaf_mean_opacity=float(d.opacity[leaf].mean()))


def state_of(d, dev):
    from hlod_gaussians_torch.train.post import create_from_dhier
    return create_from_dhier(
        d, capacity=1 << int(np.ceil(np.log2(d.pos.shape[0] + 1))),
        device=dev)


def evaluate(st, views, taus, budget, cfg):
    """[(PSNR, mean n_selected)] per tau, and the eval's warnings."""
    from hlod_gaussians_torch import eval as eval_mod
    warned = []
    rows = eval_mod.eval_views(
        st, views, [v.image for v in views], taus, level_is_tau=True,
        budget=budget, cfg=cfg, k_max=1024, warn=warned.append)
    return ([(float(r.psnr), float(r.mean_rendered)) for r in rows],
            [w for w in warned if "LPIPS" not in w])


def eval_cfg(max_dup):
    from hlod_gaussians_torch.config import RasterizerConfig
    return RasterizerConfig(backend="pallas", tile_w=16, tile_h=16,
                            max_dup=max_dup, tight_binning=True)


def bisect(run_dir, dev, taus=TAUS, budget=1 << 20, max_dup=1 << 23,
           cpu_views=0, dump=None, region=None, log=print):
    """The T0-T4 table of a kept run on `dev` (see the module docstring);
    returns it as a dict."""
    import torch
    from hlod_gaussians_torch.pipeline import merge
    t_start = time.perf_counter()
    names, chunks, centers, merged = load_run(run_dir)
    views, shells, shell_centers = load_views(
        os.path.join(run_dir, "views.npz"), dev)
    again = merge.merge_hierarchies(chunks, centers)
    same = all(np.array_equal(a, b) for a, b in zip(again, merged))
    ranges = subtree_rows(merged)
    log(f"bisect {run_dir}: {len(names)} chunks, merged {merged.nodes.shape[0]}"
        f" nodes; merge recomputed from the chunk trees equal to merged.dhier:"
        f" {same}; {len(views)} views; taus {list(taus)}")
    if not same or len(ranges) != len(names):
        raise AssertionError("merged.dhier is not the merge of the kept "
                             "chunk trees")
    cfg = eval_cfg(max_dup)
    res = dict(taus=list(taus), budget=budget, max_dup=max_dup,
               merged=structure(merged), chunks=[])
    st3 = state_of(merged, dev)
    for c, (name, d) in enumerate(zip(names, chunks)):
        shell = chunk_shell(centers[c], shell_centers)
        vs = [v for v, s in zip(views, shells) if s == shell]
        lo, hi = ranges[c]
        d1 = merge.reweight_chunk(d, c, centers)
        row = dict(chunk=name, shell=shell, rows=[lo, hi],
                   t0=structure(d), t1=structure(d1), trees={}, warnings={})
        # T3 and T4 evaluate the merged state built once (None)
        for tree, tree_d, b in zip(TREES, (d, d1, only_rows(merged, lo, hi),
                                           None, None),
                                   (budget,) * 4 + (st3.capacity,)):
            s = st3 if tree_d is None else state_of(tree_d, dev)
            row["trees"][tree], row["warnings"][tree] = evaluate(
                s, vs, taus, b, cfg)
            del s
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        res["chunks"].append(row)
        log(f"  {name} (shell {shell}, subtree rows [{lo}, {hi}); T0 "
            f"{row['t0']}; T1 {row['t1']})")
        for i, tau in enumerate(taus):
            cells = "  ".join(
                f"{t} {row['trees'][t][i][0]:7.3f} dB {row['trees'][t][i][1]:9.1f}"
                for t in TREES)
            log(f"    tau {tau:4.1f}: {cells}")
        stage = first_drop(row["trees"], taus)
        row["first_drop"] = stage
        log(f"    first drop > {DROP_DB} dB: {stage or 'none'}; warnings "
            f"{ {k: v for k, v in row['warnings'].items() if v} }")
        if region:
            s0 = state_of(d, dev)
            row["region"] = dict(
                T0=region_psnr(s0, vs, taus[0], budget, cfg, region),
                T3=region_psnr(st3, vs, taus[0], budget, cfg, region))
            del s0
            log(f"    tau {taus[0]:g}, centre / rest of the frame (dB): "
                + "  ".join(f"{t} {a:7.3f} / {b:7.3f}"
                            for t, (a, b) in row["region"].items()))
    res["t3_cut_tau0"] = cut_sizes(st3, views, 0.0)
    log(f"  T3's tau-0 cut per ring test view (n_selected before the "
        f"budget): {res['t3_cut_tau0']}; mean "
        f"{np.mean(res['t3_cut_tau0']):.1f}, over {budget}: "
        f"{sum(n > budget for n in res['t3_cut_tau0'])} of {len(views)}")
    if cpu_views:
        res["cpu_tau3"] = cpu_check(merged, views, shells, cpu_views, cfg,
                                    budget, dev, log)
    if dump:
        dump_cut(st3, views[0], dump, budget, cfg)
        log(f"  T3's tau-3 render inputs on view 0 written to {dump}")
    res["seconds"] = time.perf_counter() - t_start
    return res


def region_psnr(st, views, tau, budget, cfg, frac):
    """(PSNR inside, PSNR outside) the central square of |x|, |y| under
    `frac` of the half frame, the squared error pooled over `views`."""
    import torch
    from hlod_gaussians_torch import render as render_mod
    from hlod_gaussians_torch.hierarchy import cut as cut_mod
    from hlod_gaussians_torch.models import gaussians as gm
    act = gm.activate(st)
    pcache = cut_mod.build_parent_cache(
        st.nodes, act.means3d, torch.max(act.scales, dim=1).values)
    itab = cut_mod.build_interp_table(
        dict(means3d=act.means3d, scales=act.scales, quats=act.quats,
             opacities=act.opacities, shs=act.shs), st.nodes)
    sums = np.zeros(2)
    counts = np.zeros(2)
    for v in views:
        target = float(render_mod.tau_to_threshold(tau, float(v.tan_fovx),
                                                   v.width))
        with torch.no_grad():
            out, _ = render_mod.render_lod(
                act.means3d, act.scales, act.quats, act.opacities, act.shs,
                st.nodes, st.alive, v.world_view, v.full_proj, v.campos,
                v.tan_fovx, v.tan_fovy, torch.zeros(3, device=st.xyz.device),
                max(target, 1e-12), None, None, pcache, None, itab,
                sh_degree=st.sh_degree, width=v.width, height=v.height,
                budget=budget, n_skybox=st.n_skybox, cfg=cfg, k_max=1024)
        err = ((torch.clamp(out.image, 0.0, 1.0) - v.image) ** 2).mean(0)
        h, w = err.shape
        y, x = (torch.abs(torch.arange(n, device=err.device) - (n - 1) / 2)
                / (n / 2) for n in (h, w))
        inside = (y[:, None] < frac) & (x[None, :] < frac)
        sums += [float(err[inside].sum()), float(err[~inside].sum())]
        counts += [int(inside.sum()), int((~inside).sum())]
    return tuple(float(10 * np.log10(c / s)) for s, c in zip(sums, counts))


def cut_sizes(st, views, tau):
    """The dynamic cut's size at `tau` on each view (render_lod's
    n_selected, before the budget)."""
    import torch
    from hlod_gaussians_torch import render as render_mod
    from hlod_gaussians_torch.hierarchy import cut as cut_mod
    from hlod_gaussians_torch.models import gaussians as gm
    act = gm.activate(st)
    max_scale = torch.max(act.scales, dim=1).values
    pcache = cut_mod.build_parent_cache(st.nodes, act.means3d, max_scale)
    out = []
    for v in views:
        target = float(render_mod.tau_to_threshold(tau, float(v.tan_fovx),
                                                   v.width))
        cut = cut_mod.expand_to_size_dynamic(
            st.nodes, act.means3d, max_scale, st.alive, v.campos,
            v.world_view[:3, 2], target, pcache)
        out.append(int(torch.sum(cut.render_mask)))
    return out


def first_drop(trees, taus):
    """'T<k> tau <t>' of the first tree whose PSNR falls more than DROP_DB
    below the tree above it, at any tau; None if none does."""
    for k in range(1, len(TREES)):
        for i, tau in enumerate(taus):
            if trees[TREES[k - 1]][i][0] - trees[TREES[k]][i][0] > DROP_DB:
                return f"{TREES[k]} tau {tau:g}"
    return None


def cpu_check(merged, views, shells, n, cfg, budget, dev, log):
    """T3 at tau 3 on the first ring test view of each of the first `n`
    shells, on `dev` and on the CPU (plain versions), view by view."""
    import torch
    cpu = torch.device("cpu")
    pick = [int(np.where(shells == s)[0][0])
            for s in sorted(set(shells.tolist()))][:n]
    out = []
    for where, d in (("device", dev), ("cpu", cpu)):
        st = state_of(merged, d)
        for i in pick:
            v = views[i]
            if d != dev:
                v = dataclasses.replace(
                    v, **{f: getattr(v, f).to(d) for f in (
                        "world_view", "full_proj", "campos", "tan_fovx",
                        "tan_fovy", "image")})
            (p, n_sel), = evaluate(st, [v], [3.0], budget, cfg)[0]
            out.append(dict(where=where, view=int(i), shell=int(shells[i]),
                            psnr=p, n_selected=n_sel))
        del st
    for a, b in zip(out[:len(pick)], out[len(pick):]):
        log(f"  T3 tau 3, view {a['view']} (shell {a['shell']}): device "
            f"{a['psnr']:.3f} dB ({a['n_selected']:.0f} nodes), CPU "
            f"{b['psnr']:.3f} dB ({b['n_selected']:.0f} nodes)")
    return out


def dump_cut(st, view, path, budget, cfg, tau=3.0):
    """T3's render inputs at `tau` on `view` (the rows render_lod hands to
    render_arrays: interpolated, the valid ones only), with the camera, the
    rendered image and the ground truth."""
    import torch
    from hlod_gaussians_torch import render as render_mod
    from hlod_gaussians_torch.hierarchy import cut as cut_mod
    from hlod_gaussians_torch.models import gaussians as gm
    act = gm.activate(st)
    got = {}
    orig = render_mod.render_arrays

    def capture(*a, **kw):
        got["a"], got["kw"] = a, kw
        return orig(*a, **kw)
    target = float(render_mod.tau_to_threshold(tau, float(view.tan_fovx),
                                               view.width))
    pcache = cut_mod.build_parent_cache(
        st.nodes, act.means3d, torch.max(act.scales, dim=1).values)
    itab = cut_mod.build_interp_table(
        dict(means3d=act.means3d, scales=act.scales, quats=act.quats,
             opacities=act.opacities, shs=act.shs), st.nodes)
    render_mod.render_arrays = capture
    try:
        with torch.no_grad():
            out, n_sel = render_mod.render_lod(
                act.means3d, act.scales, act.quats, act.opacities, act.shs,
                st.nodes, st.alive, view.world_view, view.full_proj,
                view.campos, view.tan_fovx, view.tan_fovy,
                torch.zeros(3, device=st.xyz.device), target, None, None,
                pcache, None, itab, sh_degree=st.sh_degree, width=view.width,
                height=view.height, budget=budget, cfg=cfg, k_max=1024)
    finally:
        render_mod.render_arrays = orig
    a = got["a"]
    valid = a[5]

    def host(t):
        return t.detach().cpu().numpy()
    np.savez_compressed(
        path, means3d=host(a[0][valid]), scales=host(a[1][valid]),
        quats=host(a[2][valid]), opacities=host(a[3][valid]),
        shs=host(a[4][valid]), ts=host(a[12][valid]),
        kids=host(a[13][valid]), world_view=host(view.world_view),
        full_proj=host(view.full_proj), campos=host(view.campos),
        tan_fov=np.array([float(view.tan_fovx), float(view.tan_fovy)],
                         np.float32),
        width=view.width, height=view.height, sh_degree=st.sh_degree,
        tau=tau, n_selected=int(n_sel), image=host(out.image),
        truncated=bool(out.truncated), gt=host(view.image),
        max_dup=cfg.max_dup)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("run_dir")
    ap.add_argument("--taus", type=float, nargs="+", default=TAUS)
    ap.add_argument("--cpu-views", type=int, default=0)
    ap.add_argument("--dump", default=None)
    ap.add_argument("--region", type=float, default=None,
                    help="split the first tau's error at this fraction of "
                         "the half frame")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--budget", type=int, default=1 << 20,
                    help="the eval budget of T0-T3")
    ap.add_argument("--max-dup", type=int, default=1 << 23)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "merge_bisect.json"))
    args = ap.parse_args()
    import torch
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("torch_merge_bisect: no CUDA device", file=sys.stderr)
        return 1
    res = bisect(args.run_dir, dev, tuple(args.taus), budget=args.budget,
                 max_dup=args.max_dup, cpu_views=args.cpu_views, dump=args.dump,
                 region=args.region, log=lambda *a: print(*a, flush=True))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1, default=float)
    return 0


if __name__ == "__main__":
    sys.exit(main())
