"""Port parity for the rest of hierarchical LOD: the height cut against the
reference traversal (tests/fixtures/oracle/traversal.bin.gz), the box and
dynamic cuts with and without a parent cache, the interp table, and the LOD
entry points render_lod (boxes, pcache, interp table, cut_mask),
render_lod_masked and render_lod_stream against the JAX package: images atol 2e-5, n_selected exact, and the stream's regulation
state (budget, md, shrink, path) equal frame by frame."""

import gzip
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hlod_gaussians_tpu import render as jrender
from hlod_gaussians_tpu.config import RasterizerConfig as JConfig
from hlod_gaussians_tpu.data import dhier as jdhier
from hlod_gaussians_tpu.hierarchy import cut as jcut
from hlod_gaussians_tpu.utils.camera import make_camera as jmake_camera
from hlod_gaussians_torch import render as trender
from hlod_gaussians_torch.config import RasterizerConfig
from hlod_gaussians_torch.data import dhier as tdhier
from hlod_gaussians_torch.hierarchy import build as tbuild
from hlod_gaussians_torch.hierarchy import cut as tcut
from hlod_gaussians_torch.models.gaussians import NODE_PARENT
from hlod_gaussians_torch.utils.camera import make_camera

CPU = torch.device("cpu")
FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "oracle")
W = H = 64
ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: PyTorch's intra-op threads only contend with the
    other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(n=48, seed=13, gscale=0.05, quats=None):
    """A built tree (the JAX package's stream-test scene) as numpy arrays;
    the port's builder is held to the JAX one in test_torch_hier_build.py."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    pts[:, 2] += 4.0
    if quats is None:
        quats = np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))
    h = tbuild.build_hierarchy(
        pts, np.full((n, 3), gscale, np.float32), quats,
        np.full((n,), 0.8, np.float32),
        rng.random((n, 1, 3)).astype(np.float32) - 0.5, device=CPU)
    return dict(means3d=h.pos, scales=h.scale, quats=h.quat,
                opacities=np.clip(h.opacity, 0, 1), shs=h.sh,
                nodes=h.nodes, alive=np.ones(h.nodes.shape[0], bool),
                box_lo=h.box_lo, box_hi=h.box_hi, max_side=h.max_side)


_KEYS = ("means3d", "scales", "quats", "opacities", "shs", "nodes", "alive")


def _args(tree, jax_side, yaw=0.0):
    """(render arguments up to bg, boxes) for one side."""
    a = np.deg2rad(yaw)
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]])
    if jax_side:
        c = jmake_camera(R, np.zeros(3), 0.8, 0.8, W, H)
        conv = jnp.asarray
        bg = jnp.zeros(3)
    else:
        c = make_camera(R, np.zeros(3), 0.8, 0.8, W, H, device=CPU)
        conv = torch.as_tensor
        bg = torch.zeros(3)
    args = tuple(conv(tree[k]) for k in _KEYS) + (
        c.world_view, c.full_proj, c.campos, c.tan_fovx, c.tan_fovy, bg)
    boxes = tuple(conv(tree[k]) for k in ("box_lo", "box_hi", "max_side"))
    return args, boxes


def _same_render(tout, tn, jout, jn):
    assert int(tn) == int(jn)
    assert bool(tout.truncated) == bool(jout.truncated)
    np.testing.assert_allclose(tout.image.numpy(), np.asarray(jout.image),
                               atol=ATOL)


# ---------------------------------------------------------------------------
# cuts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def traversal():
    """The reference's expandToTarget on oracle.hier, as dhier node sets."""
    d = tdhier.load_dhier(os.path.join(FIXDIR, "hierarchy.dhier.gz"))
    h = tdhier.load_hier(os.path.join(FIXDIR, "oracle.hier.gz"))
    with gzip.open(os.path.join(FIXDIR, "traversal.bin.gz")) as f:
        raw = f.read()
    (nt,) = struct.unpack_from("<i", raw, 0)
    off, cases = 4, {}
    for _ in range(nt):
        t, n = struct.unpack_from("<ii", raw, off)
        off += 8
        cases[t] = np.frombuffer(raw, "<i4", count=n, offset=off)
        off += 4 * n
    assert off == len(raw) and nt == 6
    by_pos = {d.pos[i].tobytes(): i for i in range(d.pos.shape[0])}
    return d, {t: {by_pos[h.pos[i].tobytes()] for i in idx}
               for t, idx in cases.items()}


@pytest.mark.parametrize("case", range(6))
def test_expand_to_target_matches_reference_traversal(traversal, case):
    d, cases = traversal
    t = sorted(cases)[case]
    nodes = torch.tensor(d.nodes)
    alive = torch.ones(d.nodes.shape[0], dtype=torch.bool)
    mask = tcut.expand_to_target(nodes, alive, t)
    assert set(np.nonzero(mask.numpy())[0].tolist()) == cases[t]
    assert bool(tcut.is_hierarchy_cut(nodes, mask, alive))


@pytest.mark.parametrize("metric", ["box", "dynamic"])
@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("target", [1e-9, 0.01, 0.03])
def test_cut_matches_jax(metric, cached, target):
    tree = _tree()
    ta, ja = _args(tree, False)[1], _args(tree, True)[1]
    t_nodes, j_nodes = torch.as_tensor(tree["nodes"]), jnp.asarray(
        tree["nodes"])
    t_alive, j_alive = torch.as_tensor(tree["alive"]), jnp.asarray(
        tree["alive"])
    vp = np.array([0.1, -0.2, 0.0], np.float32)
    if metric == "box":
        tpc = tcut.build_parent_cache_box(t_nodes, *ta) if cached else None
        jpc = jcut.build_parent_cache_box(j_nodes, *ja) if cached else None
        got = tcut.expand_to_size_box(t_nodes, *ta, t_alive,
                                      torch.as_tensor(vp), target, tpc)
        ref = jcut.expand_to_size_box(j_nodes, *ja, j_alive,
                                      jnp.asarray(vp), target, jpc)
    else:
        ms = tree["scales"].max(axis=1)
        pos = tree["means3d"]
        tpc = tcut.build_parent_cache(t_nodes, torch.as_tensor(pos),
                                      torch.as_tensor(ms)) if cached else None
        jpc = jcut.build_parent_cache(j_nodes, jnp.asarray(pos),
                                      jnp.asarray(ms)) if cached else None
        zdir = np.array([0.0, 0.0, 1.0], np.float32)
        got = tcut.expand_to_size_dynamic(
            t_nodes, torch.as_tensor(pos), torch.as_tensor(ms), t_alive,
            torch.as_tensor(vp), torch.as_tensor(zdir), target, tpc)
        ref = jcut.expand_to_size_dynamic(
            j_nodes, jnp.asarray(pos), jnp.asarray(ms), j_alive,
            jnp.asarray(vp), jnp.asarray(zdir), target, jpc)
    np.testing.assert_array_equal(got.render_mask.numpy(),
                                  np.asarray(ref.render_mask))
    np.testing.assert_array_equal(got.kids.numpy(), np.asarray(ref.kids))
    np.testing.assert_allclose(got.ts.numpy(), np.asarray(ref.ts), atol=1e-6)
    np.testing.assert_allclose(got.size.numpy(), np.asarray(ref.size),
                               rtol=1e-6)
    assert got.render_mask.any()
    assert bool(tcut.is_hierarchy_cut(t_nodes, got.render_mask, t_alive))


def test_heights_frustum_and_checks_match_jax():
    tree = _tree(n=40, seed=2)
    nodes, alive = tree["nodes"], tree["alive"]
    np.testing.assert_array_equal(
        tcut.node_heights(torch.as_tensor(nodes), torch.as_tensor(alive))
        .numpy(), np.asarray(jcut.node_heights(jnp.asarray(nodes),
                                               jnp.asarray(alive))))
    # narrow enough that some of the tree lies outside
    c = make_camera(np.eye(3), np.zeros(3), 0.3, 0.2, W, H, device=CPU)
    jc = jmake_camera(np.eye(3), np.zeros(3), 0.3, 0.2, W, H)
    planes = tcut.frustum_planes(c.full_proj)
    np.testing.assert_allclose(planes.numpy(), np.asarray(
        jcut.frustum_planes(jc.full_proj)), atol=1e-6)
    radius = 3.0 * tree["scales"].max(axis=1)
    inside = tcut.sphere_in_frustum(torch.as_tensor(tree["means3d"]),
                                    torch.as_tensor(radius), planes)
    np.testing.assert_array_equal(inside.numpy(), np.asarray(
        jcut.sphere_in_frustum(jnp.asarray(tree["means3d"]),
                               jnp.asarray(radius), jnp.asarray(
                                   planes.numpy()))))
    assert inside.any() and not inside.all()
    # the builder's tree passes the structural check; a broken back-pointer
    # does not
    tcut.sanity_check_hierarchy(nodes, alive)
    bad = nodes.copy()
    bad[5, NODE_PARENT] = 0 if bad[5, NODE_PARENT] != 0 else 1
    with pytest.raises(ValueError):
        tcut.sanity_check_hierarchy(bad, alive)
    div = tcut.bounding_sphere_divergence(
        torch.as_tensor(nodes), torch.as_tensor(tree["means3d"]),
        torch.as_tensor(tree["scales"].max(axis=1)), torch.as_tensor(alive),
        torch.Generator().manual_seed(0), n_samples=256)
    assert 0.0 <= float(div) <= 1.0


def test_interp_table_matches_parents_and_jax():
    rng = np.random.default_rng(11)
    q = rng.normal(size=(48, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    tree = _tree(quats=q)
    m = tree["nodes"].shape[0]
    keys = ("means3d", "scales", "quats", "opacities", "shs")
    tp = {k: torch.as_tensor(tree[k]) for k in keys}
    jp = {k: jnp.asarray(tree[k]) for k in keys}
    table = tcut.build_interp_table(tp, torch.as_tensor(tree["nodes"]))
    jtable = jcut.build_interp_table(jp, jnp.asarray(tree["nodes"]))
    np.testing.assert_array_equal(table.feats.numpy(),
                                  np.asarray(jtable.feats).T)

    idx = rng.integers(0, m, 32)
    ts = rng.random(32).astype(np.float32)
    parent = np.clip(tree["nodes"][idx, NODE_PARENT], 0, m - 1)
    ref = tcut.interpolate_with_parents(tp, torch.as_tensor(idx),
                                        torch.as_tensor(parent),
                                        torch.as_tensor(ts))
    got = tcut.interpolate_from_table(table, torch.as_tensor(idx),
                                      torch.as_tensor(ts))
    jgot = jcut.interpolate_from_table(jtable, jnp.asarray(idx),
                                       jnp.asarray(ts))
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy(),
                                      err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(jgot[k]),
                                   atol=1e-6, err_msg=k)

    mask = rng.random(m) < 0.5
    all_ts = rng.random(m).astype(np.float32)
    got = tcut.interpolate_all_masked(table, torch.as_tensor(all_ts),
                                      torch.as_tensor(mask))
    jgot = jcut.interpolate_all_masked(jtable, jnp.asarray(all_ts),
                                       jnp.asarray(mask))
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(jgot[k]),
                                   atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# renders
# ---------------------------------------------------------------------------

def test_render_lod_boxes_pcache_table_matches_jax():
    """The budgeted path with every optional input, on the kernel path
    (pallas: B1's plain version here, the Pallas kernel in interpret mode on
    the JAX side), in the JAX package's argument order."""
    tree = _tree()
    (targs, tboxes), (jargs, jboxes) = _args(tree, False), _args(tree, True)
    tnodes, jnodes = targs[5], jargs[5]
    tpc = tcut.build_parent_cache_box(tnodes, *tboxes)
    jpc = jcut.build_parent_cache_box(jnodes, *jboxes)
    tt = tcut.build_interp_table(dict(zip(_KEYS[:5], targs[:5])), tnodes)
    jt = jcut.build_interp_table(dict(zip(_KEYS[:5], jargs[:5])), jnodes)
    target = float(trender.tau_to_threshold(3.0, float(targs[10]), W))
    kw = dict(sh_degree=0, width=W, height=H, budget=96, k_max=128)
    tout, tn = trender.render_lod(
        *targs, target, tboxes, None, tpc, None, tt,
        cfg=RasterizerConfig(backend="pallas", tile_w=16, tile_h=16,
                             max_dup=4096), **kw)
    jout, jn = jrender.render_lod(
        *jargs, target, jboxes, None, jpc, None, jt,
        cfg=JConfig(backend="pallas", tile_w=16, tile_h=16, max_dup=4096),
        **kw)
    _same_render(tout, tn, jout, jn)
    assert 0 < int(tn) < tree["nodes"].shape[0]

    # an externally maintained cut replaces the size rule's selection
    mask = np.zeros(tree["nodes"].shape[0], bool)
    mask[tree["nodes"][:, NODE_PARENT] == 0] = True
    tout, tn = trender.render_lod(
        *targs, target, None, torch.as_tensor(mask),
        cfg=RasterizerConfig(tile_w=16, tile_h=16, max_dup=4096), **kw)
    jout, jn = jrender.render_lod(
        *jargs, target, None, jnp.asarray(mask),
        cfg=JConfig(tile_w=16, tile_h=16, max_dup=4096), **kw)
    _same_render(tout, tn, jout, jn)
    assert int(tn) == 2


def test_render_lod_masked_matches_jax():
    tree = _tree()
    (targs, _), (jargs, _) = _args(tree, False), _args(tree, True)
    cfg = RasterizerConfig(tile_w=16, tile_h=16, max_dup=4096)
    jcfg = JConfig(tile_w=16, tile_h=16, max_dup=4096)
    kw = dict(sh_degree=0, width=W, height=H, k_max=128, use_frustum=False)
    tout, tn = trender.render_lod_masked(*targs, 0.01, cfg=cfg, **kw)
    jout, jn = jrender.render_lod_masked(*jargs, 0.01, cfg=jcfg, **kw)
    _same_render(tout, tn, jout, jn)
    # the masked path renders what the budgeted one does
    bout, bn = trender.render_lod(*targs, 0.01, budget=96, cfg=cfg, **kw)
    _same_render(bout, bn, jout, jn)


def _state_view(st):
    """The regulation state, without the in-flight feedback tensors."""
    out = {k: v for k, v in st.items() if k != "pending"}
    if "pending" in st:
        _, budget, md = st["pending"]
        out["pending"] = (budget, md)
    return out


@pytest.mark.parametrize("crossover", [1e9, 0.0], ids=["masked", "budget"])
def test_render_lod_stream_matches_jax_frame_by_frame(crossover):
    """Eight frames of a yawing camera at two granularities (the capacity
    truncates and grows, the budget shrinks after its patience): the same
    images, cut sizes, and regulation state after every frame."""
    tree = _tree()
    m = tree["nodes"].shape[0]
    keys = _KEYS[:5]
    ttab = tcut.build_interp_table(
        {k: torch.as_tensor(tree[k]) for k in keys},
        torch.as_tensor(tree["nodes"]))
    jtab = jcut.build_interp_table({k: jnp.asarray(tree[k]) for k in keys},
                                   jnp.asarray(tree["nodes"]))
    kw = dict(sh_degree=0, width=W, height=H, k_max=128, use_frustum=False,
              min_budget=8, md_floor=64, masked_crossover=crossover)
    t_st, j_st = {}, {}
    for i, target in enumerate((1e-9, 1e-9) + (0.05,) * 5 + (1e-9,)):
        (targs, _), (jargs, _) = (_args(tree, False, yaw=2.0 * i),
                                  _args(tree, True, yaw=2.0 * i))
        tout, tn = trender.render_lod_stream(
            *targs, target, t_st, interp_table=ttab,
            cfg=RasterizerConfig(tile_w=16, tile_h=16, max_dup=8192), **kw)
        jout, jn = jrender.render_lod_stream(
            *jargs, jnp.float32(target), j_st, interp_table=jtab,
            cfg=JConfig(tile_w=16, tile_h=16, max_dup=8192), **kw)
        _same_render(tout, tn, jout, jn)
        assert _state_view(t_st) == _state_view(j_st), i
    path = "MASKED" if crossover else t_st["budget"]
    assert t_st["pending"][1] == path and int(tn) < m
    assert t_st["budget"] == 48 and t_st["n_truncated_frames"] >= 2


def test_stream_truncation_recovery_matches_jax():
    """The JAX package's truncation case (test_hierarchy_cut.py): a tiny
    md_floor truncates the first frames, the n_dup feedback grows the
    capacity until frames stop truncating, and then it stays."""
    tree = _tree(gscale=0.45)
    (targs, _), (jargs, _) = _args(tree, False), _args(tree, True)
    kw = dict(sh_degree=0, width=W, height=H, k_max=128, use_frustum=False,
              min_budget=64, md_floor=128, masked_crossover=0.0)
    t_st, j_st = {}, {}
    truncs = []
    for _ in range(8):
        tout, tn = trender.render_lod_stream(
            *targs, 0.01, t_st,
            cfg=RasterizerConfig(tile_w=16, tile_h=16, max_dup=8192), **kw)
        jout, jn = jrender.render_lod_stream(
            *jargs, 0.01, j_st,
            cfg=JConfig(tile_w=16, tile_h=16, max_dup=8192), **kw)
        _same_render(tout, tn, jout, jn)
        assert _state_view(t_st) == _state_view(j_st)
        truncs.append(bool(tout.truncated))
    assert truncs[0] and not truncs[-1], truncs
    assert t_st["n_truncated_frames"] >= 1
    assert t_st["md"][t_st["budget"]] > 128
