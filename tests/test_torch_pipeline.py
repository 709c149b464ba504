"""Port parity for the host-side pipeline modules and the hierarchy filter
against the JAX package on the CPU, with the same numpy inputs:

* pipeline/chunking.py: `make_chunks` (chunk indices, centers, extents,
  camera lists and point masks exactly, with the camera-count and point
  thresholds and the camera subsampling exercised), `save_chunk_meta` bytes
  and `load_chunk_centers`;
* pipeline/merge.py on the reference merger's fixtures
  (tests/fixtures/oracle/chunk{0,1,2}.dhier.gz, merger_centers.txt.gz):
  `chunk_weight`, `reweight_chunk` and `merge_hierarchies` exactly as the
  JAX package's (the global root's surface weights included), and each
  chunk against the reference's merged_chunk{k}.bin at
  tests/test_oracle_parity.py's tolerances;
* hierarchy/filter.py on the oracle tree and on a tree built from seeded
  points: `appearance_filter_mask`, `compute_anchors` and `random_cut_mask`
  (int seed) exactly, `sibling_weights` to atol 1e-6, anchors.bin bytes
  equal and each package reading the other's;
* `state_to_hierarchy` on a converted JAX flat state (with skybox, dead,
  non-finite and oversized rows): the node table exact, the moments at
  tests/test_torch_hier_build.py's tolerances;
* `resolution_args`, and the `full-train` parser's flags and defaults
  against the JAX CLI's.
"""

import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hlod_gaussians_tpu import cli as jcli
from hlod_gaussians_tpu.config import ModelConfig as JModel
from hlod_gaussians_tpu.data import dhier as jdhier
from hlod_gaussians_tpu.data.scene import SceneInfo as JScene
from hlod_gaussians_tpu.hierarchy import filter as jflt
from hlod_gaussians_tpu.models import gaussians as jgm
from hlod_gaussians_tpu.pipeline import chunking as jchunking
from hlod_gaussians_tpu.pipeline import full_train as jfull
from hlod_gaussians_tpu.pipeline import merge as jmerge
from hlod_gaussians_tpu.train import flat as jflat
from hlod_gaussians_torch import cli, convert, hierarchy
from hlod_gaussians_torch.config import ModelConfig
from hlod_gaussians_torch.data import dhier as tdhier
from hlod_gaussians_torch.data.scene import SceneInfo
from hlod_gaussians_torch.hierarchy import build as tbuild
from hlod_gaussians_torch.hierarchy import cut as tcut
from hlod_gaussians_torch.hierarchy import filter as flt
from hlod_gaussians_torch.models.gaussians import (NODE_CHILD_COUNT,
                                                   NODE_PARENT)
from hlod_gaussians_torch.pipeline import chunking, full_train, merge
from tests.test_oracle_parity import _parse_merged_bin, _read, _tmpfile
from tests.test_torch_hier_build import _assert_moments
from tests.test_torch_mcmc import leaves

CPU = torch.device("cpu")
DHIER_FIELDS = ("pos", "quat", "log_scale", "opacity", "shs", "nodes")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: PyTorch's intra-op threads only contend with the
    other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- chunking ---------------------------------------------------------


class Cam:
    """A camera for the chunker: cam-to-world R and world-to-cam T."""

    def __init__(self, R, center):
        self.R = R
        self.T = -R.T @ center


def grid_scene(seed=0):
    """Cameras over a 40 x 25 patch (some yawed), a few isolated ones, and
    points in and around it: the (JAX, port) scenes over the same camera
    objects."""
    rng = np.random.default_rng(seed)
    cams = []
    for c in rng.uniform([0, 0, -1], [40, 25, 1], (60, 3)):
        a = rng.uniform(-0.5, 0.5)
        R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                      [0, 0, 1]])
        cams.append(Cam(R, c))
    cams += [Cam(np.eye(3), np.array([95.0, 3.0, 0.0])),
             Cam(np.eye(3), np.array([96.0, 60.0, 0.0]))]
    pts = rng.uniform([-10, -10, -2], [110, 70, 2], (3000, 3)).astype(
        np.float32)
    cols = rng.uniform(0, 1, pts.shape).astype(np.float32)
    common = dict(points=pts, colors=cols, train_cameras=cams,
                  test_cameras=[], extent=50.0,
                  center=np.zeros(3, np.float32))
    return JScene(**common), SceneInfo(**common)


CHUNK_CASES = {
    "defaults": dict(chunk_size=20.0),
    "thresholds": dict(chunk_size=10.0, min_n_cams=3, max_n_cams=5,
                       min_points=110, padding=0.1, point_padding=0.5),
    "one": dict(chunk_size=500.0, min_n_cams=1, min_points=1),
}


@pytest.mark.parametrize("case", list(CHUNK_CASES))
def test_make_chunks_matches_jax(tmp_path, case):
    js, ts = grid_scene()
    spec = CHUNK_CASES[case]
    jc = jchunking.make_chunks(js, **spec)
    tc = chunking.make_chunks(ts, **spec)
    assert len(tc) == len(jc) > 0
    for a, b in zip(tc, jc):
        assert a.index == b.index
        for k in ("center", "extent", "point_mask"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
            assert getattr(a, k).dtype == getattr(b, k).dtype
        assert [id(c) for c in a.cameras] == [id(c) for c in b.cameras]
        if "max_n_cams" in spec:
            assert len(a.cameras) <= spec["max_n_cams"]
        ta, ja = tmp_path / f"t{a.index}", tmp_path / f"j{a.index}"
        chunking.save_chunk_meta(str(ta), a)
        jchunking.save_chunk_meta(str(ja), b)
        for f in ("center.txt", "extent.txt"):
            assert (ta / f).read_bytes() == (ja / f).read_bytes()
    dirs = [str(tmp_path / f"t{a.index}") for a in tc]
    np.testing.assert_array_equal(chunking.load_chunk_centers(dirs),
                                  jchunking.load_chunk_centers(dirs))
    np.testing.assert_array_equal(chunking.camera_centers(ts.train_cameras),
                                  jchunking.camera_centers(js.train_cameras))


def test_make_chunks_without_cameras():
    js, ts = grid_scene()
    assert chunking.make_chunks(ts._replace(train_cameras=[])) == [] == \
        jchunking.make_chunks(js._replace(train_cameras=[]))


# ---- merge -------------------------------------------------------------


@pytest.fixture(scope="module")
def merger_inputs(tmp_path_factory):
    """The oracle chunk hierarchies as (JAX, port) DHiers, and the chunk
    centers."""
    tmp = tmp_path_factory.mktemp("merger")
    centers = np.loadtxt(io.BytesIO(_read("merger_centers.txt"))).astype(
        np.float32)
    jd, td = [], []
    for k in range(3):
        p = _tmpfile(tmp, f"c{k}.dhier", _read(f"chunk{k}.dhier"))
        jd.append(jdhier.load_dhier(p))
        td.append(tdhier.load_dhier(p))
    return jd, td, centers


def assert_dhier_equal(t, j, rtol=0.0):
    assert t.sh_degree == j.sh_degree
    for k in DHIER_FIELDS:
        got, ref = getattr(t, k), getattr(j, k)
        assert got.dtype == ref.dtype, k
        if rtol and k != "nodes":
            np.testing.assert_allclose(got, ref, rtol=rtol, atol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=k)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_chunk_weight_and_reweight_match_jax(merger_inputs, k):
    jd, td, centers = merger_inputs
    np.testing.assert_array_equal(
        merge.chunk_weight(td[k].pos, k, centers),
        jmerge.chunk_weight(jd[k].pos, k, centers))
    np.testing.assert_array_equal(
        merge.chunk_weight(td[k].pos, 0, centers[:1]),
        jmerge.chunk_weight(jd[k].pos, 0, centers[:1]))
    assert_dhier_equal(merge.reweight_chunk(td[k], k, centers),
                       jmerge.reweight_chunk(jd[k], k, centers))


def test_merge_hierarchies_matches_jax(merger_inputs):
    jd, td, centers = merger_inputs
    t = merge.merge_hierarchies(td, centers)
    j = jmerge.merge_hierarchies(jd, centers)
    assert_dhier_equal(t, j)
    tcut.sanity_check_hierarchy(t.nodes, np.ones(t.nodes.shape[0], bool))
    # two chunks, and one: the single-chunk merge keeps every node
    assert_dhier_equal(merge.merge_hierarchies(td[:2], centers[:2]),
                       jmerge.merge_hierarchies(jd[:2], centers[:2]))
    one = merge.merge_hierarchies(td[:1], centers[:1])
    assert one.nodes.shape[0] == 1 + td[0].nodes.shape[0]


@pytest.mark.parametrize("k", [0, 1, 2])
def test_reweight_matches_reference_merger(merger_inputs, k):
    """The port's reweighting vs the REFERENCE HierarchyExplicitLoader's
    output on the same chunk (merged_chunk{k}.bin), at
    test_oracle_parity.py::test_merger_falloff_matches_oracle's
    tolerances: the kept set, weighted opacities, the root at the chunk
    center and every parent-child pair."""
    _, td, centers = merger_inputs
    o_pos, o_rot, o_scl, o_op, _, o_nodes = _parse_merged_bin(
        _read(f"merged_chunk{k}.bin"))
    r = merge.reweight_chunk(td[k], k, centers)
    assert r.pos.shape[0] == o_pos.shape[0]

    def key(p):
        return p.astype("<f4").tobytes()
    mine = {key(r.pos[i]): i for i in range(r.pos.shape[0])}
    assert len(mine) == r.pos.shape[0]
    for i in range(o_pos.shape[0]):
        j = mine[key(o_pos[i])]
        np.testing.assert_allclose(o_op[i], r.opacity[j], rtol=3e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(o_scl[i], np.exp(r.log_scale[j]),
                                   rtol=1e-5)
        np.testing.assert_array_equal(o_rot[i], r.quat[j])
    np.testing.assert_allclose(o_pos[o_nodes[0, 2]], centers[k], atol=1e-6)
    root = int(np.where(r.nodes[:, NODE_PARENT] == -1)[0][0])
    assert root == 0
    np.testing.assert_allclose(r.pos[root], centers[k], atol=1e-6)
    o_par = o_nodes[:, 1]
    for i in range(1, o_nodes.shape[0]):
        a = mine[key(o_pos[o_nodes[i, 2]])]
        b = mine[key(o_pos[o_nodes[o_par[i], 2]])]
        assert r.nodes[a, NODE_PARENT] == b, (i, a, b)


def test_rebuild_links_and_splice_match_jax(merger_inputs):
    _, td, _ = merger_inputs
    nodes = td[1].nodes
    rng = np.random.default_rng(3)
    keep = rng.uniform(size=nodes.shape[0]) < 0.6
    keep[nodes[:, NODE_PARENT] == -1] = True
    np.testing.assert_array_equal(merge._splice_dropped(nodes, keep),
                                  jmerge._splice_dropped(nodes, keep))
    parent = nodes[:, NODE_PARENT]
    np.testing.assert_array_equal(merge.rebuild_links(parent),
                                  jmerge.rebuild_links(parent))


# ---- hierarchy filter ----------------------------------------------------


def seeded_tree(n=200, seed=5):
    """A tree built by the port's builder over seeded points (z ~ 5)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    pts[:, 2] += 5.0
    sc = np.exp(rng.uniform(-3.0, -1.5, (n, 3))).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    op = rng.uniform(0.3, 0.9, n).astype(np.float32)
    sh = rng.normal(size=(n, 1, 3)).astype(np.float32)
    h = tbuild.build_hierarchy(pts, sc, q, op, sh, device=CPU)
    return dict(nodes=h.nodes, pos=h.pos, log_scale=np.log(h.scale),
                opacity=h.opacity)


@pytest.fixture(scope="module", params=["oracle", "seeded"])
def tree(request, tmp_path_factory):
    if request.param == "seeded":
        return seeded_tree()
    p = _tmpfile(tmp_path_factory.mktemp("otree"), "h.dhier",
                 _read("hierarchy.dhier"))
    d = tdhier.load_dhier(p)
    return dict(nodes=d.nodes, pos=d.pos, log_scale=d.log_scale,
                opacity=d.opacity)


VIEWPOINTS = np.array([[0, 0, 0], [1.5, 0, 0], [0, -2, 1], [0, 0, -10]],
                      np.float32)


@pytest.mark.parametrize("target", [1e-6, 5e-3, 0.05])
def test_appearance_filter_and_anchors_match_jax(tree, target, tmp_path):
    nodes, pos = tree["nodes"], tree["pos"]
    ms = np.exp(tree["log_scale"]).max(1)
    c = nodes.shape[0]
    alive = np.ones(c, bool)
    alive[-3:] = False
    got = flt.appearance_filter_mask(nodes, pos, ms, alive, VIEWPOINTS,
                                     target, device=CPU)
    assert got.device == CPU and got.dtype == torch.bool
    ref = np.asarray(jflt.appearance_filter_mask(
        jnp.asarray(nodes), jnp.asarray(pos), jnp.asarray(ms),
        jnp.asarray(alive), VIEWPOINTS, target))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < ref.sum()
    # tensor inputs run on their device
    got_t = flt.appearance_filter_mask(
        torch.as_tensor(nodes), torch.as_tensor(pos), torch.as_tensor(ms),
        torch.as_tensor(alive), torch.as_tensor(VIEWPOINTS), target)
    np.testing.assert_array_equal(got_t.numpy(), ref)

    a = flt.compute_anchors(nodes, pos, ms, alive, VIEWPOINTS, target,
                            device=CPU)
    b = jflt.compute_anchors(nodes, pos, ms, alive, VIEWPOINTS, target)
    np.testing.assert_array_equal(a, b)
    assert a.dtype == b.dtype == np.int32
    flt.write_anchors(str(tmp_path / "t.bin"), a)
    jflt.write_anchors(str(tmp_path / "j.bin"), b)
    assert (tmp_path / "t.bin").read_bytes() == \
        (tmp_path / "j.bin").read_bytes()
    np.testing.assert_array_equal(jflt.read_anchors(str(tmp_path / "t.bin")),
                                  a)
    np.testing.assert_array_equal(flt.read_anchors(str(tmp_path / "j.bin")),
                                  b)


@pytest.mark.parametrize("p", [0.0, 0.3, 1.0])
def test_random_cut_mask_matches_jax(tree, p):
    nodes = tree["nodes"]
    alive = np.ones(nodes.shape[0], bool)
    for seed in (0, 7):
        got = flt.random_cut_mask(nodes, alive, p, seed)
        np.testing.assert_array_equal(
            got, jflt.random_cut_mask(nodes, alive, p, seed))
        assert tcut.is_hierarchy_cut(torch.as_tensor(nodes),
                                     torch.as_tensor(got),
                                     torch.as_tensor(alive))
    gen = torch.Generator().manual_seed(0)
    cut = flt.random_cut_mask(torch.as_tensor(nodes),
                              torch.as_tensor(alive), p, gen)
    assert tcut.is_hierarchy_cut(torch.as_tensor(nodes),
                                 torch.as_tensor(cut),
                                 torch.as_tensor(alive))


def test_sibling_weights_match_jax(tree):
    nodes = tree["nodes"]
    c = nodes.shape[0]
    rng = np.random.default_rng(1)
    logit = rng.normal(size=(c, 1)).astype(np.float32)
    alive = np.ones(c, bool)
    alive[rng.choice(c, 5, replace=False)] = False
    got = flt.sibling_weights(torch.as_tensor(nodes),
                              torch.as_tensor(tree["log_scale"]),
                              torch.as_tensor(logit), torch.as_tensor(alive))
    ref = np.asarray(jflt.sibling_weights(
        jnp.asarray(nodes), jnp.asarray(tree["log_scale"]),
        jnp.asarray(logit), jnp.asarray(alive)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    assert hierarchy.sibling_weights is flt.sibling_weights
    assert hierarchy.appearance_filter_mask is flt.appearance_filter_mask
    assert hierarchy.random_cut_mask is flt.random_cut_mask


# ---- state_to_hierarchy, resolution_args, the CLI -------------------------


def flat_state_pair(knn_scales):
    """A flat state (JAX, converted port) with 4 skybox rows, dead rows, a
    NaN row and a row of scale >= 10 (all filtered), anisotropic rotated
    rows otherwise: log-scales around the kNN init, or
    test_torch_hier_build.py's leaf scales, exp(N(0, 0.3) - 2.5). (Far
    smaller leaves make merges whose two small eigenvalues sit within
    float32's reach of the closed-form eigensolver; see
    tests/test_torch_full_pipeline.py.)"""
    rng = np.random.default_rng(2)
    n, cap = 90, 128
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    pts[:, 2] += 5.0
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    js = jgm.create_from_points(pts, cols, capacity=cap, sh_degree=1,
                                skybox_num=4, opacity_init=0.6)
    noise = rng.normal(size=(cap, 3)).astype(np.float32)
    ls = (np.asarray(js.log_scale) + noise * 0.4 if knn_scales
          else (0.3 * noise - 2.5).astype(np.float32))
    ls[20, 0] = np.log(12.0)
    xyz = np.asarray(js.xyz).copy()
    xyz[21, 1] = np.nan
    alive = np.asarray(js.alive).copy()
    alive[[30, 31]] = False
    js = dataclasses.replace(
        js, log_scale=jnp.asarray(ls), xyz=jnp.asarray(xyz),
        alive=jnp.asarray(alive),
        quat=jnp.asarray(rng.normal(size=(cap, 4)).astype(np.float32)),
        f_rest=jnp.asarray(rng.normal(size=(cap, 3, 3)).astype(np.float32)))
    tts = convert.train_state_from_numpy(
        dict(leaves(js), xyz_grad_accum=np.zeros(cap, np.float32),
             denom=np.zeros(cap, np.int32),
             max_radii=np.zeros(cap, np.float32), step=0),
        n_skybox=4, device=CPU)
    return jflat.init_flat_train(js), tts, n


def test_state_to_hierarchy_matches_jax():
    jts, tts, n = flat_state_pair(knn_scales=False)
    t = full_train.state_to_hierarchy(tts)
    j = jfull.state_to_hierarchy(jts)
    kept = n - 2 - 2
    assert t.nodes.shape[0] == j.nodes.shape[0] == 2 * kept - 1
    assert t.sh_degree == j.sh_degree == 1
    np.testing.assert_array_equal(t.nodes, j.nodes)
    interior = t.nodes[:, NODE_CHILD_COUNT] > 0
    _assert_moments(t.pos, np.exp(t.log_scale), t.quat, t.opacity, t.shs,
                    j.pos, np.exp(j.log_scale), j.quat, j.opacity, j.shs,
                    interior)
    for k in ("log_scale", "opacity", "shs", "pos"):
        assert getattr(t, k).dtype == np.float32
        np.testing.assert_allclose(getattr(t, k)[~interior],
                                   getattr(j, k)[~interior], rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_state_to_hierarchy_kd_split_follows_the_last_bit_of_exp():
    """With kNN-sized scales a point's box of mean +- 3 max scale can hold
    its sibling's on every axis; the longest side is then decided by
    rounding, and the last bit by which PyTorch's exp differs from XLA's
    moves rows between kd leaves. The builder itself agrees: on JAX's
    activated rows it gives JAX's tree exactly."""
    jts, tts, _ = flat_state_pair(knn_scales=True)
    j = jfull.state_to_hierarchy(jts)
    act = jgm.activate(jts.gaussians)
    g = tts.gaussians
    rows = np.where(np.asarray(g.alive))[0]
    rows = rows[rows >= g.n_skybox]
    args = [np.asarray(a)[rows] for a in (act.means3d, act.scales,
                                          act.quats, act.opacities,
                                          act.shs)]
    keep = (np.isfinite(args[0]).all(1) & (args[1].max(1) < 10.0))
    h = tbuild.build_hierarchy(*(a[keep] for a in args), device=CPU)
    np.testing.assert_array_equal(h.nodes, j.nodes)
    np.testing.assert_array_equal(h.leaf_point[h.nodes[:, 2] == 0],
                                  np.arange(len(args[0]))[keep].argsort()
                                  .argsort()[h.leaf_point[h.nodes[:, 2]
                                                          == 0]])
    np.testing.assert_allclose(h.pos, j.pos, rtol=1e-6, atol=1e-7)
    own = torch.exp(g.log_scale).numpy()[rows]
    np.testing.assert_allclose(own, args[1], rtol=2.5e-7, atol=0)
    t = full_train.state_to_hierarchy(tts)
    np.testing.assert_array_equal(t.nodes, j.nodes)
    assert np.abs(t.pos - j.pos).max() > 1e-3     # rows in other leaves


@pytest.mark.parametrize("res", [-1, 1, 2, 4, 8, 3, 1600])
def test_resolution_args_match_jax(res):
    assert full_train.resolution_args(ModelConfig(resolution=res)) == \
        jfull.resolution_args(JModel(resolution=res))


FULL_TRAIN_ARGV = [
    ["full-train", "-s", "scene", "-o", "out"],
    ["full-train", "--source_path", "a", "--output", "b", "--images", "im",
     "--depths", "d", "--alpha_masks", "m", "--eval", "-r", "4",
     "--white_background", "--train_test_exp", "--skip_scale_big_gauss",
     "--scaffold_file", "s.npz", "--coarse_iters", "5", "--chunk_iters", "6",
     "--post_iters", "7", "--skybox_num", "8", "--chunk_size", "2.5",
     "--backend", "xla", "--max_dup_log2", "12"],
]


@pytest.mark.parametrize("argv", FULL_TRAIN_ARGV, ids=["defaults", "all"])
def test_full_train_parser_matches_jax(argv, monkeypatch):
    seen = {}
    monkeypatch.setattr(jcli, "cmd_full_train",
                        lambda a: seen.setdefault("jax", vars(a)))
    monkeypatch.setattr(cli, "cmd_full_train",
                        lambda a: seen.setdefault("torch", vars(a)))
    jcli.main(argv)
    cli.main(argv)
    j, t = seen["jax"], seen["torch"]
    assert j.pop("fn") is not None and t.pop("fn") is not None
    assert t == j
    with pytest.raises(SystemExit):
        cli.main(["full-train", "-s", "x", "-o", "y", "--backend", "cuda"])
    with pytest.raises(SystemExit):     # a subcommand neither CLI has
        cli.main(["render", "--hierarchy", "h", "-s", "x"])
