"""Port parity for the hierarchy builder and the hierarchy files: the
port's build_hierarchy against the reference-built oracle tree
(tests/fixtures/oracle/hierarchy.dhier.gz, node for node, matched by leaf
set) and against the JAX package's build (cluster and avg merges, a
300-leaf input); build_flat, heap_depth and sym_eigh3; and the file writers
and converters against the committed reference bytes and the JAX package."""

import gzip
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hlod_gaussians_tpu.data import dhier as jdhier
from hlod_gaussians_tpu.data import ply as jply
from hlod_gaussians_tpu.hierarchy import boxes as jboxes
from hlod_gaussians_tpu.hierarchy import build as jbuild
from hlod_gaussians_torch.data import dhier as tdhier
from hlod_gaussians_torch.hierarchy import boxes as tboxes
from hlod_gaussians_torch.hierarchy import build as tbuild
from hlod_gaussians_torch.hierarchy import cut as tcut
from hlod_gaussians_torch.models.gaussians import (NODE_AUX,
                                                   NODE_CHILD_COUNT,
                                                   NODE_DEPTH, NODE_PARENT)

CPU = torch.device("cpu")
FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "oracle")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: PyTorch's intra-op threads only contend with the
    other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read(name: str) -> bytes:
    with gzip.open(os.path.join(FIXDIR, name + ".gz")) as f:
        return f.read()


def _file(tmp_path, name, data: bytes) -> str:
    p = tmp_path / name
    p.write_bytes(data)
    return str(p)


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    d = tdhier.load_dhier(os.path.join(FIXDIR, "hierarchy.dhier.gz"))
    ply = tmp_path_factory.mktemp("ply") / "input.ply"
    ply.write_bytes(_read("input.ply"))
    g = jply.load_gaussian_ply(str(ply))
    # the reference creator's view of a ply row (test_oracle_parity.py):
    # activated opacity and scale, normalized quat, DC SH only
    n = g.xyz.shape[0]
    opacity = 1.0 / (1.0 + np.exp(-g.opacity.astype(np.float32)))
    quat = g.quat / np.linalg.norm(g.quat, axis=-1, keepdims=True)
    shs = np.zeros((n, 16, 3), np.float32)
    shs[:, 0] = g.f_dc.reshape(n, 3)
    leaves = (g.xyz.astype(np.float32), np.exp(g.log_scale.astype(
        np.float32)), quat.astype(np.float32), opacity.astype(np.float32),
        shs)
    return d, leaves


def _leafsets(nodes, leaf_point):
    """node -> frozenset of input rows in its subtree (children always
    follow their parent in both tables)."""
    n = nodes.shape[0]
    ch = [[] for _ in range(n)]
    for i in range(1, n):
        if nodes[i, NODE_PARENT] >= 0:
            ch[nodes[i, NODE_PARENT]].append(i)
    sets = [None] * n
    for i in range(n - 1, -1, -1):
        sets[i] = (frozenset([int(leaf_point[i])]) if not ch[i]
                   else frozenset().union(*(sets[c] for c in ch[i])))
    return sets


def _cov(scale, quat):
    q = quat / np.linalg.norm(quat, axis=-1, keepdims=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=-1).reshape(-1, 3, 3)
    return np.einsum("nij,nj,nkj->nik", r, scale.astype(np.float64) ** 2, r)


def _assert_moments(pos, scale, quat, opacity, sh, r_pos, r_scale, r_quat,
                    r_opacity, r_sh, interior):
    """The oracle suite's tolerances: pos atol 2e-5, covariance relative
    5e-3, interior opacity rtol 5e-3, SH atol 1e-4."""
    np.testing.assert_allclose(pos, r_pos, rtol=0, atol=2e-5)
    cov, r_cov = _cov(scale, quat), _cov(r_scale, r_quat)
    ref = np.maximum(np.abs(r_cov).max(axis=(1, 2)), 1e-8)
    assert (np.abs(cov - r_cov).max(axis=(1, 2)) / ref).max() < 5e-3
    np.testing.assert_allclose(opacity[interior], r_opacity[interior],
                               rtol=5e-3, atol=1e-5)
    np.testing.assert_allclose(sh, r_sh, rtol=0, atol=1e-4)


def test_build_matches_oracle_node_for_node(oracle):
    d, leaves = oracle
    h = tbuild.build_hierarchy(*leaves, clamp_opacity=False, device=CPU)
    assert h.nodes.shape[0] == d.nodes.shape[0] == 2047
    d_by_set = {s: i for i, s in enumerate(_leafsets(d.nodes,
                                                     d.nodes[:, NODE_AUX]))}
    match = np.array([d_by_set[s] for s in _leafsets(h.nodes,
                                                     h.leaf_point)])
    assert np.unique(match).size == match.size          # a bijection
    np.testing.assert_array_equal(h.nodes[:, NODE_DEPTH],
                                  d.nodes[match, NODE_DEPTH])
    interior = h.nodes[:, NODE_CHILD_COUNT] > 0
    _assert_moments(h.pos, h.scale, h.quat, h.opacity, h.sh, d.pos[match],
                    np.exp(d.log_scale[match]), d.quat[match],
                    d.opacity[match], d.shs[match], interior)
    # the fixture holds the reference's unclamped merged opacity
    assert (d.opacity[match][interior] > 1).sum() == 20
    tcut.sanity_check_hierarchy(h.nodes, np.ones(2047, bool))


def _seeded_leaves(n, seed, k=4):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    sc = np.exp(rng.normal(size=(n, 3)) * 0.3 - 2.5).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    op = rng.uniform(0.1, 0.9, n).astype(np.float32)
    sh = rng.normal(size=(n, k, 3)).astype(np.float32)
    return pts, sc, q, op, sh


@pytest.mark.parametrize("merger,clamp", [("cluster", True),
                                          ("avg", True)])
def test_build_matches_jax(merger, clamp):
    leaves = _seeded_leaves(300, seed=9)            # not a power of two
    j = jbuild.build_hierarchy(*leaves, merger=merger, clamp_opacity=clamp)
    t = tbuild.build_hierarchy(*leaves, merger=merger, clamp_opacity=clamp,
                               device=CPU)
    np.testing.assert_array_equal(t.nodes, j.nodes)
    np.testing.assert_array_equal(t.leaf_point, j.leaf_point)
    interior = t.nodes[:, NODE_CHILD_COUNT] > 0
    _assert_moments(t.pos, t.scale, t.quat, t.opacity, t.sh, j.pos, j.scale,
                    j.quat, j.opacity, j.sh, interior)
    # XLA rounds a leaf's mean -+ 3*max_scale once (fused) in the kd split
    # and, in the padded build's box slots, twice: one ulp apart
    for k in ("box_lo", "box_hi", "max_side"):
        np.testing.assert_allclose(getattr(t, k), getattr(j, k), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def test_kd_split_ties_follow_the_index():
    """Equal keys split by the point index, and -0.0 ties with +0.0, as
    XLA's sort of (segment, key, index) on two keys orders them."""
    n = 64
    pts = np.zeros((n, 3), np.float32)
    pts[:, 0] = np.repeat([0.0, -0.0, 1.0, -1.0], 16)
    pts[:, 1] = np.tile(np.arange(8, dtype=np.float32), 8) * 1e-3
    sc = np.full((n, 3), 0.01, np.float32)
    j_seg, j_occ = jax.jit(jbuild.assign_kd_segments, static_argnums=2)(
        jnp.asarray(pts), jnp.asarray(sc), 6)
    t_seg, t_occ = tbuild.assign_kd_segments(torch.as_tensor(pts),
                                             torch.as_tensor(sc), 6)
    np.testing.assert_array_equal(t_seg.numpy(), np.asarray(j_seg))
    np.testing.assert_array_equal(t_occ.numpy(), np.asarray(j_occ))


def test_build_flat_matches_jax():
    leaves = _seeded_leaves(40, seed=3, k=1)
    j = jbuild.build_flat(*leaves)
    t = tbuild.build_flat(*leaves)
    for k in j._fields:
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k),
                                      err_msg=k)


def test_heap_depth_exact_above_2_24():
    idxs = np.array([0, 1, 2, 3, 6, 7, (1 << 24) - 2, (1 << 24) - 1,
                     1 << 24, (1 << 25) - 4, (1 << 25) - 3, (1 << 25) - 2,
                     (1 << 25) - 1, (1 << 30) - 2], np.int32)
    want = np.floor(np.log2(idxs.astype(np.float64) + 1)).astype(np.int32)
    got = tbuild.heap_depth(torch.as_tensor(idxs)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jbuild.heap_depth(
        jnp.asarray(idxs))))


def test_sym_eigh3_matches_lapack():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(200, 3, 3)).astype(np.float32)
    spd = a @ np.swapaxes(a, 1, 2) + 1e-3 * np.eye(3, dtype=np.float32)
    evals, evecs = tbuild.sym_eigh3(torch.as_tensor(spd))
    w, _ = np.linalg.eigh(spd.astype(np.float64))
    np.testing.assert_allclose(evals.numpy(), w, rtol=1e-3, atol=1e-4)
    v = evecs.numpy().astype(np.float64)
    recon = v @ (evals.numpy()[:, :, None] * np.swapaxes(v, 1, 2))
    np.testing.assert_allclose(recon, spd, rtol=0, atol=2e-3 * np.abs(
        spd).max())
    np.testing.assert_allclose(np.swapaxes(v, 1, 2) @ v,
                               np.broadcast_to(np.eye(3), v.shape),
                               atol=1e-4)


def test_sym_eigh3_repeated_eigenvalues():
    """Degenerate inputs (isotropic, two equal eigenvalues) still give an
    orthonormal right-handed frame."""
    mats = np.stack([np.eye(3), np.diag([2.0, 2.0, 5.0]),
                     np.diag([1.0, 3.0, 3.0])]).astype(np.float32)
    evals, evecs = tbuild.sym_eigh3(torch.as_tensor(mats))
    v = evecs.numpy()
    np.testing.assert_allclose(np.swapaxes(v, 1, 2) @ v,
                               np.broadcast_to(np.eye(3), v.shape),
                               atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(v), 1.0, atol=1e-5)
    np.testing.assert_allclose(evals.numpy(), np.sort(np.diagonal(
        mats, axis1=1, axis2=2)), atol=1e-5)


# ---------------------------------------------------------------------------
# files and converters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,compressed", [("oracle.hier", False),
                                             ("oracle_c.hier", True)])
def test_hier_bytes_round_trip(tmp_path, name, compressed):
    raw = _read(name)
    h = tdhier.load_hier(_file(tmp_path, "in.hier", raw))
    jh = jdhier.load_hier(_file(tmp_path, "j.hier", raw))
    for k in jh._fields:
        np.testing.assert_array_equal(getattr(h, k), getattr(jh, k),
                                      err_msg=k)
    out = str(tmp_path / "out.hier")
    tdhier.save_hier(out, h, compressed=compressed)
    with open(out, "rb") as f:
        assert f.read() == raw
    if compressed:
        # the compression itself is part of the byte contract: write from
        # the full-precision arrays of the uncompressed file
        h = tdhier.load_hier(_file(tmp_path, "u.hier", _read("oracle.hier")))
        tdhier.save_hier(out, h, compressed=True)
        with open(out, "rb") as f:
            assert f.read() == raw


def test_gdf_and_dhier_bytes(tmp_path, oracle):
    d, _ = oracle
    out = str(tmp_path / "h.gdf")
    tdhier.save_gdf(out, d.nodes, max_depth=15)
    with open(out, "rb") as f:
        assert f.read() == _read("hierarchy.gdf")
    out = str(tmp_path / "rt.dhier")
    tdhier.save_dhier(out, d)
    with open(out, "rb") as f:
        assert f.read() == _read("hierarchy.dhier")


def test_upstream_conversions_match_jax(tmp_path, oracle):
    d, _ = oracle
    h = tdhier.load_hier(_file(tmp_path, "o.hier", _read("oracle.hier")))
    td, tb = tboxes.upstream_to_fork(h)
    jd, jb = jboxes.upstream_to_fork(jdhier.load_hier(str(tmp_path
                                                          / "o.hier")))
    for k in jd._fields:
        np.testing.assert_array_equal(getattr(td, k), getattr(jd, k),
                                      err_msg=k)
    for k in jb._fields:
        np.testing.assert_array_equal(getattr(tb, k), getattr(jb, k),
                                      err_msg=k)
    jd_d = jdhier.DHier(*d)
    tu, ju = tboxes.dhier_to_upstream(d), jboxes.dhier_to_upstream(jd_d)
    for k in ju._fields:
        np.testing.assert_array_equal(getattr(tu, k), getattr(ju, k),
                                      err_msg=k)
    ms = np.exp(d.log_scale).max(axis=1)
    tnb = tboxes.compute_node_boxes(d.nodes, d.pos, ms)
    jnb = jboxes.compute_node_boxes(d.nodes, d.pos, ms)
    for k in jnb._fields:
        np.testing.assert_array_equal(getattr(tnb, k), getattr(jnb, k),
                                      err_msg=k)
