"""Port parity for the SPT caches (hierarchy/spt.py): build_spt on the
reference-built oracle tree (tests/fixtures/oracle/hierarchy.dhier.gz) and
on seeded built trees of 65 and 4,096 leaves, with and without bounding
spheres, every forest array equal to the JAX package's (ut_bound to 1 ulp);
spt_cut, spt_cut_cached, spt_cut_budgeted and mip_respawn_mask at several
cameras, multipliers and frustum settings, masks, SPT selections and counts
equal (the SPT distances to 4 ulp); and the properties of test_spt.py run
on the port."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hlod_gaussians_tpu.hierarchy import spt as jspt
from hlod_gaussians_tpu.utils import camera as jcam
from hlod_gaussians_torch import convert
from hlod_gaussians_torch.data.dhier import load_dhier
from hlod_gaussians_torch.hierarchy import build as tbuild
from hlod_gaussians_torch.hierarchy import spt
from hlod_gaussians_torch.models.gaussians import (NODE_AUX,
                                                   NODE_CHILD_COUNT,
                                                   NODE_FIRST_CHILD,
                                                   NODE_NEXT_SIBLING,
                                                   NODE_PARENT)
from hlod_gaussians_torch.utils.camera import make_camera
from tests.test_hierarchy_build import random_gaussians

CPU = torch.device("cpu")
ORACLE = os.path.join(os.path.dirname(__file__), "fixtures", "oracle",
                      "hierarchy.dhier.gz")
TREES = ("oracle", "built65", "built4096")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: PyTorch's intra-op threads only contend with the
    other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(name):
    """(nodes, xyz, linear scales, root volume, granularity) of a tree; the
    root volume lies between the leaf and root volumes so real SPTs form."""
    if name == "oracle":
        d = load_dhier(ORACLE)
        nodes, xyz, scales = d.nodes, d.pos, np.exp(d.log_scale)
    else:
        n = int(name.removeprefix("built"))
        h = tbuild.build_hierarchy(*random_gaussians(n, seed=n), device=CPU)
        nodes, xyz, scales = h.nodes, h.pos, h.scale
    scales = scales.astype(np.float32)
    vols = np.prod(scales, axis=-1)
    root_volume = float(np.quantile(vols[nodes[:, NODE_CHILD_COUNT] == 2],
                                    0.6))
    return nodes, xyz.astype(np.float32), scales, root_volume, 0.01


@pytest.fixture(scope="module")
def forests():
    """{(tree, use_bounding_spheres): (tree arrays, JAX forest, port
    forest)}."""
    out = {}
    for name in TREES:
        nodes, xyz, scales, vol, gran = _tree(name)
        alive = np.ones(nodes.shape[0], bool)
        root = int(np.where(nodes[:, NODE_PARENT] == -1)[0][0])
        for spheres in (True, False):
            kw = dict(root_volume=vol, target_granularity=gran,
                      min_spt_size=4, use_bounding_spheres=spheres)
            out[name, spheres] = (
                (nodes, xyz, scales),
                jspt.build_spt(nodes, xyz, scales, alive, root, **kw),
                spt.build_spt(nodes, xyz, scales, alive, root, device=CPU,
                              **kw))
    return out


@pytest.mark.parametrize("spheres", [True, False], ids=["spheres", "own"])
@pytest.mark.parametrize("tree", TREES)
def test_build_spt_matches_jax(forests, tree, spheres):
    _, jf, tf = forests[tree, spheres]
    assert tf.n_spts == jf.n_spts > 0 and tf.entry_gid.shape[0] > 0
    for k in spt.SPTForest._fields:
        got, ref = getattr(tf, k).numpy(), np.asarray(getattr(jf, k))
        assert got.dtype == ref.dtype and got.shape == ref.shape, k
        if k == "ut_bound":
            np.testing.assert_array_max_ulp(got, ref, maxulp=1)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=k)


def _cameras(xyz):
    """(R, t) pairs around and inside the tree's bounding box."""
    center = xyz.mean(0)
    ext = float(np.abs(xyz - center).max())
    out = []
    for i, (a, dist) in enumerate(((0.0, 2.5), (0.9, 1.2), (2.4, 0.4),
                                   (4.0, 6.0))):
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]], np.float32)
        pos = center - dist * ext * R[:, 2] + 0.1 * i
        out.append((R, -R.T @ pos))
    return out


@pytest.mark.parametrize("tree", TREES)
def test_cuts_match_jax(forests, tree):
    """spt_cut (frustum on and off, three multipliers), spt_cut_cached
    along the camera sequence, spt_cut_budgeted at budgets that pick each
    candidate, on the JAX forest handed over by convert.forest_from_numpy."""
    (nodes, xyz, _), jf, tf_own = forests[tree, True]
    tf = convert.forest_from_numpy(
        {k: np.asarray(v) for k, v in jf._asdict().items()}, device=CPU)
    for k in spt.SPTForest._fields:
        assert torch.equal(getattr(tf, k), getattr(tf_own, k)) or \
            k == "ut_bound", k
    c = nodes.shape[0] + 5                    # spare rows past the tree
    dummy = jnp.zeros(c)
    prev = None
    n_seen = set()
    for R, t in _cameras(xyz):
        jc = jcam.make_camera(R, t, 1.2, 0.9, 64, 48)
        tc = make_camera(R, t, 1.2, 0.9, 64, 48, device=CPU)
        for frustum in (True, False):
            for mult in (0.5, 1.0, 3.0):
                ref = jspt.spt_cut(jf, dummy, jc.campos, jc.full_proj,
                                   jnp.float32(mult), use_frustum=frustum)
                got = spt.spt_cut(tf, c, tc.campos, tc.full_proj, mult,
                                  use_frustum=frustum)
                _assert_cut_equal(got, ref)
                n_seen.add(int(got.n_selected))
        # the reuse rule along the camera sequence
        if prev is not None:
            ref = jspt.spt_cut_cached(jf, dummy, jc.campos, jc.full_proj,
                                      jnp.asarray(prev[0]),
                                      jnp.asarray(prev[1]), 0.5)
            got = spt.spt_cut_cached(tf, c, tc.campos, tc.full_proj,
                                     torch.as_tensor(prev[0]),
                                     torch.as_tensor(prev[1]), 0.5)
            _assert_cut_equal(got, ref)
        base = spt.spt_cut(tf, c, tc.campos, tc.full_proj)
        prev = (base.spt_selected.numpy(), base.spt_distance.numpy())
        # budgets between the candidates' sizes pick each of them
        sizes = [int(spt.spt_cut(tf, c, tc.campos, tc.full_proj,
                                 1.5 ** k).n_selected) for k in range(3)]
        for budget in sorted(set(sizes)) + [min(sizes) - 1]:
            ref = jspt.spt_cut_budgeted(jf, dummy, jc.campos, jc.full_proj,
                                        jnp.int32(budget), grow=1.5)
            got = spt.spt_cut_budgeted(tf, c, tc.campos, tc.full_proj,
                                       budget, grow=1.5)
            _assert_cut_equal(got, ref)
    # the cameras cut the tree to different sizes
    assert len(n_seen) > 3


def _assert_cut_equal(got, ref):
    """Masks, selections and counts equal; the distances to a few ulp (XLA
    fuses the multiplier into its norm differently per program)."""
    np.testing.assert_array_equal(got.gaussian_mask.numpy(),
                                  np.asarray(ref.gaussian_mask))
    np.testing.assert_array_equal(got.spt_selected.numpy(),
                                  np.asarray(ref.spt_selected))
    np.testing.assert_array_max_ulp(got.spt_distance.numpy(),
                                    np.asarray(ref.spt_distance), maxulp=4)
    assert int(got.n_selected) == int(ref.n_selected)


@pytest.mark.parametrize("tree", TREES)
def test_mip_respawn_mask_matches_jax(forests, tree):
    (nodes, xyz, _), jf, tf = forests[tree, False]
    c = nodes.shape[0]
    center = xyz.mean(0)
    flagged = []
    for cams in ([[0.0, 0.0, -100.0]], center[None] + [[0.0, 0.0, 0.5]],
                 [[0.0, 0.0, -100.0], center + 3.0, [5.0, -2.0, 1.0]]):
        cams = np.asarray(cams, np.float32)
        ref = np.asarray(jspt.mip_respawn_mask(jf, jnp.zeros(c),
                                               jnp.asarray(cams)))
        got = spt.mip_respawn_mask(tf, c, torch.as_tensor(cams)).numpy()
        np.testing.assert_array_equal(got, ref)
        flagged.append(int(got.sum()))
    # a far camera flags fine entries, one at the tree flags fewer
    assert flagged[0] > flagged[1]


# ---- the properties of test_spt.py, on the port -----------------------------

def _port_forest(n=129, seed=0):
    """test_spt.make_forest on the port: a built tree, the root volume at
    the median interior volume, min_spt_size 4, granularity 0.01."""
    h = tbuild.build_hierarchy(*random_gaussians(n, seed=seed), device=CPU)
    vols = np.prod(h.scale, axis=-1)
    root_volume = float(np.quantile(
        vols[h.nodes[:, NODE_CHILD_COUNT] == 2], 0.5))
    root = int(np.where(h.nodes[:, NODE_PARENT] == -1)[0][0])
    return h, spt.build_spt(h.nodes, h.pos, h.scale,
                            np.ones(h.nodes.shape[0], bool), root,
                            root_volume=root_volume, target_granularity=0.01,
                            min_spt_size=4, device=CPU)


def test_port_build_partitions_leaves():
    """Every leaf is in exactly one SPT or in the upper tree, once."""
    h, forest = _port_forest()
    leaves = np.where(h.nodes[:, NODE_CHILD_COUNT] == 0)[0]
    entry_gid = forest.entry_gid.numpy()
    in_spt = np.isin(leaves, entry_gid)
    in_ut = np.isin(leaves, forest.ut_nodes[:, NODE_AUX].numpy())
    assert (in_spt | in_ut).all() and not (in_spt & in_ut).any()
    assert len(np.unique(entry_gid)) == len(entry_gid)


def test_port_entry_windows_nested():
    """min <= max per entry; each SPT's entries by descending max."""
    _, forest = _port_forest()
    e_min, e_max = forest.entry_min.numpy(), forest.entry_max.numpy()
    assert (e_min <= e_max + 1e-5).all()
    spt_of = forest.entry_spt.numpy()
    for s in np.unique(spt_of):
        assert (np.diff(e_max[spt_of == s]) <= 1e-5).all()


def test_port_cut_covers_each_spt_leaf_region_once():
    """At any distance the selected entries of an SPT form a proper cut of
    its subtree: every leaf has exactly one selected ancestor-or-self."""
    h, forest = _port_forest()
    nodes = h.nodes
    entry_gid, spt_of = forest.entry_gid.numpy(), forest.entry_spt.numpy()
    e_min, e_max = forest.entry_min.numpy(), forest.entry_max.numpy()
    for s, root in enumerate(forest.spt_root_global.numpy()):
        for dist in (0.5, 2.0, 10.0, 1e6):
            sel = set(entry_gid[(spt_of == s) & (e_max > dist)
                                & (e_min < dist)].tolist())
            stack = [(int(root), 0)]
            while stack:
                i, cnt = stack.pop()
                cnt += int(i in sel)
                if nodes[i, NODE_CHILD_COUNT] == 0:
                    assert cnt == 1, (s, dist, i, cnt)
                else:
                    c0 = nodes[i, NODE_FIRST_CHILD]
                    stack += [(int(c0), cnt),
                              (int(nodes[c0, NODE_NEXT_SIBLING]), cnt)]


def test_port_cut_grows_near_and_shrinks_with_multiplier():
    h, forest = _port_forest()
    c = h.nodes.shape[0]
    proj = torch.eye(4)
    far = spt.spt_cut(forest, c, torch.tensor([0.0, 0.0, -10.0]), proj,
                      use_frustum=False)
    assert int(far.n_selected) == int(far.gaussian_mask.sum()) > 0
    near = spt.spt_cut(forest, c, torch.tensor([0.0, 0.0, -0.1]), proj,
                       use_frustum=False)
    assert int(near.n_selected) >= int(far.n_selected)
    campos = torch.tensor([0.0, 0.0, -5.0])
    base = spt.spt_cut(forest, c, campos, proj, use_frustum=False)
    coarse = spt.spt_cut(forest, c, campos, proj, 8.0, use_frustum=False)
    assert int(coarse.n_selected) <= int(base.n_selected)
