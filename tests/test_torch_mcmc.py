"""Port parity for MCMC densification (hierarchy/mcmc.py): compute_relocation
against the JAX package and the CUDA reference's double loop
(test_mcmc.reference_relocation); relocate_gs and add_new_gs with the JAX
package's host draws injected.

JAX's draws (jax.random.categorical) cannot be replayed in PyTorch. While
the JAX call is traced, `_sample_hosts` is wrapped with a debug callback
that records what it draws, and the port takes those rows as `sampled`.
With the same draws the node table and `alive` match exactly; parameters
and Adam moments to 4 ulp (XLA's and PyTorch's float32 lgamma, pow, exp,
sigmoid and log differ in the last bit), the relocated log-scales to 2e-5
(the binomial sum's cancellation). Cases: respawn, no dead leaf, no candidate
host, the depth repair of a promoted subtree with two nested dead leaves,
growth and the capacity limit (test_mcmc.py:88-221), each also holding the
tree invariants."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hlod_gaussians_tpu import optim as joptim
from hlod_gaussians_tpu.hierarchy import mcmc as jmcmc
from hlod_gaussians_tpu.models import gaussians as jgm
from hlod_gaussians_torch import convert
from hlod_gaussians_torch.hierarchy import build as tbuild
from hlod_gaussians_torch.hierarchy import mcmc
from hlod_gaussians_torch.models.gaussians import (NODE_CHILD_COUNT,
                                                   NODE_DEPTH, NODE_PARENT)
from tests.test_hierarchy_build import random_gaussians
from tests.test_mcmc import check_invariants, reference_relocation

CPU = torch.device("cpu")
FIELDS = ("xyz", "f_dc", "f_rest", "log_scale", "quat", "opacity_logit",
          "exposure", "alive", "nodes")
FLOATS = ("xyz", "f_dc", "f_rest", "log_scale", "quat", "opacity_logit",
          "exposure")
# the relocated scale's alternating binomial sum (up to 51 terms) cancels,
# and XLA and PyTorch add it in different orders: 2e-5 relative
RELOC_RTOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: PyTorch's intra-op threads only contend with the
    other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# every draw the JAX package's `_sample_hosts` made, in order (one list: a
# compiled program keeps the callback it was traced with)
_DRAWS = []


def _recording_sampler(key, probs, k2):
    sampled, counts = _JAX_SAMPLE_HOSTS(key, probs, k2)
    jax.debug.callback(lambda s: _DRAWS.append(np.asarray(s)), sampled)
    return sampled, counts


_JAX_SAMPLE_HOSTS = jmcmc._sample_hosts


@contextlib.contextmanager
def recorded_draws():
    """Record the host draws of the JAX calls inside: `_sample_hosts` is
    wrapped with a debug callback while the jitted callers are traced."""
    _DRAWS.clear()
    jmcmc._sample_hosts = _recording_sampler
    try:
        yield _DRAWS
    finally:
        jmcmc._sample_hosts = _JAX_SAMPLE_HOSTS


def leaves(state, adam=None):
    """A JAX state (and Adam) as the numpy layout of
    convert.post_state_from_numpy."""
    adam = adam or joptim.init_adam(state.params())
    return dict(
        gaussians={k: np.asarray(getattr(state, k)) for k in FIELDS},
        adam=dict(m={k: np.asarray(v) for k, v in adam.m.items()},
                  v={k: np.asarray(v) for k, v in adam.v.items()},
                  step=int(adam.step)),
        step=0)


def to_torch(state, adam=None):
    ts = convert.post_state_from_numpy(leaves(state, adam),
                                       n_skybox=state.n_skybox, device=CPU)
    return ts.gaussians, ts.adam


def seeded_adam(state, seed=1):
    """Adam moments that are not zero, so zeroed rows show."""
    rng = np.random.default_rng(seed)
    a = joptim.init_adam(state.params())
    return a._replace(
        m={k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
           for k, v in a.m.items()},
        v={k: jnp.asarray(rng.uniform(size=v.shape).astype(np.float32))
           for k, v in a.v.items()})


def assert_matches(tg, tadam, jg, jadam):
    for k in ("alive", "nodes"):
        np.testing.assert_array_equal(getattr(tg, k).numpy(),
                                      np.asarray(getattr(jg, k)), err_msg=k)
    for k in FLOATS:
        got, ref = getattr(tg, k).numpy(), np.asarray(getattr(jg, k))
        if k == "log_scale":
            # the relocated scale: RELOC_RTOL relative
            np.testing.assert_allclose(got, ref, rtol=0, atol=RELOC_RTOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_max_ulp(got, ref, maxulp=4)
    for part in ("m", "v"):
        for k, ref in getattr(jadam, part).items():
            np.testing.assert_array_max_ulp(
                getattr(tadam, part)[k].numpy(), np.asarray(ref), maxulp=4)


def test_compute_relocation_matches_jax_and_cuda_math():
    rng = np.random.default_rng(0)
    m = 64
    op = rng.uniform(0.01, 0.98, m)
    sc = rng.uniform(0.01, 2.0, (m, 3))
    n = rng.integers(1, 51, m)
    n[:4] = (1, 2, 50, 51)
    got_o, got_s = mcmc.compute_relocation(
        torch.as_tensor(op, dtype=torch.float32),
        torch.as_tensor(sc, dtype=torch.float32),
        torch.as_tensor(n, dtype=torch.int32))
    ref_o, ref_s = jmcmc.compute_relocation(
        jnp.asarray(op, jnp.float32), jnp.asarray(sc, jnp.float32),
        jnp.asarray(n, jnp.int32))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(ref_o), rtol=1e-6)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s),
                               rtol=RELOC_RTOL)
    # the double loop in float64 (its sum loses digits as n grows)
    small = n < 10
    dl_o, dl_s = reference_relocation(op[small], sc[small], n[small])
    np.testing.assert_allclose(got_o.numpy()[small], dl_o, rtol=1e-4)
    np.testing.assert_allclose(got_s.numpy()[small], dl_s, rtol=2e-3)


def hier_state(n=33, cap=256, seed=0):
    """test_mcmc.hier_state: a JAX state carrying a built hierarchy, the
    tree from the port's builder (node for node the JAX package's)."""
    h = tbuild.build_hierarchy(*random_gaussians(n, seed=seed), device=CPU)
    m = h.nodes.shape[0]
    st = jgm.empty_state(cap, sh_degree=0)
    st = dataclasses.replace(
        st,
        xyz=st.xyz.at[:m].set(jnp.asarray(h.pos)),
        log_scale=st.log_scale.at[:m].set(jnp.asarray(np.log(h.scale))),
        quat=st.quat.at[:m].set(jnp.asarray(h.quat)),
        opacity_logit=st.opacity_logit.at[:m].set(
            jgm.inverse_sigmoid(jnp.asarray(np.clip(h.opacity, 0.01, 0.99))
                                )[:, None]),
        f_dc=st.f_dc.at[:m].set(jnp.asarray(h.sh[:, :1])),
        alive=st.alive.at[:m].set(True),
        nodes=st.nodes.at[:m].set(jnp.asarray(h.nodes)))
    return st, m


def _kill(state, rows):
    logit = np.array(state.opacity_logit)
    logit[rows] = float(jgm.inverse_sigmoid(jnp.float32(0.001)))
    return dataclasses.replace(state, opacity_logit=jnp.asarray(logit))


def _leaf_rows(state):
    nodes = np.asarray(state.nodes)
    return np.where((nodes[:, NODE_CHILD_COUNT] == 0)
                    & np.asarray(state.alive))[0]


def nested_tree(cap=64, kill=(1, 4)):
    """The hand-built tree of test_mcmc.py:168-219 (leaf 1's sibling 2
    carries a 3-level subtree), with leaf 4 inside that subtree dead too:
    its sibling 3 is promoted into 2 first, then 2 into the root."""
    rows = np.array([
        # depth parent cc  fc  nsib aux
        [0, -1, 2, 1, 0, 0],     # 0 root
        [1, 0, 0, 0, 2, 0],      # 1 dead leaf
        [1, 0, 2, 3, 0, 0],      # 2 its sibling (interior)
        [2, 2, 2, 5, 4, 0],      # 3 interior
        [2, 2, 0, 0, 0, 0],      # 4 leaf (dead in the nested case)
        [3, 3, 0, 0, 6, 0],      # 5 grandchild leaf
        [3, 3, 0, 0, 0, 0],      # 6 grandchild leaf
    ], np.int32)
    nodes = np.full((cap, 6), -1, np.int32)
    nodes[:len(rows)] = rows
    rng = np.random.default_rng(0)
    st = dataclasses.replace(
        jgm.empty_state(cap, sh_degree=0),
        nodes=jnp.asarray(nodes),
        alive=jnp.asarray(np.arange(cap) < len(rows)),
        xyz=jnp.asarray(rng.normal(size=(cap, 3)).astype(np.float32)),
        log_scale=jnp.full((cap, 3), -2.0),
        quat=jnp.zeros((cap, 4)).at[:, 0].set(1.0),
        opacity_logit=jnp.full((cap, 1), 2.0))
    return _kill(st, list(kill))


def _relocate_case(name):
    """(JAX state, budget, expected relocations or None for > 0)."""
    if name == "respawn":
        st, _ = hier_state()
        return _kill(st, _leaf_rows(st)[:3]), 64, None
    if name == "no_dead":
        return hier_state(seed=3)[0], 64, 0
    if name == "no_candidates":
        st, _ = hier_state(n=9, seed=2)
        return _kill(st, _leaf_rows(st)), 64, 0
    if name == "depth_repair":
        return nested_tree(kill=(1,)), 8, 1
    if name == "nested_dead":
        return nested_tree(kill=(1, 4)), 8, 2
    raise KeyError(name)


@pytest.mark.parametrize("case", ["respawn", "no_dead", "no_candidates",
                                  "depth_repair", "nested_dead"])
def test_relocate_gs_matches_jax(case):
    jst, budget, expect = _relocate_case(case)
    jadam = seeded_adam(jst)
    tg, tadam = to_torch(jst, jadam)
    with recorded_draws() as draws:
        jg2, jadam2, jn = jmcmc.relocate_gs(jst, jadam, jax.random.PRNGKey(4),
                                            budget=budget, max_depth=12)
        jax.block_until_ready(jn)
    (sampled,) = draws
    tg2, tadam2, tn = mcmc.relocate_gs(tg, tadam, budget=budget,
                                       max_depth=12,
                                       sampled=torch.tensor(sampled))
    assert int(tn) == int(jn)
    if expect is None:
        assert int(tn) > 0
    else:
        assert int(tn) == expect
    assert_matches(tg2, tadam2, jg2, jadam2)
    check_invariants(tg2)
    # every stored depth is its parent's plus one
    nodes = tg2.nodes.numpy()
    for i in np.where(tg2.alive.numpy())[0]:
        p = nodes[i, NODE_PARENT]
        if p >= 0:
            assert nodes[i, NODE_DEPTH] == nodes[p, NODE_DEPTH] + 1, (i, p)
    if expect == 0:
        assert torch.equal(tg2.nodes, tg.nodes)
        assert torch.equal(tg2.xyz, tg.xyz)


def test_relocate_gs_extra_dead_and_own_draws():
    """extra_dead (the MIP respawn) joins the dead set; the port's own
    draws (a seeded generator) keep the tree invariants and the live
    count."""
    jst, _ = hier_state(cap=256)
    tg, tadam = to_torch(jst)
    extra = torch.zeros(tg.capacity, dtype=torch.bool)
    extra[torch.as_tensor(_leaf_rows(jst)[:5])] = True
    gen = torch.Generator().manual_seed(0)
    tg2, _, tn = mcmc.relocate_gs(tg, tadam, budget=16, max_depth=12,
                                  extra_dead=extra, generator=gen)
    assert 0 < int(tn) <= 5
    assert int(tg2.alive.sum()) == int(tg.alive.sum())
    check_invariants(tg2)


@pytest.mark.parametrize("case", ["grow", "capacity"])
def test_add_new_gs_matches_jax(case):
    if case == "grow":
        jst, _ = hier_state(cap=512)
        n_new, budget = 16, 32
    else:
        jst, _ = hier_state(cap=69)          # 65 nodes: 4 free rows
        n_new, budget = 1000, 8
    jadam = seeded_adam(jst)
    tg, tadam = to_torch(jst, jadam)
    with recorded_draws() as draws:
        jg2, jadam2, jn = jmcmc.add_new_gs(jst, jadam, jax.random.PRNGKey(2),
                                           jnp.int32(n_new), budget=budget)
        jax.block_until_ready(jn)
    (sampled,) = draws
    tg2, tadam2, tn = mcmc.add_new_gs(tg, tadam, n_new, budget=budget,
                                      sampled=torch.tensor(sampled))
    assert int(tn) == int(jn) > 0
    assert int(tn) <= (8 if case == "grow" else 2)
    assert int(tg2.alive.sum()) == int(tg.alive.sum()) + 2 * int(tn)
    assert_matches(tg2, tadam2, jg2, jadam2)
    check_invariants(tg2)


def test_add_new_gs_own_draws():
    """The port's own draws: hosts sampled once split into two children
    with the relocated opacity 1 - (1 - o)^(1/2)."""
    jst, _ = hier_state(cap=512)
    tg, tadam = to_torch(jst)
    gen = torch.Generator().manual_seed(3)
    tg2, _, tn = mcmc.add_new_gs(tg, tadam, 16, budget=32, generator=gen)
    assert int(tn) > 0
    check_invariants(tg2)
    nodes, nodes0 = tg2.nodes.numpy(), tg.nodes.numpy()
    hosts = np.where((nodes[:, NODE_CHILD_COUNT] == 2)
                     & (nodes0[:, NODE_CHILD_COUNT] == 0))[0]
    assert len(hosts) == int(tn)
    o_host = torch.sigmoid(tg.opacity_logit[hosts, 0])
    o_child = torch.sigmoid(tg2.opacity_logit[nodes[hosts, 3], 0])
    expect = torch.clamp(1.0 - torch.sqrt(1.0 - o_host), min=0.005)
    torch.testing.assert_close(o_child, expect, atol=1e-5, rtol=0)


@pytest.mark.parametrize("rows", [1000, 200_000])
def test_sample_hosts_equals_multinomial_in_float64(rows):
    """sample_hosts inverts the CDF at torch.rand's float64 uniforms, the
    draws torch.multinomial makes on the CPU: it draws what multinomial of
    the float64 probabilities draws, draw for draw (multinomial of float32
    probabilities sums its CDF in float32 and moves draws that fall near a
    boundary). Rows of probability 0 are never drawn; all-zero
    probabilities draw uniformly."""
    gen = torch.Generator().manual_seed(rows)
    probs = torch.rand((rows,), generator=gen) ** 2
    probs[torch.rand((rows,), generator=gen) < 0.3] = 0.0
    new = mcmc.sample_hosts(probs, 8192, torch.Generator().manual_seed(1))
    old = torch.multinomial(probs.double(), 8192, replacement=True,
                            generator=torch.Generator().manual_seed(1))
    assert torch.equal(new, old)
    assert bool((probs[new] > 0).all())
    flat = mcmc.sample_hosts(torch.zeros(4), 4000,
                             torch.Generator().manual_seed(2))
    counts = torch.bincount(flat, minlength=4)
    assert counts.shape == (4,) and int(counts.min()) > 800
