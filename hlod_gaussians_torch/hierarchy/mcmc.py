"""MCMC densification on the hierarchy, 3DGS-as-MCMC style (port of
hlod_gaussians_tpu/hierarchy/mcmc.py; reference
scene/gaussian_model.py:1569-1767 and
hierarchy-rasterizer/cuda_rasterizer/utils.cu:1-51).

* `compute_relocation` — Eq. (9) of "3D Gaussian Splatting as MCMC" in the
  JAX package's closed form: the binomial double sum collapses by the
  hockey-stick identity to one masked sum over k.
* `relocate_gs` — dead low-opacity leaves respawn at opacity-sampled alive
  leaves; the dead node's sibling is promoted into the parent (tree
  contraction) and both freed slots become the two children of the host.
* `add_new_gs` — grows the model by splitting opacity-sampled leaves into
  two relocated copies in free rows.

Both run at a static budget of lanes with validity masks, as the JAX
package does. Scatters that JAX writes with ``mode="drop"`` go to tensors
with one spare row past the end: a lane's index is wrapped once if negative
and sent to the spare row if still out of range, JAX's rule. The host
draws come from `sample_hosts` with an explicit `torch.Generator`; the
callers also take the drawn indices (``sampled``), so the same draws can be
replayed in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from hlod_gaussians_torch import optim
from hlod_gaussians_torch.models import gaussians as gm
from hlod_gaussians_torch.models.gaussians import (
    GaussianState, NODE_CHILD_COUNT, NODE_DEPTH, NODE_FIRST_CHILD,
    NODE_NEXT_SIBLING, NODE_PARENT)
from hlod_gaussians_torch.ops import drop_index, mark_rows

N_MAX = 51  # reference reloc_utils.py binom table size
_PARAMS = ("xyz", "f_dc", "f_rest", "opacity_logit", "log_scale", "quat")


def compute_relocation(opacity_old, scale_old, n):
    """New (opacity, scale) for a Gaussian respawned n times (utils.cu:9-36).

    opacity_old [M], scale_old [M,3], n [M] int (>=1).
    Closed form: opacity_new = 1 - (1-o)^(1/n);
    denom = sum_{k=0}^{n-1} C(n,k+1) (-1)^k / sqrt(k+1) * opacity_new^{k+1};
    scale_new = (o / denom) * scale_old.
    """
    n = torch.clamp(n.to(torch.float32), 1, N_MAX)
    op_new = 1.0 - torch.pow(torch.clamp(1.0 - opacity_old, 1e-12, 1.0),
                             1.0 / n)

    k = torch.arange(N_MAX, dtype=torch.float32,
                     device=opacity_old.device)[None, :]        # [1, n_max]
    # C(n, k+1) via lgamma, masked to k < n
    nc = n[:, None]
    log_binom = (torch.lgamma(nc + 1.0) - torch.lgamma(k + 2.0)
                 - torch.lgamma(torch.clamp_min(nc - k, 1.0)))
    binom = torch.exp(log_binom)
    sign = torch.where(k % 2 == 0, 1.0, -1.0)
    term = binom * sign / torch.sqrt(k + 1.0) * torch.pow(
        torch.clamp_min(op_new[:, None], 1e-12), k + 1.0)
    denom = torch.sum(torch.where(k < nc, term, 0.0), dim=1)

    coeff = opacity_old / torch.where(torch.abs(denom) < 1e-12,
                                      torch.full_like(denom, 1e-12), denom)
    return op_new, coeff[:, None] * scale_old


def _update_params(state: GaussianState, idxs, n) -> dict:
    """Host parameters gathered with MCMC-relocated opacity and scale
    (reference _update_params, gaussian_model.py:1569-1578)."""
    op_old = torch.sigmoid(state.opacity_logit[idxs, 0])
    sc_old = torch.exp(state.log_scale[idxs])
    op_new, sc_new = compute_relocation(op_old, sc_old, n)
    op_new = torch.clamp(op_new, 0.005, 1.0 - 1e-7)
    return dict(
        xyz=state.xyz[idxs], f_dc=state.f_dc[idxs], f_rest=state.f_rest[idxs],
        opacity_logit=gm.inverse_sigmoid(op_new)[:, None],
        log_scale=torch.log(torch.clamp_min(sc_new, 1e-12)),
        quat=state.quat[idxs])


def sample_hosts(probs, k: int, generator: Optional[torch.Generator] = None):
    """k row indices ~ probs, with replacement (reference _sample_alives,
    gaussian_model.py:1580-1586). All-zero probs draw uniformly: the
    callers then use none of the draws."""
    safe = torch.where(torch.sum(probs) > 0, probs, torch.ones_like(probs))
    return torch.multinomial(safe, k, replacement=True, generator=generator)


def _counts(sampled, cap: int):
    """[cap] int32 multiplicity of each row in `sampled`."""
    return torch.zeros((cap,), dtype=torch.int32,
                       device=sampled.device).scatter_add_(
        0, sampled, torch.ones_like(sampled, dtype=torch.int32))


def _spare(t):
    """t with one spare row appended (the target of dropped lanes)."""
    return torch.cat([t, t[:1]])


def _first_true(mask, size: int):
    """Indices of the True rows in ascending order, padded with len(mask)
    to `size` (jnp.nonzero(size=, fill_value=len)); a sort, no sync."""
    c = mask.shape[0]
    idx = torch.where(mask, torch.arange(c, device=mask.device), c)
    vals = torch.sort(idx).values[:size]
    if size > c:
        vals = torch.cat([vals, torch.full((size - c,), c, dtype=vals.dtype,
                                           device=vals.device)])
    return vals


def _unique_first(sampled, cap: int, k_out: int):
    """First occurrence of each sampled value in SAMPLING ORDER, compacted
    to k_out (padded with `cap`). Order preservation matters: a sorted
    unique would favour low row indices whenever more unique hosts are
    sampled than dead slots (the reference's multinomial keeps draw
    order)."""
    k2 = sampled.shape[0]
    pos = torch.arange(k2, device=sampled.device)
    firstpos = torch.full((cap + 1,), k2, dtype=torch.int64,
                          device=sampled.device).scatter_reduce(
        0, sampled, pos, "amin")
    is_first = firstpos[sampled] == pos
    key = torch.where(is_first, pos, k2)
    order = torch.sort(key, stable=True).indices
    uniq = torch.where(key[order] < k2, sampled[order], cap)[:k_out]
    return uniq, torch.sum(is_first)


def _usable(state: GaussianState):
    nodes = state.nodes
    return (state.alive & (nodes[:, NODE_CHILD_COUNT] == 0)
            & ~state.skybox_mask & (nodes[:, NODE_DEPTH] >= 0))


def _child_rows(host_depth, host, sibling):
    """Node rows of a host's new children: depth, parent, no children, next
    sibling (0 = chain end)."""
    zeros = torch.zeros_like(host_depth)
    return torch.stack([host_depth + 1, host.to(torch.int32), zeros, zeros,
                        sibling.to(torch.int32), zeros], dim=-1)


def relocate_gs(
    state: GaussianState,
    adam: optim.AdamState,
    dead_opacity: float = 0.005,
    *,
    budget: int = 4096,
    max_depth: int = 40,
    extra_dead: Optional[torch.Tensor] = None,
    sampled: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[GaussianState, optim.AdamState, torch.Tensor]:
    """Respawn dead leaves at sampled alive leaves with tree contraction
    (reference relocate_gs, gaussian_model.py:1588-1698).

    ``extra_dead`` ([C] bool) extends the low-opacity dead set (the MIP
    respawn of never-visible SPT entries, train_post.py:752-761).
    ``sampled`` ([2*budget] row indices) replaces the host draw from
    `generator`. Processes up to `budget` dead leaves; returns (state, adam,
    n_relocated as a 0-d tensor)."""
    cap = state.capacity
    dev = state.xyz.device
    nodes = state.nodes
    opacity = torch.sigmoid(state.opacity_logit[:, 0])
    usable = _usable(state)

    dead = usable & (opacity < dead_opacity)
    if extra_dead is not None:
        dead = dead | (usable & extra_dead)
    # if a node AND its sibling are dead, keep the sibling (second child)
    dead = dead & ~mark_rows(
        cap, torch.where(dead, nodes[:, NODE_NEXT_SIBLING], cap))

    # sibling of each dead node: next_sibling if first child, else parent's
    # first child
    parent = torch.clamp(nodes[:, NODE_PARENT], 0, cap - 1).long()
    sib_of = torch.where(nodes[:, NODE_NEXT_SIBLING] > 0,
                         nodes[:, NODE_NEXT_SIBLING],
                         nodes[parent, NODE_FIRST_CHILD])

    # respawn host candidates: alive leaves that are neither dead nor a
    # sibling of a dead node
    candidates = usable & ~dead & ~mark_rows(
        cap, torch.where(dead, sib_of, cap))

    dead_idx = _first_true(dead, budget)
    n_dead = torch.sum(dead)

    probs = torch.where(candidates, opacity, 0.0)
    if sampled is None:
        sampled = sample_hosts(probs, 2 * budget, generator)
    sampled = sampled.long().to(dev)
    counts = _counts(sampled, cap)
    hosts, n_hosts = _unique_first(sampled, cap, budget)

    n_reloc = torch.clamp_max(torch.minimum(n_dead, n_hosts), budget)
    # no usable respawn host: relocate nothing
    n_reloc = torch.where(torch.sum(probs) > 0.0, n_reloc, 0)
    valid = torch.arange(budget, device=dev) < n_reloc
    d = torch.where(valid, dead_idx, cap)                # dead slot (child 1)
    h = torch.where(valid, hosts, cap)                   # respawn host
    d_c = torch.clamp(d, 0, cap - 1)
    h_c = torch.clamp(h, 0, cap - 1)
    s = torch.where(valid, sib_of[d_c].long(), cap)        # sibling (child 2)
    s_c = torch.clamp(s, 0, cap - 1)
    p = torch.where(valid, nodes[d_c, NODE_PARENT].long(), cap)  # parent slot

    new_p = _update_params(state, h_c, counts[h_c] + 1)

    # 1) promote the sibling into the parent slot, level by level from the
    #    deepest up (gaussian_model.py:1643-1664); each level reads the
    #    depths the level before wrote
    params = {k: _spare(getattr(state, k)) for k in _PARAMS}
    nodes2 = _spare(nodes)
    for depth in range(max_depth, 0, -1):
        at_depth = valid & (nodes2[s_c, NODE_DEPTH] == depth)
        src_c = torch.clamp(torch.where(at_depth, s, cap), 0, cap - 1)
        dst = torch.where(at_depth, p, cap)
        dst_i = drop_index(dst, cap)
        dst_c = torch.clamp(dst, 0, cap - 1)
        dst32 = dst.to(torch.int32)
        for name in _PARAMS:
            params[name][dst_i] = params[name][src_c]
        nodes2[dst_i, NODE_CHILD_COUNT] = nodes2[src_c, NODE_CHILD_COUNT]
        nodes2[dst_i, NODE_FIRST_CHILD] = nodes2[src_c, NODE_FIRST_CHILD]
        # re-parent the promoted subtree's children
        fc = torch.where(at_depth & (nodes2[src_c, NODE_CHILD_COUNT] > 0),
                         nodes2[src_c, NODE_FIRST_CHILD].long(), cap)
        fc_i = drop_index(fc, cap)
        nodes2[fc_i, NODE_PARENT] = dst32
        nodes2[fc_i, NODE_DEPTH] = nodes2[dst_c, NODE_DEPTH] + 1
        fc_c = torch.clamp(fc, 0, cap - 1)
        sc2_i = drop_index(torch.where(
            fc < cap, nodes2[fc_c, NODE_NEXT_SIBLING].long(), cap), cap)
        nodes2[sc2_i, NODE_PARENT] = dst32
        nodes2[sc2_i, NODE_DEPTH] = nodes2[dst_c, NODE_DEPTH] + 1

    # 2) respawned params into BOTH freed slots (dead + sibling)
    d_i, s_i, h_i = drop_index(d, cap), drop_index(s, cap), drop_index(h, cap)
    for name, val in new_p.items():
        params[name][d_i] = val
        params[name][s_i] = val

    # 3) host becomes interior with children (d, s)
    host_depth = nodes2[h_c, NODE_DEPTH]
    nodes2[h_i, NODE_CHILD_COUNT] = 2
    nodes2[h_i, NODE_FIRST_CHILD] = d_c.to(torch.int32)
    nodes2[d_i] = _child_rows(host_depth, h_c, s_c)
    nodes2[s_i] = _child_rows(host_depth, h_c, torch.zeros_like(s_c))
    nodes2 = nodes2[:cap]

    # depth repair: the promotion rewires only the DIRECT children of the
    # promoted slot, so a 2+ level subtree keeps stale depths; re-derive
    # every depth from the parent chain in max_depth passes
    par_all = nodes2[:, NODE_PARENT]
    has_par = par_all >= 0
    par_cl = torch.clamp(par_all, 0, cap - 1).long()
    depth_col = nodes2[:, NODE_DEPTH]
    for _ in range(max_depth):
        depth_col = torch.where(has_par, depth_col[par_cl] + 1, depth_col)
    nodes2[:, NODE_DEPTH] = depth_col

    # 4) fresh moments for every touched slot, the parent slot included: it
    #    took the promoted sibling's parameters (replace_tensors_to_optimizer
    #    resets every replaced row)
    touched = mark_rows(cap, d) | mark_rows(cap, s) | mark_rows(cap, p)
    adam = optim.zero_rows(adam, touched)

    new_state = dataclasses.replace(
        state, nodes=nodes2, **{k: v[:cap] for k, v in params.items()})
    return new_state, adam, n_reloc


def add_new_gs(
    state: GaussianState,
    adam: optim.AdamState,
    n_new,                       # target number of NEW gaussians (pairs*2)
    *,
    budget: int = 4096,
    sampled: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[GaussianState, optim.AdamState, torch.Tensor]:
    """Split opacity-sampled leaves into two relocated children in free
    capacity rows (reference add_new_gs, gaussian_model.py:1700-1767).

    Only hosts sampled EXACTLY once are used (the reference's `ratio == 1`
    filter). ``sampled`` ([budget] row indices) replaces the draw from
    `generator`. Returns (state, adam, n_added_pairs as a 0-d tensor)."""
    cap = state.capacity
    dev = state.xyz.device
    nodes = state.nodes
    opacity = torch.sigmoid(state.opacity_logit[:, 0])

    n_pairs_target = torch.clamp_max(
        torch.as_tensor(n_new, device=dev) // 2, budget)
    probs = torch.where(_usable(state), opacity, 0.0)
    if sampled is None:
        sampled = sample_hosts(probs, budget, generator)
    sampled = sampled.long().to(dev)
    # hosts sampled exactly once
    host_mask = mark_rows(cap, sampled) & (_counts(sampled, cap) == 1)
    hosts_all = _first_true(host_mask, budget)
    n_hosts = torch.sum(host_mask)

    # free slots: two per host
    free = ~state.alive
    free_idx = _first_true(free, cap)

    lane = torch.arange(budget, device=dev)
    n_sel = torch.minimum(torch.minimum(n_hosts, n_pairs_target),
                          torch.sum(free) // 2)
    # no usable host at all: split nothing (JAX's categorical draws row 0)
    n_sel = torch.where(torch.sum(probs) > 0.0, n_sel, 0)
    valid = lane < n_sel
    h = torch.where(valid, hosts_all, cap)
    h_c = torch.clamp(h, 0, cap - 1)
    c0 = torch.where(valid, free_idx[torch.clamp(2 * lane, 0, cap - 1)], cap)
    c1 = torch.where(valid, free_idx[torch.clamp(2 * lane + 1, 0, cap - 1)],
                     cap)
    c0_c = torch.clamp(c0, 0, cap - 1)
    c1_c = torch.clamp(c1, 0, cap - 1)
    c0_i, c1_i = drop_index(c0, cap), drop_index(c1, cap)

    new_p = _update_params(state, h_c,
                           torch.full((budget,), 2, dtype=torch.int32,
                                      device=dev))
    params = {k: _spare(getattr(state, k)) for k in _PARAMS}
    for name, val in new_p.items():
        params[name][c0_i] = val
        params[name][c1_i] = val

    host_depth = nodes[h_c, NODE_DEPTH]
    nodes2 = _spare(nodes)
    h_i = drop_index(h, cap)
    nodes2[h_i, NODE_CHILD_COUNT] = 2
    nodes2[h_i, NODE_FIRST_CHILD] = c0_c.to(torch.int32)
    nodes2[c0_i] = _child_rows(host_depth, h_c, c1_c)
    nodes2[c1_i] = _child_rows(host_depth, h_c, torch.zeros_like(c1_c))

    alive = _spare(state.alive)
    alive[c0_i] = True
    alive[c1_i] = True
    adam = optim.zero_rows(adam, mark_rows(cap, c0) | mark_rows(cap, c1))

    new_state = dataclasses.replace(
        state, nodes=nodes2[:cap], alive=alive[:cap],
        **{k: v[:cap] for k, v in params.items()})
    return new_state, adam, n_sel
