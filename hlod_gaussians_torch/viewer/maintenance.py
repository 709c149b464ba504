"""Viewer runtime maintenance: incremental cuts, a node-budget controller
and a device row cache fed by deltas (port of
hlod_gaussians_tpu/viewer/maintenance.py; the SIBR viewer's
runtime_switching.cu:236-491 and runtime_maintenance.cu:39-387).

* ``incremental_cut_step``: one split/collapse pass a frame over the
  persistent active-node mask. From any proper cut, repeated steps reach
  the size rule's cut of the current camera, one level per step.
* ``ActiveRowCache``: a fixed ``budget`` of device row slots for parameters
  that live on the host; a frame fetches only the newly active rows and
  recycles the slots of rows that left, so the transfer scales with the
  cut's change, not its size.
* ``BudgetController``: the viewer's auto-regulated granularity under a
  node budget.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from hlod_gaussians_torch.hierarchy.cut import node_size_dynamic
from hlod_gaussians_torch.models.gaussians import (
    NODE_CHILD_COUNT, NODE_DEPTH, NODE_PARENT)


def incremental_cut_step(
    nodes: torch.Tensor,      # [C,6]
    pos: torch.Tensor,        # [C,3]
    max_scale: torch.Tensor,  # [C]
    alive: torch.Tensor,      # [C]
    active: torch.Tensor,     # [C] current cut mask
    viewpoint: torch.Tensor,  # [3]
    target_size,
):
    """One split/collapse pass. Returns (new_active, n_split, n_collapse).

    Split: an active interior node projecting at least the target is
    replaced by its children. Collapse: a sibling group is replaced by its
    parent when the parent projects below the target and every child of
    that parent is active (changeNodesOnce's sibling-group moves,
    runtime_switching.cu:236-292); that guard keeps simultaneous collapses
    at different levels proper. Collapse wins over split, so one step maps
    a proper cut to a proper cut."""
    c = nodes.shape[0]
    parent = nodes[:, NODE_PARENT].long()
    has_parent = parent >= 0
    parent_c = torch.clamp(parent, 0, c - 1)
    real = alive & (nodes[:, NODE_DEPTH] >= 0)
    is_leaf = nodes[:, NODE_CHILD_COUNT] == 0

    size = node_size_dynamic(pos, max_scale, viewpoint)
    parent_size = torch.where(has_parent, size[parent_c],
                              torch.full_like(size, float("inf")))

    # a parent collapses only when ALL its children are in the cut
    all_child_active = torch.ones(c + 1, dtype=torch.int32,
                                  device=nodes.device).scatter_reduce(
        0, torch.where(has_parent & real, parent_c,
                       torch.full_like(parent_c, c)),
        active.to(torch.int32), "amin")[:c]
    collapse = (active & has_parent & (parent_size < target_size) & real
                & (all_child_active[parent_c] > 0))
    split = active & (size >= target_size) & ~is_leaf & ~collapse & real

    child_of_split = has_parent & split[parent_c] & real
    parent_activate = torch.zeros(c, dtype=torch.bool, device=nodes.device)
    parent_activate[parent_c[collapse]] = True
    new_active = (active & ~split & ~collapse) | child_of_split \
        | parent_activate
    return new_active, torch.sum(split), torch.sum(collapse)


def initial_cut(nodes, alive) -> np.ndarray:
    """Coarsest proper cut: the root(s). Host-side."""
    nodes = np.asarray(nodes.cpu() if isinstance(nodes, torch.Tensor)
                       else nodes)
    alive = np.asarray(alive.cpu() if isinstance(alive, torch.Tensor)
                       else alive)
    mask = np.zeros(nodes.shape[0], bool)
    mask[alive & (nodes[:, NODE_DEPTH] >= 0)
         & (nodes[:, NODE_PARENT] == -1)] = True
    return mask


@dataclasses.dataclass
class BudgetController:
    """Auto-regulated granularity under a node budget (the SIBR viewer's
    VRAM budget, README.md:233-235): coarsen when the active set nears the
    budget, refine when there is room."""

    budget: int
    target: float = 1e-3
    grow: float = 1.5
    shrink: float = 1.15
    high_water: float = 0.9
    low_water: float = 0.4
    min_target: float = 1e-7

    def update(self, n_active: int) -> float:
        if n_active > self.high_water * self.budget:
            self.target *= self.grow          # coarsen
        elif n_active < self.low_water * self.budget:
            self.target = max(self.target / self.shrink, self.min_target)
        return self.target


class ActiveRowCache:
    """Device row slots for the active set, fed by deltas.

    The master rows of every node stay on the host in pinned tensors; the
    cache owns ``budget`` slots on ``device``. `update(active_mask)` moves
    only the rows that became active (one non-blocking copy per array and
    one `index_copy_` into their slots) and frees the slots of rows that
    left; the device tensors are never reallocated."""

    def __init__(self, host_arrays: Dict[str, np.ndarray], budget: int,
                 device=torch.device("cuda")):
        self.dev = torch.device(device)
        pin = self.dev.type == "cuda"
        self.host: Dict[str, torch.Tensor] = {}
        for k, v in host_arrays.items():
            t = torch.as_tensor(np.ascontiguousarray(v))
            self.host[k] = t.pin_memory() if pin else t
        self.budget = budget
        self.cap = next(iter(self.host.values())).shape[0]
        self.slot_of_row = np.full(self.cap, -1, np.int64)
        self.row_of_slot = np.full(budget, -1, np.int64)
        self.free = list(range(budget - 1, -1, -1))
        self.device: Dict[str, torch.Tensor] = {
            k: torch.zeros((budget,) + tuple(v.shape[1:]), dtype=v.dtype,
                           device=self.dev)
            for k, v in self.host.items()}
        self.slot_valid = torch.zeros(budget, dtype=torch.bool,
                                      device=self.dev)
        self.last_fetch_rows = 0

    def update(self, active_mask) -> Tuple[int, int]:
        """Sync the cache to the new active set ([C] bool, numpy or a
        tensor). Returns (n_fetched, n_evicted)."""
        if isinstance(active_mask, torch.Tensor):
            active_mask = active_mask.cpu().numpy()
        resident = self.slot_of_row >= 0
        evict_rows = np.nonzero(resident & ~active_mask)[0]
        need_rows = np.nonzero(active_mask & ~resident)[0]
        # refuse before touching any map, so a caller that coarsens and
        # retries finds the cache as it was
        if len(need_rows) > len(self.free) + len(evict_rows):
            raise RuntimeError(
                f"active set {int(active_mask.sum())} exceeds budget "
                f"{self.budget}")
        ev_slots = self.slot_of_row[evict_rows]
        self.slot_of_row[evict_rows] = -1
        self.row_of_slot[ev_slots] = -1
        self.free.extend(int(s) for s in ev_slots)

        slots = np.asarray([self.free.pop() for _ in need_rows], np.int64)
        if len(need_rows):
            self.slot_of_row[need_rows] = slots
            self.row_of_slot[slots] = need_rows
            rows_t = torch.as_tensor(need_rows)
            slots_t = torch.as_tensor(slots).to(self.dev,
                                                non_blocking=True)
            for k, h in self.host.items():
                staged = h.index_select(0, rows_t)
                if self.dev.type == "cuda":
                    staged = staged.pin_memory()
                self.device[k].index_copy_(
                    0, slots_t, staged.to(self.dev,
                                          non_blocking=True))
        self.slot_valid = torch.as_tensor(self.row_of_slot >= 0).to(
            self.dev)
        self.last_fetch_rows = len(need_rows)
        return len(need_rows), len(evict_rows)

    def device_rows(self) -> Dict[str, torch.Tensor]:
        return self.device

    def slot_rows(self) -> np.ndarray:
        """Row index per slot (-1 = free)."""
        return self.row_of_slot
