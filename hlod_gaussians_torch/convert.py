"""Weights and training state carried across from the JAX package.

`state_from_numpy` takes the fields of a JAX `GaussianState` as numpy arrays
(`np.asarray` of each field) and returns this package's state, so both
packages render the same scene. `train_state_from_numpy` does the same for
a JAX `FlatTrainState`, so both packages take the same training step;
`post_state_from_numpy` for a JAX `PostTrainState`; `forest_from_numpy`
turns a JAX `SPTForest`'s arrays into this package's forest, and
`packed_store_from_numpy` a JAX `PackedStore`'s matrix into this package's
out-of-core store. `stacked_train_state_from_numpy` takes a chunk-stacked
JAX `FlatTrainState` (parallel/chunk_parallel.stack_states) and
`sharded_train_state_from_numpy` one rank's rows of a gauss-sharded one
(parallel/data_parallel.shard_train_state). Nothing here imports JAX: the
caller does the `np.asarray`.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from hlod_gaussians_torch import optim
from hlod_gaussians_torch.hierarchy.spt import SPTForest
from hlod_gaussians_torch.models.gaussians import GaussianState
from hlod_gaussians_torch.train.flat import FlatTrainState
from hlod_gaussians_torch.train.offload import PackedStore, host_empty
from hlod_gaussians_torch.train.post import PostTrainState

_TENSOR_FIELDS = tuple(f.name for f in dataclasses.fields(GaussianState)
                       if f.name not in ("n_skybox", "n_scaffold"))
_DTYPES = {"alive": np.bool_, "nodes": np.int32}


def state_from_numpy(arrays: Mapping[str, np.ndarray], *, n_skybox: int,
                     n_scaffold: int = 0,
                     device=torch.device("cuda")) -> GaussianState:
    """{field: array} for every tensor field of GaussianState -> state on
    `device` (float32 parameters, bool alive, int32 node table)."""
    missing = [k for k in _TENSOR_FIELDS if k not in arrays]
    if missing:
        raise ValueError(f"missing GaussianState fields: {missing}")
    # copies: the state never aliases the caller's (possibly read-only) arrays
    tensors = {
        k: torch.tensor(np.asarray(arrays[k], dtype=_DTYPES.get(k, np.float32)),
                        device=device)
        for k in _TENSOR_FIELDS}
    return GaussianState(**tensors, n_skybox=int(n_skybox),
                         n_scaffold=int(n_scaffold))


def _adam_from_numpy(adam: Mapping, names, device) -> optim.AdamState:
    for part in ("m", "v"):
        missing = [k for k in names if k not in adam[part]]
        if missing:
            raise ValueError(f"missing Adam {part} tensors: {missing}")
    return optim.AdamState(m={k: _f32(adam["m"][k], device) for k in names},
                           v={k: _f32(adam["v"][k], device) for k in names},
                           step=int(adam["step"]))


def _f32(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32), device=device)


def train_state_from_numpy(arrays: Mapping, *, n_skybox: int,
                           n_scaffold: int = 0,
                           device=torch.device("cuda")) -> FlatTrainState:
    """The numpy leaves of a JAX FlatTrainState -> this package's state:

        {"gaussians": {field: array},                # as state_from_numpy
         "adam": {"m": {param: array}, "v": {param: array}, "step": int},
         "xyz_grad_accum": [C], "denom": [C], "max_radii": [C], "step": int}
    """
    g = state_from_numpy(arrays["gaussians"], n_skybox=n_skybox,
                         n_scaffold=n_scaffold, device=device)
    return FlatTrainState(
        gaussians=g, adam=_adam_from_numpy(arrays["adam"], tuple(g.params()),
                                           device),
        xyz_grad_accum=_f32(arrays["xyz_grad_accum"], device),
        denom=torch.tensor(np.asarray(arrays["denom"], dtype=np.int32),
                           device=device),
        max_radii=_f32(arrays["max_radii"], device),
        step=int(arrays["step"]))


def post_state_from_numpy(arrays: Mapping, *, n_skybox: int,
                          n_scaffold: int = 0,
                          device=torch.device("cuda")) -> PostTrainState:
    """The numpy leaves of a JAX PostTrainState -> this package's state:

        {"gaussians": {field: array},                # as state_from_numpy
         "adam": {"m": {param: array}, "v": {param: array}, "step": int},
         "step": int}
    """
    g = state_from_numpy(arrays["gaussians"], n_skybox=n_skybox,
                         n_scaffold=n_scaffold, device=device)
    return PostTrainState(
        gaussians=g, adam=_adam_from_numpy(arrays["adam"], tuple(g.params()),
                                           device),
        step=int(arrays["step"]))


def forest_from_numpy(arrays: Mapping[str, np.ndarray],
                      device=torch.device("cuda")) -> SPTForest:
    """{field: array} for every field of a JAX SPTForest -> this package's
    forest on `device` (float32 positions and windows, int32 indices)."""
    missing = [k for k in SPTForest._fields if k not in arrays]
    if missing:
        raise ValueError(f"missing SPTForest fields: {missing}")
    ints = ("entry_gid", "entry_spt", "spt_root_global", "ut_nodes",
            "ut_spt_id")
    return SPTForest(**{
        k: torch.tensor(np.asarray(arrays[k], dtype=np.int32 if k in ints
                                   else np.float32), device=device)
        for k in SPTForest._fields})


def packed_store_from_numpy(packed: np.ndarray, sh_degree: int,
                            step: int = 0,
                            device=torch.device("cuda")) -> PackedStore:
    """A JAX PackedStore's [cap, D] matrix and step -> this package's
    PackedStore, its matrix copied into the host memory that serves
    `device` (pinned for a CUDA device)."""
    packed = np.asarray(packed, dtype=np.float32)
    if packed.ndim != 2:
        raise ValueError(f"packed store must be [cap, D], got {packed.shape}")
    data = host_empty(packed.shape, device)
    data.numpy()[...] = packed
    return PackedStore(data, sh_degree, step=int(step))


def stacked_train_state_from_numpy(arrays: Mapping, *, n_skybox: int,
                                   n_scaffold: int = 0,
                                   device=torch.device("cuda")
                                   ) -> FlatTrainState:
    """The numpy leaves of a chunk-stacked JAX FlatTrainState (each with a
    leading chunk axis K, the steps [K]) -> this package's stacked state
    (parallel/chunk_parallel: tensors with the leading K, steps as tuples
    of K ints)."""
    from hlod_gaussians_torch.parallel import chunk_parallel

    steps = np.asarray(arrays["step"]).reshape(-1)

    def pick(tree, i):
        if isinstance(tree, Mapping):
            return {k: pick(v, i) for k, v in tree.items()}
        return np.asarray(tree)[i]
    return chunk_parallel.stack_states([
        train_state_from_numpy(pick(arrays, i), n_skybox=n_skybox,
                               n_scaffold=n_scaffold, device=device)
        for i in range(steps.shape[0])])


def sharded_train_state_from_numpy(arrays: Mapping, *, shard: int,
                                   n_shards: int, n_skybox: int,
                                   n_scaffold: int = 0,
                                   device=torch.device("cuda")
                                   ) -> FlatTrainState:
    """Shard ``shard`` of ``n_shards`` (a rank's gauss coordinate) of a JAX
    FlatTrainState whose capacity axis is sharded over `gauss` (the JAX
    package's shard_train_state): the numpy leaves of the whole state, as
    for train_state_from_numpy, -> that rank's rows, as
    data_parallel.shard_train_state places them."""
    from hlod_gaussians_torch.parallel import data_parallel

    ts = train_state_from_numpy(arrays, n_skybox=n_skybox,
                                n_scaffold=n_scaffold, device=device)
    return data_parallel.shard_rows(ts, shard, n_shards)
