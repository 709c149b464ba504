"""Weights and training state carried across from the JAX package.

`state_from_numpy` takes the fields of a JAX `GaussianState` as numpy arrays
(`np.asarray` of each field) and returns this package's state, so both
packages render the same scene. `train_state_from_numpy` does the same for
a JAX `FlatTrainState`, so both packages take the same training step.
Nothing here imports JAX: the caller does the `np.asarray`.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from hlod_gaussians_torch import optim
from hlod_gaussians_torch.models.gaussians import GaussianState
from hlod_gaussians_torch.train.flat import FlatTrainState

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

    def f32(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=device)

    adam = arrays["adam"]
    names = tuple(g.params())
    for part in ("m", "v"):
        missing = [k for k in names if k not in adam[part]]
        if missing:
            raise ValueError(f"missing Adam {part} tensors: {missing}")
    return FlatTrainState(
        gaussians=g,
        adam=optim.AdamState(m={k: f32(adam["m"][k]) for k in names},
                             v={k: f32(adam["v"][k]) for k in names},
                             step=int(adam["step"])),
        xyz_grad_accum=f32(arrays["xyz_grad_accum"]),
        denom=torch.tensor(np.asarray(arrays["denom"], dtype=np.int32),
                           device=device),
        max_radii=f32(arrays["max_radii"]),
        step=int(arrays["step"]))

