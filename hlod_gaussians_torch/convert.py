"""Weights carried across from the JAX package.

`state_from_numpy` takes the fields of a JAX `GaussianState` as numpy arrays
(`np.asarray` of each field) and returns this package's state, so both
packages render the same scene. Nothing here imports JAX: the caller does
the `np.asarray`.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from hlod_gaussians_torch.models.gaussians import GaussianState

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

