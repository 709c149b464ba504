"""Checkpoint / resume for training states (port of
hlod_gaussians_tpu/utils/checkpoint.py:44-96).

One flat .npz of the full train state (parameters, alive mask, node table,
Adam moments, step) plus the metadata to rebuild it, with the JAX package's
keys, dtypes and ``__meta__`` string, so each package reads the other's
files (reference scene/gaussian_model.py:732-764 capture/restore).
"""

from __future__ import annotations

import json
import os
from typing import Union

import numpy as np
import torch

from hlod_gaussians_torch import optim
from hlod_gaussians_torch.models.gaussians import GaussianState
from hlod_gaussians_torch.train.flat import FlatTrainState
from hlod_gaussians_torch.train.post import PostTrainState

_PARAM_KEYS = ("xyz", "f_dc", "f_rest", "log_scale", "quat", "opacity_logit",
               "exposure")


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _state_arrays(g: GaussianState) -> dict:
    out = {f"g_{k}": _host(v) for k, v in g.params().items()}
    out["g_alive"] = _host(g.alive)
    out["g_nodes"] = _host(g.nodes)
    return out


def _adam_arrays(a: optim.AdamState) -> dict:
    out = {f"m_{k}": _host(v) for k, v in a.m.items()}
    out.update({f"v_{k}": _host(v) for k, v in a.v.items()})
    out["adam_step"] = np.asarray(a.step, np.int32)
    return out


def save_checkpoint(path: str, ts: Union[FlatTrainState, PostTrainState]
                    ) -> None:
    arrays = _state_arrays(ts.gaussians)
    arrays.update(_adam_arrays(ts.adam))
    arrays["step"] = np.asarray(ts.step, np.int32)
    if isinstance(ts, FlatTrainState):
        arrays["xyz_grad_accum"] = _host(ts.xyz_grad_accum)
        arrays["denom"] = _host(ts.denom)
        arrays["max_radii"] = _host(ts.max_radii)
    meta = dict(kind=type(ts).__name__, n_skybox=ts.gaussians.n_skybox,
                n_scaffold=ts.gaussians.n_scaffold)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)


def save_flat_state(path: str, ts: FlatTrainState) -> None:
    """Alias used by the pipeline's stage-resume (scaffold snapshot)."""
    save_checkpoint(path, ts)


def load_flat_state(path: str, device=torch.device("cuda")) -> FlatTrainState:
    ts = load_checkpoint(path, device=device)
    if not isinstance(ts, FlatTrainState):
        raise ValueError(f"{path} holds a {type(ts).__name__}, not a "
                         "FlatTrainState")
    return ts


def load_checkpoint(path: str, device=torch.device("cuda")
                    ) -> Union[FlatTrainState, PostTrainState]:
    """Either train state from a checkpoint of either package, on
    `device`."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))

        def t(key):
            return torch.as_tensor(z[key], device=device)

        g = GaussianState(
            **{k: t(f"g_{k}") for k in _PARAM_KEYS},
            alive=t("g_alive"), nodes=t("g_nodes"),
            n_skybox=int(meta["n_skybox"]),
            n_scaffold=int(meta.get("n_scaffold", 0)))
        adam = optim.AdamState(m={k: t(f"m_{k}") for k in _PARAM_KEYS},
                               v={k: t(f"v_{k}") for k in _PARAM_KEYS},
                               step=int(z["adam_step"]))
        step = int(z["step"])
        if meta["kind"] == "FlatTrainState":
            return FlatTrainState(
                gaussians=g, adam=adam, xyz_grad_accum=t("xyz_grad_accum"),
                denom=t("denom"), max_radii=t("max_radii"), step=step)
    return PostTrainState(gaussians=g, adam=adam, step=step)
