"""The views the pipeline's quality is read on, against the JAX run's.

`chip_smoke.pipeline_cameras` builds the 112 cameras of the JAX package's
pipeline run (scripts/tpu_pipeline_scale3.py:77-101): 9 rings of 12 (two
of three train, one of three the ring test views) and 4 orbit views of the
whole grid, which no chunk trained on. They are held here to cameras made
by the JAX package's `make_camera` through that script's construction, so
that the tau tables `scripts/torch_pipeline_full_steps.py` prints beside
PIPELINE_r05.json's are read on the same views. Then the script's `run`
at a toy size returns both tables.
"""

import math
import os

import numpy as np
import pytest
import torch

import chip_smoke as cs
from hlod_gaussians_tpu.utils.camera import make_camera

torch.set_num_threads(1)

CPU = torch.device("cpu")
W = 512
N_RING = len(cs.PIPE_CENTERS) * cs.PIPE["ring"]
GROUPS = {
    "train_ring": [i for i in range(N_RING) if i % 3 != 0],
    "ring_test": [i for i in range(N_RING) if i % 3 == 0],
    "orbit": list(range(N_RING, N_RING + 4)),
}


def jax_run_cameras():
    """tpu_pipeline_scale3.py:77-101, as that script builds them."""
    centers = np.array([[x, y, 5.0] for y in [-3.0, 0.0, 3.0]
                        for x in [-3.0, 0.0, 3.0]], np.float32)

    def cam_at(pos, look):
        fwd = look - pos
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        up2 = np.cross(fwd, right)
        Rwc = np.stack([right, up2, fwd], axis=0)
        T = -Rwc @ pos
        return make_camera(Rwc.T, T, 1.0, 1.0, W, W)

    ring_n = 12
    cams = []
    for c in centers:
        for k in range(ring_n):
            ang = 2 * np.pi * (k + 0.5) / ring_n
            pos = c + np.array([1.1 * np.cos(ang), 1.1 * np.sin(ang), -3.5],
                               np.float32)
            cams.append(cam_at(pos.astype(np.float64), c.astype(np.float64)))
    for k in range(4):
        ang = 2 * np.pi * k / 4
        pos = np.array([3.5 * np.cos(ang), 3.5 * np.sin(ang), -3.0])
        cams.append(cam_at(pos, np.array([0.0, 0.0, 5.0])))
    return cams


@pytest.fixture(scope="module")
def both_cameras():
    return cs.pipeline_cameras(W, CPU), jax_run_cameras()


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_pipeline_cameras_are_the_jax_runs(both_cameras, group):
    port, jax_cams = both_cameras
    assert len(port) == len(jax_cams) == N_RING + 4
    for i in GROUPS[group]:
        p, j = port[i], jax_cams[i]
        assert (p.width, p.height) == (j.width, j.height) == (W, W)
        for f in ("world_view", "full_proj", "campos"):
            np.testing.assert_allclose(
                getattr(p, f).numpy(), np.asarray(getattr(j, f)), rtol=0,
                atol=1e-6, err_msg=f"{group} view {i}: {f}")
        for f in ("tan_fovx", "tan_fovy"):
            assert abs(float(getattr(p, f)) - float(getattr(j, f))) <= 1e-6


def test_full_steps_run_scores_ring_and_orbit(monkeypatch):
    """`torch_pipeline_full_steps.run` on the CPU at the rehearsal size:
    both tau tables, four rows each, finite PSNR, mean rendered not
    rising with tau."""
    monkeypatch.syspath_prepend(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "scripts"))
    import torch_pipeline_full_steps as full_steps
    for k, v in dict(per=500, width=32, coarse_capacity=1 << 13,
                     chunk_capacity=1 << 11, max_dup=1 << 15,
                     gt_max_dup=1 << 16, eval_budget=1 << 12).items():
        monkeypatch.setitem(cs.PIPE, k, v)
    res = full_steps.run(CPU, "cpu", iters=(4, 6, 4, 2))
    for key in ("tau_sweep_ring_heldout", "tau_sweep_global_orbit"):
        rows = res[key]
        assert [r["tau"] for r in rows] == list(cs.EVAL_TAUS), key
        assert all(math.isfinite(r["psnr"]) for r in rows), rows
        rendered = [r["mean_rendered"] for r in rows]
        assert all(a >= b for a, b in zip(rendered, rendered[1:])), rows
        assert rendered[0] > 0
    assert len(res["orbit_cut_tau0"]) == 4
    assert math.isfinite(res["black_psnr"])
    assert math.isfinite(res["black_psnr_orbit"])
    assert len(res["per_chunk_tau0"]) == 9
