"""Port parity for the hierarchical-LOD serving render on the reference-built
oracle hierarchy (tests/fixtures/oracle/hierarchy.dhier.gz): load_dhier,
create_from_dhier with skybox rows, the dynamic cut, and render_lod against
the JAX package (cut mask and n_selected exact, image atol 2e-5);
render_lod_masked's bands against its own unbanded frame."""

import gzip
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hlod_gaussians_tpu import render as jrender
from hlod_gaussians_tpu.config import RasterizerConfig as JConfig
from hlod_gaussians_tpu.data import dhier as jdhier
from hlod_gaussians_tpu.hierarchy import cut as jcut
from hlod_gaussians_tpu.models import gaussians as jgm
from hlod_gaussians_tpu.train import post as jpost
from hlod_gaussians_tpu.utils.camera import make_camera as jmake_camera
from hlod_gaussians_torch import render as trender
from hlod_gaussians_torch.config import RasterizerConfig
from hlod_gaussians_torch.data import dhier as tdhier
from hlod_gaussians_torch.hierarchy import cut as tcut
from hlod_gaussians_torch.models import gaussians as tgm
from hlod_gaussians_torch.ops.lod_preprocess import lod_preprocess
from hlod_gaussians_torch.train import post as tpost
from hlod_gaussians_torch.utils.camera import make_camera

CPU = torch.device("cpu")
FIX = os.path.join(os.path.dirname(__file__), "fixtures", "oracle",
                   "hierarchy.dhier.gz")
W, H = 128, 96
SKY = 64
FOVX, FOVY = 1.2, 0.9


@pytest.fixture(scope="module")
def states(tmp_path_factory):
    raw = tmp_path_factory.mktemp("dhier") / "hierarchy.dhier"
    with gzip.open(FIX) as f:
        raw.write_bytes(f.read())
    jd = jdhier.load_dhier(str(raw))
    td = tdhier.load_dhier(FIX)             # reads the .gz directly
    cap = jd.pos.shape[0] + SKY + 16
    js = jpost.create_from_dhier(jd, capacity=cap, skybox_num=SKY,
                                 scene_radius=2.0)
    ts = tpost.create_from_dhier(td, capacity=cap, skybox_num=SKY,
                                 scene_radius=2.0, device=CPU)
    return jd, td, js, ts


def test_load_dhier_matches_jax(states):
    jd, td, _, _ = states
    assert td.sh_degree == jd.sh_degree
    for k in ("pos", "quat", "log_scale", "opacity", "shs", "nodes"):
        np.testing.assert_array_equal(getattr(td, k), getattr(jd, k),
                                      err_msg=k)


def test_create_from_dhier_matches_jax(states):
    _, _, js, ts = states
    assert ts.n_skybox == js.n_skybox == SKY
    for k in ("xyz", "f_dc", "f_rest", "log_scale", "quat", "opacity_logit",
              "exposure", "alive", "nodes"):
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)), err_msg=k)


@pytest.mark.parametrize("tau", [0.0, 6.0])
def test_render_lod_matches_jax(states, tau):
    _, _, js, ts = states
    ja, ta = jgm.activate(js), tgm.activate(ts)
    jc = jmake_camera(np.eye(3), np.zeros(3), FOVX, FOVY, W, H)
    tc = make_camera(np.eye(3), np.zeros(3), FOVX, FOVY, W, H, device=CPU)
    jtarget = jrender.tau_to_threshold(tau, jc.tan_fovx, W)
    ttarget = trender.tau_to_threshold(tau, tc.tan_fovx, W)

    # the cut itself, exactly
    jcr = jcut.expand_to_size_dynamic(
        js.nodes, ja.means3d, jnp.max(ja.scales, axis=1), js.alive,
        jc.campos, jc.world_view[:3, 2], jtarget)
    tcr = tcut.expand_to_size_dynamic(
        ts.nodes, ta.means3d, torch.max(ta.scales, dim=1).values, ts.alive,
        tc.campos, tc.world_view[:3, 2], ttarget)
    np.testing.assert_array_equal(tcr.render_mask.numpy(),
                                  np.asarray(jcr.render_mask))
    np.testing.assert_array_equal(tcr.kids.numpy(), np.asarray(jcr.kids))
    np.testing.assert_allclose(tcr.ts.numpy(), np.asarray(jcr.ts), atol=1e-6)
    assert tcr.render_mask.any()

    budget = 2048
    jout, jn = jrender.render_lod(
        ja.means3d, ja.scales, ja.quats, ja.opacities, ja.shs, js.nodes,
        js.alive, jc.world_view, jc.full_proj, jc.campos, jc.tan_fovx,
        jc.tan_fovy, jnp.zeros(3), jtarget, sh_degree=3, width=W, height=H,
        budget=budget, n_skybox=SKY,
        cfg=JConfig(backend="pallas", tile_w=16, tile_h=16, max_dup=1 << 15))
    with torch.no_grad():
        tout, tn = trender.render_lod(
            ta.means3d, ta.scales, ta.quats, ta.opacities, ta.shs, ts.nodes,
            ts.alive, tc.world_view, tc.full_proj, tc.campos, tc.tan_fovx,
            tc.tan_fovy, torch.zeros(3), ttarget, sh_degree=3, width=W,
            height=H, budget=budget, n_skybox=SKY,
            cfg=RasterizerConfig(backend="pallas", tile_w=16, tile_h=16,
                                 max_dup=1 << 15))
    assert int(tn) == int(jn) > 0
    assert not bool(tout.truncated)
    for k in ("image", "invdepth", "final_t"):
        np.testing.assert_allclose(getattr(tout, k).numpy(),
                                   np.asarray(getattr(jout, k)), atol=2e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(tout.n_contrib.numpy(),
                                  np.asarray(jout.n_contrib))
    assert float(tout.image.max()) > 0.05


@pytest.mark.parametrize("n", [2, 4])
def test_render_lod_masked_bands_stack_to_the_frame(states, n):
    """render_lod_masked's band=(i, n), rendered band by band in one
    process and stacked, equals the unbanded frame (atol 2e-5, n_selected
    equal): the tile-parallel ranks' frame, with the prepended skybox rows
    drawn across the band edges."""
    _, _, _, ts = states
    ta = tgm.activate(ts)
    tc = make_camera(np.eye(3), np.zeros(3), FOVX, FOVY, W, H, device=CPU)
    target = trender.tau_to_threshold(3.0, tc.tan_fovx, W)
    # 12 tile rows of 8 pixels: 6 or 3 a band
    cfg = RasterizerConfig(backend="pallas", tile_w=16, tile_h=8,
                           max_dup=1 << 16)
    args = (ta.means3d, ta.scales, ta.quats, ta.opacities, ta.shs, ts.nodes,
            ts.alive, tc.world_view, tc.full_proj, tc.campos, tc.tan_fovx,
            tc.tan_fovy, torch.zeros(3), target)
    kw = dict(sh_degree=3, width=W, height=H, n_skybox=SKY, cfg=cfg)
    with torch.no_grad():
        whole, n_whole = trender.render_lod_masked(*args, **kw)
        bands = [trender.render_lod_masked(*args, band=(i, n), **kw)
                 for i in range(n)]
    assert not bool(whole.truncated) and int(n_whole) > 0
    # some drawn skybox row reaches over a band edge
    cut = tcut.expand_to_size_dynamic(
        ts.nodes, ta.means3d, torch.max(ta.scales, dim=1).values, ts.alive,
        tc.campos, tc.world_view[:3, 2], target)
    rows = lod_preprocess(
        tcut.build_interp_table(dict(
            means3d=ta.means3d, scales=ta.scales, quats=ta.quats,
            opacities=ta.opacities, shs=ta.shs), ts.nodes),
        cut.render_mask, cut.ts, cut.kids, ts.alive, tc.world_view,
        tc.full_proj, tc.campos, tc.tan_fovx, tc.tan_fovy, width=W,
        height=H, sh_degree=3, n_skybox=SKY)
    y, r_y = rows.feats[:SKY, 1], rows.ext[:SKY, 1]
    edges = torch.arange(1, n) * (H // n)
    crossing = ((y[:, None] - r_y[:, None] < edges)
                & (y[:, None] + r_y[:, None] >= edges)).any(dim=1)
    assert bool((crossing & rows.valid[:SKY]).any())
    for out, n_sel in bands:
        assert int(n_sel) == int(n_whole) and not bool(out.truncated)
        assert out.image.shape == (3, H // n, W)
    for k in ("image", "invdepth", "final_t", "n_contrib"):
        got = torch.cat([getattr(out, k) for out, _ in bands], dim=-2)
        np.testing.assert_allclose(got.numpy(), getattr(whole, k).numpy(),
                                   atol=2e-5, err_msg=k)
