"""The needed-pair count that the rooflines and mfu divide by equals a
brute-force count on a tiny frame: per pixel, the Gaussians of its tile's
3-sigma rectangles in depth order, blended one by one in float32 until
the transmittance would drop under 1e-4."""

import numpy as np
import pytest
import torch

from benchmark.harness import data, reference

CPU = torch.device("cpu")


def brute_force(scr, opacity, width, height, tile, lod=None):
    xy = scr.xy.numpy()
    con = scr.conic.numpy()
    op = opacity.numpy()
    r = scr.radius.numpy()
    valid = scr.valid.numpy()
    order = sorted(np.flatnonzero(valid), key=lambda i: (scr.depth[i], i))
    tw, th = tile
    gw, gh = -(-width // tw), -(-height // th)
    f32 = np.float32
    pairs, named = 0, set()
    for py in range(height):
        for px in range(width):
            tx, ty = px // tw, py // th
            t = f32(1.0)
            for i in order:
                x0 = min(max(np.floor((xy[i, 0] - r[i]) / tw), 0), gw)
                x1 = min(max(np.floor((xy[i, 0] + r[i] + tw - 1) / tw), 0), gw)
                y0 = min(max(np.floor((xy[i, 1] - r[i]) / th), 0), gh)
                y1 = min(max(np.floor((xy[i, 1] + r[i] + th - 1) / th), 0), gh)
                if not (x0 <= tx < x1 and y0 <= ty < y1):
                    continue
                dx, dy = f32(xy[i, 0] - f32(px)), f32(xy[i, 1] - f32(py))
                power = f32(f32(-0.5) * f32(con[i, 0] * dx * dx
                                            + con[i, 2] * dy * dy)
                            - f32(con[i, 1] * dx * dy))
                if power > 0:
                    continue
                alpha = min(f32(0.99), f32(op[i] * np.exp(power, dtype=f32)))
                if lod is not None:
                    tt, kids = float(lod[0][i]), float(lod[1][i])
                    kid = f32(1.0) - f32(max(1.0 - alpha, 1e-12)) ** f32(
                        1.0 / kids)
                    alpha = f32(tt * alpha + (1.0 - tt) * kid)
                if alpha < 1.0 / 255.0:
                    continue
                nt = f32(t * f32(1.0 - alpha))
                if nt < 1e-4:
                    break
                t = nt
                pairs += 1
                named.add(int(i))
    return pairs, len(named)


@pytest.mark.parametrize("lod", [False, True])
def test_needed_pairs_equal_a_brute_force_count(lod):
    w, h, tile = 40, 24, (8, 8)
    g = torch.Generator().manual_seed(9)
    n = 60
    means = torch.randn((n, 3), generator=g) * 0.6
    means[:, 2] += 4.0
    scales = torch.exp(torch.randn((n, 3), generator=g) * 0.4 - 2.3)
    quats = torch.randn((n, 4), generator=g)
    quats = quats / quats.norm(dim=1, keepdim=True)
    opacity = torch.rand((n,), generator=g) * 0.98 + 0.01
    shs = torch.randn((n, 16, 3), generator=g) * 0.2
    cam = data.yaw_camera(0.0, w, h, 1.2, 0.8, CPU)
    ts = (torch.rand((n,), generator=g), torch.full((n,), 2)) if lod \
        else None
    _, work = reference.render(means, scales, quats, opacity, shs, 3, cam,
                               tile, lod=ts, count=True)
    scr = reference.project(means, scales, quats, opacity, cam)
    pairs, named = brute_force(scr, opacity, w, h, tile, lod=ts)
    assert pairs > 100
    assert (work.pairs, work.gaussians) == (pairs, named)
    assert work.visible == int(scr.valid.sum())
