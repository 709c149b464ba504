"""The plain reference that decides `correct` and counts the work a frame
needs. Plain PyTorch, written from the published methods and not from the
measured package (nothing here imports it):

* 3D Gaussian Splatting (Kerbl et al. 2023, the CUDA rasterizer's
  preprocess and render): EWA projection with a 0.3 px dilation, a near
  plane at 0.2, real SH up to degree 3 (+0.5, clamped at 0), the 3-sigma
  tile rectangle, and front-to-back alpha blending per pixel with
  alpha = min(0.99, opacity * exp(power)), contributions below 1/255
  skipped and the pixel stopped before its transmittance drops under 1e-4;
  L1 + D-SSIM (11x11 Gaussian window, sigma 1.5) and Adam on the rows the
  view sees.
* Hierarchical 3D Gaussians (Kerbl et al. 2024): the size-driven cut
  (max scale over distance), the parent interpolation weight, the
  quaternion sign fix, and the LOD alpha
  t * alpha + (1 - t) * (1 - (1 - alpha)^(1/kids)).

The blend visits every pixel of every tile that a Gaussian's 3-sigma
rectangle covers and tests the pair there; it uses no entry list, capacity
or early tile exit. Images are computed tile by tile in chunks of at most
`CHUNK_ELEMS` (pixel, Gaussian) slots, and the training gradient in a
second pass over the same chunks, so the reference fits beside nothing.

Every function takes the dtype of its inputs: float32 is the reference,
bfloat16 the control that `correct` must reject.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
NEAR = 0.2
DILATION = 0.3
CHUNK_ELEMS = 1 << 25

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


@contextlib.contextmanager
def exact_matmuls():
    """float32 products in float32: TF32 off for matmuls and convolutions
    while the reference runs, restored after."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


class Camera(NamedTuple):
    """A pinhole view in the row-vector convention: p_view = p @ view[:3]
    + view[3], clip = [p, 1] @ full_proj."""
    view: torch.Tensor       # [4, 4]
    full_proj: torch.Tensor  # [4, 4]
    campos: torch.Tensor     # [3]
    tan_fovx: float
    tan_fovy: float
    width: int
    height: int


class Screen(NamedTuple):
    """Per-Gaussian screen quantities."""
    xy: torch.Tensor       # [N, 2] pixel-space mean
    conic: torch.Tensor    # [N, 3] inverse 2D covariance (a, b, c)
    depth: torch.Tensor    # [N] view-space z
    radius: torch.Tensor   # [N] 3-sigma pixel radius
    valid: torch.Tensor    # [N] bool


def rotation(q):
    """Unit (w, x, y, z) quaternions -> rotation matrices [..., 3, 3]."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(q.shape[:-1] + (3, 3))


def covariance(scales, quats):
    """Sigma = R diag(s^2) R^T, the quaternion normalised first."""
    q = quats / torch.sqrt(torch.clamp_min((quats * quats).sum(-1, True),
                                           1e-24))
    m = rotation(q) * scales[..., None, :]
    return m @ m.transpose(-1, -2)


def project(means, scales, quats, opacities, cam: Camera) -> Screen:
    """EWA projection of every Gaussian (the rasterizer's preprocess)."""
    v = cam.view.to(means.dtype)
    p = cam.full_proj.to(means.dtype)
    t = means @ v[:3, :3] + v[3, :3]
    hom = means @ p[:3] + p[3]
    tz = t[:, 2]
    front = tz > NEAR
    tz_s = torch.where(front, tz, torch.ones_like(tz))
    w = hom[:, 3]
    w_s = torch.where(torch.abs(w) < 1e-7, torch.full_like(w, 1e-7), w)
    xy = torch.stack([((hom[:, 0] / w_s + 1.0) * cam.width - 1.0) * 0.5,
                      ((hom[:, 1] / w_s + 1.0) * cam.height - 1.0) * 0.5], -1)

    fx = cam.width / (2.0 * cam.tan_fovx)
    fy = cam.height / (2.0 * cam.tan_fovy)
    limx, limy = 1.3 * cam.tan_fovx, 1.3 * cam.tan_fovy
    tx = torch.clamp(t[:, 0] / tz_s, -limx, limx) * tz_s
    ty = torch.clamp(t[:, 1] / tz_s, -limy, limy) * tz_s
    zero = torch.zeros_like(tz_s)
    jac = torch.stack([
        torch.stack([fx / tz_s, zero, -fx * tx / (tz_s * tz_s)], -1),
        torch.stack([zero, fy / tz_s, -fy * ty / (tz_s * tz_s)], -1)], -2)
    r = v[:3, :3]
    sigma_view = r.T @ covariance(scales, quats) @ r
    cov2 = jac @ sigma_view @ jac.transpose(-1, -2)
    a = cov2[:, 0, 0] + DILATION
    b = cov2[:, 0, 1]
    c = cov2[:, 1, 1] + DILATION
    det = a * c - b * b
    valid = front & (det > 0) & (opacities > ALPHA_MIN)
    det_s = torch.where(valid, det, torch.ones_like(det))
    conic = torch.stack([c / det_s, -b / det_s, a / det_s], -1)
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam)).detach()
    valid = valid & (radius > 0)
    return Screen(xy=xy, conic=conic, depth=tz.detach(), radius=radius,
                  valid=valid)


def sh_color(shs, means, campos, degree: int):
    """RGB of SH coefficients [N, K, 3] seen from campos: the real SH basis
    of 3DGS up to `degree`, +0.5, clamped at 0."""
    if degree == 0:
        return torch.clamp_min(SH_C0 * shs[:, 0] + 0.5, 0.0)
    d = means - campos.to(means.dtype)
    d = d / torch.sqrt((d * d).sum(-1, True) + 1e-20)
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    out = SH_C0 * shs[:, 0] - SH_C1 * y * shs[:, 1] + SH_C1 * z * shs[:, 2] \
        - SH_C1 * x * shs[:, 3]
    if degree > 1:
        xx, yy, zz = x * x, y * y, z * z
        out = (out + SH_C2[0] * x * y * shs[:, 4]
               + SH_C2[1] * y * z * shs[:, 5]
               + SH_C2[2] * (2 * zz - xx - yy) * shs[:, 6]
               + SH_C2[3] * x * z * shs[:, 7]
               + SH_C2[4] * (xx - yy) * shs[:, 8])
        if degree > 2:
            out = (out + SH_C3[0] * y * (3 * xx - yy) * shs[:, 9]
                   + SH_C3[1] * x * y * z * shs[:, 10]
                   + SH_C3[2] * y * (4 * zz - xx - yy) * shs[:, 11]
                   + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * shs[:, 12]
                   + SH_C3[4] * x * (4 * zz - xx - yy) * shs[:, 13]
                   + SH_C3[5] * z * (xx - yy) * shs[:, 14]
                   + SH_C3[6] * x * (xx - 3 * yy) * shs[:, 15])
    return torch.clamp_min(out + 0.5, 0.0)


class Work(NamedTuple):
    """What a frame needs: (pixel, Gaussian) pairs whose alpha reaches 1/255
    before the pixel's transmittance ends, the Gaussians they name, and the
    Gaussians the projection keeps."""
    pairs: int
    gaussians: int
    visible: int


def _tile_lists(scr: Screen, width, height, tile):
    """Per tile, the Gaussians whose 3-sigma rectangle covers it, in depth
    order (ties by index): (sorted Gaussian ids, tile starts, counts)."""
    tw, th = tile
    gw, gh = -(-width // tw), -(-height // th)
    dev = scr.xy.device
    xy = scr.xy.detach().float()
    r = scr.radius.float()
    x0 = torch.clamp(torch.floor((xy[:, 0] - r) / tw), 0, gw).long()
    x1 = torch.clamp(torch.floor((xy[:, 0] + r + tw - 1) / tw), 0, gw).long()
    y0 = torch.clamp(torch.floor((xy[:, 1] - r) / th), 0, gh).long()
    y1 = torch.clamp(torch.floor((xy[:, 1] + r + th - 1) / th), 0, gh).long()
    nx, ny = x1 - x0, y1 - y0
    n = torch.where(scr.valid, nx * ny, torch.zeros_like(nx))
    ids = torch.nonzero(n > 0).squeeze(1)
    ids = ids[torch.sort(scr.depth.float()[ids], stable=True).indices]
    n = n[ids]
    owner = torch.repeat_interleave(torch.arange(ids.numel(), device=dev), n)
    k = torch.arange(owner.numel(), device=dev) - (torch.cumsum(n, 0) - n)[
        owner]
    tx = x0[ids][owner] + k % nx[ids][owner]
    ty = y0[ids][owner] + torch.div(k, nx[ids][owner], rounding_mode="floor")
    tile_of = ty * gw + tx
    tile_sorted, perm = torch.sort(tile_of, stable=True)
    gid = ids[owner[perm]]
    counts = torch.bincount(tile_sorted, minlength=gw * gh)
    return gid, torch.cumsum(counts, 0) - counts, counts, (gw, gh)


def _chunks(counts, pixels):
    """Tiles, most entries first, grouped so that a group's tiles x pixels
    x its largest count stays under CHUNK_ELEMS."""
    order = torch.sort(counts, descending=True, stable=True).indices
    c = counts[order].tolist()
    order = order.tolist()
    i = 0
    while i < len(order) and c[i] > 0:
        per = max(1, CHUNK_ELEMS // max(1, pixels * c[i]))
        yield order[i:i + per], c[i]
        i += per


def blend(scr: Screen, opacity, color, width: int, height: int, tile,
          lod=None, grad_image=None, count=False):
    """Front-to-back blend of every pixel over a black background.
    `opacity` [N] and `color` [N, 3] carry gradients; `lod` = (t [N],
    kids [N]) turns on the LOD alpha. Returns the image [3, H, W] (no
    graph) and, with `count`, the Work. With `grad_image` [3, H, W] it
    instead back-propagates sum(image * grad_image) into the leaves of
    scr.xy, scr.conic, opacity and color chunk by chunk, and returns
    None."""
    tw, th = tile
    dev = scr.xy.device
    dtype = color.dtype
    gid, starts, counts, (gw, gh) = _tile_lists(scr, width, height, tile)
    pix = tw * th
    p = torch.arange(pix, device=dev)
    out = torch.zeros((gw * gh, pix, 3), dtype=dtype, device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    named = torch.zeros(scr.xy.shape[0], dtype=torch.bool, device=dev)
    g_tiles = None
    if grad_image is not None:
        g = F.pad(grad_image, (0, gw * tw - width, 0, gh * th - height))
        g_tiles = g.reshape(3, gh, th, gw, tw).permute(1, 3, 2, 4, 0) \
            .reshape(gw * gh, pix, 3)
    for tiles, k in _chunks(counts, pix):
        tiles = torch.as_tensor(tiles, device=dev)
        slot = torch.arange(k, device=dev)
        have = slot[None, :] < counts[tiles][:, None]               # [T, K]
        ent = torch.clamp(starts[tiles][:, None] + slot[None, :], 0,
                          max(gid.numel() - 1, 0))
        g_ids = gid[ent]                                            # [T, K]
        px = ((tiles % gw)[:, None] * tw + (p % tw)[None, :]).to(dtype)
        py = ((tiles // gw)[:, None] * th + (p // tw)[None, :]).to(dtype)
        inside = (px < width) & (py < height)                       # [T, P]
        with torch.set_grad_enabled(grad_image is not None):
            xy = scr.xy[g_ids]
            con = scr.conic[g_ids]
            dx = xy[:, None, :, 0] - px[:, :, None]                 # [T,P,K]
            dy = xy[:, None, :, 1] - py[:, :, None]
            power = (-0.5 * (con[:, None, :, 0] * dx * dx
                             + con[:, None, :, 2] * dy * dy)
                     - con[:, None, :, 1] * dx * dy)
            alpha = torch.clamp_max(opacity[g_ids][:, None, :]
                                    * torch.exp(power), ALPHA_MAX)
            if lod is not None:
                t = lod[0][g_ids][:, None, :].to(dtype)
                ik = (1.0 / torch.clamp_min(lod[1][g_ids], 1).to(
                    torch.float32))[:, None, :].to(dtype)
                kid_alpha = 1.0 - torch.pow(
                    torch.clamp_min(1.0 - alpha, 1e-12), ik)
                alpha = t * alpha + (1.0 - t) * kid_alpha
            with torch.no_grad():
                pre = (have[:, None, :] & inside[:, :, None]
                       & (power <= 0.0) & (alpha >= ALPHA_MIN))
                t_incl = torch.cumprod(
                    1.0 - torch.where(pre, alpha, torch.zeros_like(alpha)),
                    dim=2)
                applied = pre & (t_incl >= T_EPS)
            a = torch.where(applied, alpha, torch.zeros_like(alpha))
            trans = torch.cumprod(1.0 - a, dim=2)
            t_excl = torch.cat([torch.ones_like(trans[..., :1]),
                                trans[..., :-1]], dim=2)
            img = torch.einsum("tpk,tkc->tpc", a * t_excl, color[g_ids])
            if g_tiles is not None:
                torch.autograd.backward(img, g_tiles[tiles].to(img.dtype))
            else:
                out[tiles] = img.detach()
        if count:
            pairs += applied.sum()
            hit = applied.any(dim=1)                                # [T, K]
            named[g_ids[hit]] = True
    if grad_image is not None:
        return None
    image = out.reshape(gh, gw, th, tw, 3).permute(4, 0, 2, 1, 3).reshape(
        3, gh * th, gw * tw)[:, :height, :width]
    if count:
        return image, Work(int(pairs), int(named.sum()),
                           int(scr.valid.sum()))
    return image


def render(means, scales, quats, opacities, shs, degree, cam: Camera, tile,
           lod=None, count=False):
    """Render activated Gaussians (no gradient)."""
    with torch.no_grad(), exact_matmuls():
        scr = project(means, scales, quats, opacities, cam)
        color = sh_color(shs, means, cam.campos, degree)
        return blend(scr, opacities, color, cam.width, cam.height, tile,
                     lod=lod, count=count)


# ---- training -------------------------------------------------------------

def activate(p):
    """Raw parameters -> (means, scales, quats, opacities, shs)."""
    q = p["quat"] / torch.clamp_min(torch.linalg.vector_norm(
        p["quat"], dim=-1, keepdim=True), 1e-12)
    return (p["xyz"], torch.exp(p["log_scale"]), q,
            torch.sigmoid(p["opacity_logit"][:, 0]),
            torch.cat([p["f_dc"], p["f_rest"]], dim=1))


def _gauss_window(size=11, sigma=1.5):
    x = torch.arange(size, dtype=torch.float64) - size // 2
    g = torch.exp(-x * x / (2 * sigma * sigma))
    return g / g.sum()


def ssim(img1, img2, size=11):
    """Mean SSIM of two [C, H, W] images (zero-padded 11x11 Gaussian
    window, C1 = 0.01^2, C2 = 0.03^2)."""
    ch = img1.shape[0]
    g = _gauss_window(size)
    win = (g[:, None] * g[None, :]).to(img1.dtype).to(img1.device)
    win = win.expand(ch, 1, size, size).contiguous()

    def filt(x):
        return F.conv2d(x[None], win, padding=size // 2, groups=ch)[0]

    mu1, mu2 = filt(img1), filt(img2)
    s11 = filt(img1 * img1) - mu1 * mu1
    s22 = filt(img2 * img2) - mu2 * mu2
    s12 = filt(img1 * img2) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / (
        (mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2))
    return m.mean()


def photo_loss(image, gt, lambda_dssim):
    """(1 - lambda) L1 + lambda (1 - SSIM)."""
    l1 = torch.abs(image - gt).mean()
    return (1.0 - lambda_dssim) * l1 + lambda_dssim * (1.0 - ssim(image, gt))


def expon_lr(step, lr_init, lr_final, delay_steps=0, delay_mult=1.0,
             max_steps=1_000_000):
    """3DGS's log-linear learning-rate schedule with its sine delay."""
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    if delay_steps > 0:
        delay = delay_mult + (1 - delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / delay_steps, 0.0), 1.0))
    else:
        delay = 1.0
    t = min(max(step / max_steps, 0.0), 1.0)
    return delay * math.exp(math.log(lr_init) * (1 - t)
                            + math.log(lr_final) * t)


def learning_rates(opt: dict, step: int, extent: float) -> dict:
    """Per-leaf learning rates of 3DGS's training_setup at `step`."""
    return dict(
        xyz=expon_lr(step, opt["position_lr_init"] * extent,
                     opt["position_lr_final"] * extent,
                     delay_mult=opt["position_lr_delay_mult"],
                     max_steps=opt["position_lr_max_steps"]),
        f_dc=opt["feature_lr"], f_rest=opt["feature_lr"] / 20.0,
        opacity_logit=opt["opacity_lr"], log_scale=opt["scaling_lr"],
        quat=opt["rotation_lr"],
        exposure=expon_lr(step, opt["exposure_lr_init"],
                          opt["exposure_lr_final"],
                          opt["exposure_lr_delay_steps"],
                          opt["exposure_lr_delay_mult"], opt["iterations"]))


LEAVES = ("xyz", "f_dc", "f_rest", "log_scale", "quat", "opacity_logit",
          "exposure")


def loss_and_grads(p, cam: Camera, gt, degree, tile, opt):
    """One view's loss and the gradient of every leaf of `p`:
    (loss, {leaf: grad}, visible [N] bool)."""
    with exact_matmuls():
        leaves = {k: p[k].detach().requires_grad_(True) for k in LEAVES}
        means, scales, quats, op, shs = activate(leaves)
        scr = project(means, scales, quats, op, cam)
        color = sh_color(shs, means, cam.campos, degree)
        feats = (scr.xy, scr.conic, op, color)
        leaf = [f.detach().requires_grad_(True) for f in feats]
        lscr = scr._replace(xy=leaf[0], conic=leaf[1])
        with torch.no_grad():
            image = blend(lscr, leaf[2], leaf[3], cam.width, cam.height,
                          tile)
        image.requires_grad_(True)
        ex = leaves["exposure"][0]
        shown = (ex[:3, :3] @ image.reshape(3, -1) + ex[:3, 3:4]).reshape(
            image.shape)
        loss = photo_loss(shown, gt, opt["lambda_dssim"])
        g_img, g_ex = torch.autograd.grad(loss, [image, leaves["exposure"]])
        blend(lscr, leaf[2], leaf[3], cam.width, cam.height, tile,
              grad_image=g_img)
        outs = [(f, l.grad) for f, l in zip(feats, leaf) if l.grad is not None]
        names = [k for k in LEAVES if k != "exposure"]
        got = torch.autograd.grad([f for f, _ in outs], [leaves[k]
                                                          for k in names],
                                  [g for _, g in outs], allow_unused=True)
        grads = {k: torch.zeros_like(leaves[k]) if gk is None else gk
                 for k, gk in zip(names, got)}
        grads["exposure"] = g_ex
    return loss.detach(), grads, scr.valid


def adam_step(p, grads, m, v, step, lrs, visible, b1=0.9, b2=0.999,
              eps=1e-15):
    """Adam on the rows `visible` marks (the exposure: the rows whose
    gradient is nonzero); other rows keep parameters and moments."""
    bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
    new_p, new_m, new_v = {}, {}, {}
    for k in LEAVES:
        g = grads[k]
        m1 = b1 * m[k] + (1 - b1) * g
        v1 = b2 * v[k] + (1 - b2) * g * g
        p1 = p[k] - lrs[k] * (m1 / bc1) / (torch.sqrt(v1 / bc2) + eps)
        rows = (torch.any((g != 0).reshape(g.shape[0], -1), dim=1)
                if k == "exposure" else visible)
        keep = rows.reshape((-1,) + (1,) * (g.ndim - 1))
        new_p[k] = torch.where(keep, p1, p[k])
        new_m[k] = torch.where(keep, m1, m[k])
        new_v[k] = torch.where(keep, v1, v[k])
    return new_p, new_m, new_v


def shrink_big(p, extent, frac):
    """Gaussians whose largest scale passes frac * extent shrink by 0.8."""
    ls = p["log_scale"]
    big = torch.max(ls, dim=-1).values > math.log(extent * frac)
    return dict(p, log_scale=torch.where(big[:, None], ls + math.log(0.8),
                                         ls))


def train_steps(p0, views, degree, tile, opt, extent, big_frac, n_steps):
    """`n_steps` steps of 3DGS training from raw parameters p0 over views
    [(Camera, target)]: ([loss], first step's gradients, parameters after
    the last step, visible rows of the first step)."""
    p = dict(p0)
    m = {k: torch.zeros_like(p[k]) for k in LEAVES}
    v = {k: torch.zeros_like(p[k]) for k in LEAVES}
    losses, first = [], None
    for i in range(n_steps):
        cam, gt = views[i]
        loss, grads, visible = loss_and_grads(p, cam, gt, degree, tile, opt)
        losses.append(float(loss))
        if first is None:
            first = (grads, visible)
        lrs = learning_rates(opt, i, extent)
        p, m, v = adam_step(p, grads, m, v, i + 1, lrs, visible)
        p = shrink_big(p, extent, big_frac)
    return losses, first[0], p, first[1]


# ---- hierarchical LOD -----------------------------------------------------

NODE_DEPTH, NODE_PARENT, NODE_CHILDREN = 0, 1, 2


def lod_cut(tree, campos, target):
    """The size-driven cut: (mask [C], t [C], kids [C]). A node is drawn
    when it is a leaf at least `target` in size, or smaller than `target`
    under a parent that is at least `target`; size = max scale over the
    distance to the viewpoint."""
    pos, nodes = tree["pos"], tree["nodes"]
    dtype = pos.dtype
    d = campos.to(dtype)[None] - pos
    size = torch.max(tree["scale"], dim=1).values / torch.clamp_min(
        torch.sqrt((d * d).sum(1)), 1e-12)
    has_parent = nodes[:, NODE_PARENT] >= 0
    parent = torch.clamp(nodes[:, NODE_PARENT], min=0).long()
    p_size = torch.where(has_parent, size[parent],
                         torch.full_like(size, float("inf")))
    leaf = nodes[:, NODE_CHILDREN] == 0
    mask = (tree["alive"] & (nodes[:, NODE_DEPTH] >= 0)
            & (((size >= target) & leaf)
               | (has_parent & (p_size >= target) & (size < target))))
    start = torch.maximum(0.5 * p_size, size)
    diff = p_size - start
    one = torch.ones_like(size)
    inner = torch.where(diff <= 0, one, torch.clamp_min(
        1.0 - torch.clamp_min(target - start, 0.0)
        / torch.where(diff <= 0, one, diff), 0.0))
    t = torch.where(~has_parent | (p_size > 2.0 * target), one, inner)
    kids = torch.where(has_parent, nodes[parent, NODE_CHILDREN],
                       torch.ones_like(nodes[:, 0]))
    return mask, t, torch.clamp_min(kids, 1)


def lod_frame(tree, cam: Camera, target, tile, degree, count=False):
    """One hierarchical frame: the cut, the parent interpolation, and the
    blend with the LOD alpha -> (image [3, H, W], nodes drawn[, Work])."""
    with torch.no_grad():
        mask, t, kids = lod_cut(tree, cam.campos, target)
        idx = torch.nonzero(mask).squeeze(1)
        parent = torch.clamp(tree["nodes"][idx, NODE_PARENT], min=0).long()
        tc = t[idx][:, None]

        def lerp(key):
            a, b = tree[key][idx], tree[key][parent]
            shape = (-1,) + (1,) * (a.ndim - 1)
            return tc.reshape(shape) * a + (1.0 - tc.reshape(shape)) * b

        qc, qp = tree["quat"][idx], tree["quat"][parent]
        qp = torch.where((qc * qp).sum(1, True) < 0, -qp, qp)
        q = tc * qc + (1.0 - tc) * qp
        q = q / torch.clamp_min(torch.linalg.vector_norm(q, dim=1,
                                                         keepdim=True), 1e-12)
        out = render(lerp("pos"), lerp("scale"), q, lerp("opacity"),
                     lerp("sh"), degree, cam, tile,
                     lod=(t[idx], kids[idx]), count=count)
    if count:
        return out[0], idx.numel(), out[1]
    return out, idx.numel()


def to_uint8(image):
    """[3, H, W] in [0, 1] -> [H, W, 3] uint8, truncated, as a viewer
    receives it."""
    return (torch.clamp(image.float(), 0, 1).permute(1, 2, 0) * 255).to(
        torch.uint8)
