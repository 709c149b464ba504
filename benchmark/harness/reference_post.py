"""The plain reference of hierarchy post-optimization (Kerbl et al. 2024,
the hierarchy optimization that the fork runs as train_post.py), for the
comparison that decides `correct` in the post cells. Plain PyTorch,
written from the method and not from the measured package (nothing here
imports it); the projection, SH, blend, SSIM, learning rates and Adam are
reference.py's.

* The SPT working set, from its definition, node by node over the node table
  (parent 1, child count 2), top down from the roots through the parent
  column: the upper tree is every node whose ancestors all have prod(scale)
  above `spt_root_volume`; a node of it that does not (a leaf included) is
  cut, and owns the nodes below it; a cut interior node owning at least
  `min_spt_size` nodes (itself included) is an SPT root, and its nodes are
  SPT members. Each member's granularity distance is sqrt(s0 s1 + s0 s2 + s1
  s2) / `spt_target_granularity` (a leaf's -1e9); its window's lower end is
  the least of granularity distance plus distance to the root along the path
  from the root to it, its upper end the parent's lower end (the root's
  1e12). A view selects a member when its root's subtree sphere (centred at
  the root; radius the largest distance to the root plus 3 max scale over the
  members) passes the four side planes of the frustum and the camera's
  distance to the root, times the multiplier, lies strictly inside the
  window; and every other leaf (of the upper tree, or of an SPT too small to
  be one) whose own sphere of 3 max scale passes the planes.
* The over-budget fallback: multipliers 1, g, g^2 (g =
  `distance_multiplier_until_budget`), the first whose working set fits
  `max_gaussian_budget`, else the last. train_post.py grows the
  multiplier until the set fits; the program tries three, and a budget of
  10^8 rows is never reached here.
* The post step: the working set (and the skybox) rendered with the
  antialiasing of 3DGS's alt-rasterizer (opacity times sqrt(det / det
  dilated), the ratio floored at 2.5e-5), as the post step renders, at
  the training SH degree; L1 + D-SSIM plus `lambda_opacity` times the mean
  opacity over the working set (train_post.py's regularizer); no exposure,
  which the post loss does not apply; Adam on the rows the projection
  keeps, geometry frozen on skybox rows, every learning rate but the
  exposure's times `lr_multiplier`.

Departures from train_post.py: no SPT cache reuse between views (the
post loop's budgeted cut does not reuse either); the upper tree's coarse
LOD condition is all true, as train_post.py overrides it; the MCMC
noise, densification and the SPT rebuild are left out (the cells set no
noise and take no round in their checked steps).

Every function takes the dtype of its inputs: float32 is the reference,
bfloat16 the control.
"""

from __future__ import annotations

import torch

from benchmark.harness import reference as ref

FAR = 1e12
LEAF_DISTANCE = -1e9
AA_FLOOR = 2.5e-5
ROW_LEAVES = ("xyz", "f_dc", "f_rest", "log_scale", "quat", "opacity_logit")
GEOMETRY = ("xyz", "quat", "log_scale")
DEPTH, PARENT, CHILDREN = 0, 1, 2


# ---- the SPT working set ----------------------------------------------

def _levels(parent, live):
    """The live rows level by level from the roots down, found through the
    parent column alone (a depth column is not trusted: one that a device
    log2 rounded low would put a child beside its parent)."""
    front = live & (parent < 0)
    levels = []
    while bool(front.any()):
        rows = torch.nonzero(front).squeeze(1)
        levels.append(rows)
        mark = torch.zeros_like(front)
        mark[rows] = True
        front = live & (parent >= 0) & mark[parent.clamp(min=0)]
    return levels


def spt_nodes(p: dict, nodes, alive, post: dict) -> dict:
    """What the working set needs of each node, with no camera: {pos,
    plain [C] (a leaf outside every SPT), member [C], owner [C] (its cut
    node, -1 in the upper tree), e_min, e_max [C], bound [C] (the plain
    leaf's 3 max scale, the SPT root's subtree sphere)}."""
    pos = p["xyz"]
    scale = torch.exp(p["log_scale"])
    c = nodes.shape[0]
    dev = pos.device
    depth = nodes[:, DEPTH].long()
    parent = nodes[:, PARENT].long()
    leaf = nodes[:, CHILDREN] == 0
    live = alive & (depth >= 0)
    big = live & ~leaf & (scale[:, 0] * scale[:, 1] * scale[:, 2]
                          > post["spt_root_volume"])
    idx = torch.arange(c, device=dev)
    levels = _levels(parent, live)

    upper = live & (parent < 0)
    owner = torch.full((c,), -1, dtype=torch.long, device=dev)
    for rows in levels:
        par = parent[rows].clamp(min=0)
        has = parent[rows] >= 0
        upper[rows] = upper[rows] | (has & upper[par] & big[par])
        below = has & ~upper[rows]
        owner[rows] = torch.where(below, owner[par], owner[rows])
        cut = upper[rows] & ~big[rows]
        owner[rows] = torch.where(cut, rows, owner[rows])
    owned = owner >= 0
    size = torch.bincount(owner[owned], minlength=c)
    root = owned & (owner == idx) & ~leaf & (size >= post["min_spt_size"])
    member = owned & root[owner.clamp(min=0)]

    surface = (scale[:, 0] * scale[:, 1] + scale[:, 0] * scale[:, 2]
               + scale[:, 1] * scale[:, 2])
    gran = torch.sqrt(torch.clamp_min(surface, 0.0)) \
        / post["spt_target_granularity"]
    gran = torch.where(leaf, torch.full_like(gran, LEAF_DISTANCE), gran)
    d = pos - pos[owner.clamp(min=0)]
    to_root = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                         + d[:, 2] * d[:, 2])
    e_min = torch.zeros_like(gran)
    e_max = torch.zeros_like(gran)
    for rows in levels:
        par = parent[rows].clamp(min=0)
        here = torch.minimum(gran[rows] + to_root[rows], e_min[par])
        e_min[rows] = torch.where(root[rows], gran[rows], here)
        e_max[rows] = torch.where(root[rows],
                                  torch.full_like(here, FAR), e_min[par])
    reach = to_root + 3.0 * torch.max(scale, dim=1).values
    sphere = torch.zeros_like(reach).scatter_reduce(
        0, owner[member], reach[member], "amax", include_self=False)
    bound = torch.where(root, torch.maximum(sphere, reach),
                        3.0 * torch.max(scale, dim=1).values)
    return dict(pos=pos, plain=live & leaf & ~member, member=member,
                owner=owner, e_min=e_min, e_max=e_max, bound=bound)


def frustum_planes(full_proj):
    """The four side planes of a row-vector view-projection matrix (left,
    right, bottom, top: the 4th column plus and minus the 1st and 2nd),
    each normalised; a point p is inside when a.p + d >= 0."""
    m = full_proj.T
    planes = torch.stack([m[3] + m[0], m[3] - m[0], m[3] + m[1],
                          m[3] - m[1]])
    n = torch.linalg.vector_norm(planes[:, :3], dim=-1, keepdim=True)
    return planes / torch.clamp_min(n, 1e-12)


def working_set(spt: dict, cam: ref.Camera, post: dict, retries: int = 3):
    """The view's working set [C] bool under the budget fallback."""
    pos = spt["pos"]
    planes = frustum_planes(cam.full_proj.to(pos.dtype))
    with ref.exact_matmuls():
        side = pos @ planes[:, :3].T + planes[None, :, 3]
    seen = torch.all(side >= -spt["bound"][:, None], dim=-1)
    d = pos - cam.campos.to(pos.dtype)
    dist = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                      + d[:, 2] * d[:, 2])
    owner = spt["owner"].clamp(min=0)
    ws = None
    for k in range(retries):
        mult = post["distance_multiplier_until_budget"] ** k
        dr = (dist * mult)[owner]
        ws = (spt["plain"] & seen) | (spt["member"] & seen[owner]
                                      & (spt["e_max"] > dr)
                                      & (spt["e_min"] < dr))
        if int(ws.sum()) <= post["max_gaussian_budget"]:
            break
    return ws


# ---- the post step ----------------------------------------------------

def aa_opacity(op, means, scales, quats, cam: ref.Camera):
    """Opacity times sqrt(det(Sigma2) / det(Sigma2 + 0.3 I)), the ratio
    floored at 2.5e-5: Sigma2 the EWA screen covariance as
    reference.project forms it, before its dilation."""
    v = cam.view.to(means.dtype)
    t = means @ v[:3, :3] + v[3, :3]
    tz = t[:, 2]
    tz_s = torch.where(tz > ref.NEAR, tz, torch.ones_like(tz))
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
    cov2 = jac @ (r.T @ ref.covariance(scales, quats) @ r) \
        @ jac.transpose(-1, -2)
    a, b, c = cov2[:, 0, 0], cov2[:, 0, 1], cov2[:, 1, 1]
    det = (a + ref.DILATION) * (c + ref.DILATION) - b * b
    det_s = torch.where(det == 0, torch.ones_like(det), det)
    return op * torch.sqrt(torch.clamp_min((a * c - b * b) / det_s,
                                           AA_FLOOR))


def _drawn(ws, n_skybox):
    rows = ws.clone()
    rows[:n_skybox] = True
    return torch.nonzero(rows).squeeze(1)


def render(p, ws, cam: ref.Camera, degree, tile, n_skybox=0, count=False):
    """The working set (and the skybox) of raw parameters `p` rendered as
    the post step renders it (no gradient)."""
    rows = _drawn(ws, n_skybox)
    with torch.no_grad(), ref.exact_matmuls():
        means, scales, quats, op, shs = ref.activate(
            {k: p[k][rows] for k in ROW_LEAVES})
        op = aa_opacity(op, means, scales, quats, cam)
        scr = ref.project(means, scales, quats, op, cam)
        color = ref.sh_color(shs, means, cam.campos, degree)
        return ref.blend(scr, op, color, cam.width, cam.height, tile,
                         count=count)


def loss_and_grads(p, ws, cam: ref.Camera, gt, degree, tile, post: dict,
                   lambda_dssim, n_skybox=0):
    """One post step's loss and the gradient of every leaf of `p`:
    (loss, {leaf: grad}, rows the projection keeps [C] bool)."""
    rows = _drawn(ws, n_skybox)
    n_ws = max(int(ws.sum()), 1)
    c = p["xyz"].shape[0]
    with ref.exact_matmuls():
        leaves = {k: p[k][rows].detach().requires_grad_(True)
                  for k in ROW_LEAVES}
        means, scales, quats, op, shs = ref.activate(leaves)
        op_aa = aa_opacity(op, means, scales, quats, cam)
        scr = ref.project(means, scales, quats, op_aa, cam)
        color = ref.sh_color(shs, means, cam.campos, degree)
        feats = (scr.xy, scr.conic, op_aa, color)
        leaf = [f.detach().requires_grad_(True) for f in feats]
        lscr = scr._replace(xy=leaf[0], conic=leaf[1])
        with torch.no_grad():
            image = ref.blend(lscr, leaf[2], leaf[3], cam.width, cam.height,
                              tile)
        image.requires_grad_(True)
        photo = ref.photo_loss(image, gt, lambda_dssim)
        (g_img,) = torch.autograd.grad(photo, [image])
        ref.blend(lscr, leaf[2], leaf[3], cam.width, cam.height, tile,
                  grad_image=g_img)
        in_ws = ws[rows].to(op.dtype)
        reg = post["lambda_opacity"] * (op * in_ws).sum() / n_ws
        outs = [(f, l.grad) for f, l in zip(feats, leaf) if l.grad is not None]
        outs.append((reg, torch.ones_like(reg)))
        got = torch.autograd.grad([f for f, _ in outs],
                                  [leaves[k] for k in ROW_LEAVES],
                                  [g for _, g in outs], allow_unused=True)
    grads = {}
    for k, gk in zip(ROW_LEAVES, got):
        full = torch.zeros_like(p[k])
        if gk is not None:
            full[rows] = gk
        if k in GEOMETRY:
            full[:n_skybox] = 0
        grads[k] = full
    grads["exposure"] = torch.zeros_like(p["exposure"])
    visible = torch.zeros(c, dtype=torch.bool, device=rows.device)
    visible[rows] = scr.valid
    return (photo + reg).detach(), grads, visible


def learning_rates(opt: dict, step: int, extent: float, mult: float) -> dict:
    """reference.learning_rates, each but the exposure's times `mult`."""
    lrs = ref.learning_rates(opt, step, extent)
    return {k: v if k == "exposure" else v * mult for k, v in lrs.items()}


def post_steps(p0, views, ws, degree, tile, opt, post, extent, n_steps,
               b1=0.9, n_skybox=0):
    """`n_steps` post steps from raw parameters p0 over views [(Camera,
    target)] with their working sets `ws`: ([loss], the first step's
    gradient as its first moment gives it, the parameters after the last
    step)."""
    p = dict(p0)
    m = {k: torch.zeros_like(p[k]) for k in ref.LEAVES}
    v = {k: torch.zeros_like(p[k]) for k in ref.LEAVES}
    losses, first = [], None
    for i in range(n_steps):
        cam, gt = views[i]
        loss, grads, visible = loss_and_grads(
            p, ws[i], cam, gt, degree, tile, post, opt["lambda_dssim"],
            n_skybox)
        losses.append(float(loss))
        lrs = learning_rates(opt, i, extent, post["lr_multiplier"])
        p, m, v = ref.adam_step(p, grads, m, v, i + 1, lrs, visible, b1=b1)
        if first is None:
            first = {k: m[k] / (1.0 - b1) for k in ref.LEAVES}
    return losses, first, p
