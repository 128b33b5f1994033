"""The plain reference of the training objective: BEV layout losses (soft
IoU, boundary, weighted cross-entropy), the CGT scale label and scale
loss, the monodepth2 photometric loss with automasking, and edge-aware
smoothness, in fp32, summed as the training step sums them (the layout
terms twice). Written from the objective's definition; imports nothing of
the code under test."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .model import resize_bilinear


def _onehot(labels, n):
    return F.one_hot(labels.long(), n).permute(0, 3, 1, 2).float()


def seg_loss(logits, labels, class_weight, sdf, loss_weight, loss2_weight):
    """loss_sum 3: soft IoU * w + boundary * w2 + weighted cross-entropy."""
    probs = logits.softmax(1)
    onehot = _onehot(labels, logits.shape[1])
    tp = (probs * onehot).sum((2, 3))
    fp = (probs * (1 - onehot)).sum((2, 3))
    fn = ((1 - probs) * onehot).sum((2, 3))
    iou = -((tp + 1.0) / (tp + fp + fn + 1.0)).mean()
    boundary = (probs[:, 1:] * sdf).mean()
    ce = F.cross_entropy(logits, labels.long(), weight=class_weight)
    return iou * loss_weight + boundary * loss2_weight + ce


def cgt_label(bev_layout, K3, Tr, kind, split, occ, out_hw):
    """The metric-scale depth label in the front view (B, 1, H, W): the
    BEV depth ramp (and layout), turned by 270 degrees, warped through the
    ground-plane homography; for the static kind also binarised and masked
    by the assumption quad (x in [18, 22] m, y in [31, 33] m)."""
    b, dev = K3.shape[0], K3.device
    h, w = out_hw
    cam_h, offset = (0.33, 1.9) if split == "argo" else (1.73, 0.0 if kind == "dynamic" else 0.27)
    rows = torch.arange(occ, dtype=torch.float32, device=dev)
    ramp = ((occ - rows) * (40.0 / occ) - offset)[None, None, :, None].expand(b, 1, occ, occ)

    def turn(x):  # out[r, c] = x[S-1-c, r]
        return x.transpose(2, 3).flip(3)

    ego_T_ground = torch.eye(4, device=dev).repeat(b, 1, 1)
    ego_T_ground[:, 2, 3] = -cam_h
    cam_T_ground = Tr.float() @ ego_T_ground
    img_H_ground = K3.float() @ cam_T_ground[:, :3][:, :, [0, 1, 3]]
    r = occ / 40.0
    shift = torch.tensor([[r, 0, 0], [0, r, float(occ // 2)], [0, 0, 1]], device=dev)
    bev_H_img = shift @ torch.linalg.inv(img_H_ground)
    # dst(p) = src(bev_H_img p): the warp's source pixel of each front pixel.
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)]).reshape(1, 3, h * w)
    q = bev_H_img @ pix
    q = q[:, :2] / (q[:, 2:3] + 1e-8)
    grid = torch.stack([q[:, 0] * (2.0 / (occ - 1)) - 1, q[:, 1] * (2.0 / (occ - 1)) - 1],
                       -1).reshape(b, h, w, 2)

    def warp(x):
        return F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros", align_corners=True)

    dist = warp(turn(ramp))
    if kind == "both":
        return dist * warp(turn(bev_layout[:, None].float()))
    # Static: the road binarised, inside the assumption quad (batch element 0).
    road = (warp(turn(bev_layout[:, None].float())) >= 1.0 - 1e-6).float()
    p = [(round(18 * r), round(31 * r)), (round(22 * r), round(31 * r)),
         (round(18 * r), round(33 * r)), (round(22 * r), round(33 * r))]
    quad = [[occ - p[3][1] - 1, p[0][0] - 1], [occ - p[3][1] - 1, p[1][0] - 1],
            [occ - p[3][1] + (p[2][1] - p[1][1]) - 1, p[1][0] - 1],
            [occ - p[3][1] + (p[2][1] - p[1][1]) - 1, p[0][0] - 1]]
    pts = torch.tensor([[x, y, 1.0] for x, y in quad], device=dev).T
    img = torch.linalg.inv(bev_H_img[0]) @ pts
    img = torch.round(img[:2] / (img[2:] + 1e-8))
    crosses = []
    for i in range(4):
        (x1, y1), (x2, y2) = img[:, i], img[:, (i + 1) % 4]
        crosses.append((x2 - x1) * (ys - y1) - (y2 - y1) * (xs - x1))
    c = torch.stack(crosses)
    inside = ((c >= 0).all(0) | (c <= 0).all(0)).float()
    return dist * road * inside


def ssim(x, y):
    """Per-pixel (1 - SSIM) / 2 clipped to [0, 1]; 3x3 means, reflection pad."""
    def pool(t):
        return F.avg_pool2d(t, 3, 1)

    shape = x.shape
    x = F.pad(x.reshape(-1, *shape[-3:]), (1, 1, 1, 1), mode="reflect")
    y = F.pad(y.reshape(-1, *shape[-3:]), (1, 1, 1, 1), mode="reflect")
    mx, my = pool(x), pool(y)
    sx = pool(x * x) - mx * mx
    sy = pool(y * y) - my * my
    sxy = pool(x * y) - mx * my
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    num = (2 * mx * my + c1) * (2 * sxy + c2)
    den = (mx * mx + my * my + c1) * (sx + sy + c2)
    return ((1 - num / den) / 2).clamp(0, 1).reshape(shape)


def reprojection_loss(pred, target):
    """0.85 SSIM + 0.15 Charbonnier L1 (eps 1e-3), channel mean: (..., H, W)."""
    l1 = torch.sqrt((target - pred) ** 2 + 1e-6).mean(-3)
    return 0.85 * ssim(pred, target.expand_as(pred)).mean(-3) + 0.15 * l1


def smoothness(disp, img):
    """First- and second-order edge-aware smoothness, image area-pooled to
    the disparity's size."""
    f = img.shape[2] // disp.shape[2]
    if f > 1:
        img = F.avg_pool2d(img, f)

    def grad(d):
        return d[:, :, :, 1:] - d[:, :, :, :-1], d[:, :, 1:, :] - d[:, :, :-1, :]

    def term(dd, di):
        return (dd.abs() * torch.exp(-0.5 * di.abs().mean(1, keepdim=True))).mean()

    dx, dy = grad(disp)
    ix, iy = grad(img)
    (dxx, dxy), (dyx, dyy) = grad(dx), grad(dy)
    (ixx, ixy), (iyx, iyy) = grad(ix), grad(iy)
    return (term(dx, ix) + term(dy, iy) + term(dxx, ixx) + term(dxy, ixy)
            + term(dyx, iyx) + term(dyy, iyy))


def warp_grid(disp, inv_K, K, T, h, w, min_depth, max_depth):
    """Monodepth2 synthesis grid (B, H, W, 2), align-corners convention."""
    disp = resize_bilinear(disp, h, w)
    depth = 1.0 / (1.0 / max_depth + (1.0 / min_depth - 1.0 / max_depth) * disp)
    b = depth.shape[0]
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=disp.device),
                            torch.arange(w, dtype=torch.float32, device=disp.device),
                            indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)]).reshape(1, 3, h * w)
    cam = depth.reshape(b, 1, h * w) * (inv_K[:, :3, :3] @ pix)
    cam = torch.cat([cam, torch.ones_like(cam[:, :1])], 1)
    p = ((K @ T)[:, :3] @ cam)
    xy = (p[:, :2] / (p[:, 2:3] + 1e-7)).reshape(b, 2, h, w).permute(0, 2, 3, 1)
    return (xy / torch.tensor([w - 1, h - 1], dtype=xy.dtype, device=xy.device) - 0.5) * 2


def losses(out, batch, cfg, generator):
    """The loss dict of one training step. The automask noise, 1e-5 N(0, 1)
    of shape (scales, frames - 1, B, H, W), is drawn from `generator`."""
    m = cfg
    t = m["type"]
    scales, fids = list(m["scales"]), list(m["frame_ids"])
    h, w = m["height"], m["width"]
    lo, hi = m["min_depth"], m["max_depth"]
    loss = {}
    branches = []
    if t in ("static", "Argo_both"):
        branches.append(("", "static", m["static_weight"], m["loss_weightS"], m["loss2_weightS"]))
    if t == "Argo_both":
        branches.append(("B", "dynamic", m["dynamic_weight"], m["loss_weight"], m["loss2_weight"]))
    for sfx, kind, cw, lw, l2w in branches:
        weight = torch.tensor([1.0, cw], device=batch["color"].device)
        labels, sdf = batch[f"bev_{kind}"], batch[f"bev_{kind}_sdf"]
        for key in ("topview", "transform_topview"):
            loss[f"{key}_loss{sfx}"] = seg_loss(out[f"{key}{sfx}"], labels, weight, sdf, lw, l2w)
        loss[f"transform_loss{sfx}"] = (out[f"features{sfx}"]
                                        - out[f"retransform_features{sfx}"]).abs().mean()
        loss[f"layout_loss{sfx}"] = (loss[f"topview_loss{sfx}"]
                                     + 0.001 * loss[f"transform_loss{sfx}"]
                                     + loss[f"transform_topview_loss{sfx}"])
    kind = {"static": "static", "Argo_both": "both"}[t]
    label = cgt_label(batch["bev_static" if kind == "static" else "bev_both"],
                      batch["odometry_K"][:, :3, :3], batch["Tr_cam2_velo"], kind, m["split"],
                      m["occ_map_size"], tuple(m["cgt_label_hw"]))
    target = batch["color"][:, 0]
    n_s, n_f, b = len(scales), len(fids) - 1, target.shape[0]
    ident = torch.stack([reprojection_loss(batch["color"][:, i], target)
                         for i in range(1, n_f + 1)]).detach()
    noise = torch.randn((n_s, n_f, b, h, w), generator=generator, device=target.device) * 1e-5
    for si, s in enumerate(scales):
        disp = out[f"disp/{s}"]
        warped = torch.stack([
            F.grid_sample(batch["color"][:, i],
                          warp_grid(disp, batch["inv_K"], batch["K"], out[f"cam_T_cam/{f}"],
                                    h, w, lo, hi),
                          mode="bilinear", padding_mode="border", align_corners=True)
            for i, f in enumerate(fids[1:], start=1)])
        per_frame = torch.cat([ident + noise[si], reprojection_loss(warped, target)], 0)
        loss[f"min_reconstruct_loss/{s}"] = per_frame.amin(0).mean() / n_s
        depth = 1.0 / (1.0 / hi + (1.0 / lo - 1.0 / hi) * disp)
        d = resize_bilinear(depth, *label.shape[2:]).clamp(1e-3, 80.0)
        mask = (label > 0).float()
        abs_rel = ((label - d).abs() / label.clamp_min(1e-6) * mask).sum() / mask.sum().clamp_min(1)
        loss[f"scale_loss/{s}"] = m["scale_weight"] * abs_rel / 2 ** s / n_s
        dn = disp / (disp.mean((2, 3), keepdim=True) + 1e-7)
        loss[f"smooth_loss/{s}"] = m["smoothness_weight"] * smoothness(dn, target) / 2 ** s / n_s
    return loss
