"""CGT (cross-view geometric transformation) scale-label synthesis
(counterpart of `jperceiver_tpu/losses/cgt.py`): the BEV distance ramp and
layout, warped into the front view through the ground-plane homography,
masked by the assumption-region quad. Array math only: the rotate-270 BEV
permutation, fp32 3x3 products, `warp_perspective`, an analytic
point-in-convex-quad test.

Dataset conventions of the reference, kept: a 40 m x 40 m BEV window;
camera height 1.73 m (KITTI) or 0.33 m (Argoverse); depth-ramp offset
-0.27 for KITTI static/both, -1.9 for Argoverse, 0 for KITTI dynamic; the
assumption region x in [18, 22] m, y in [31, 33] m.
"""

from __future__ import annotations

import torch

from .._device import device_constant
from ..ops.geometry import bmv, ground_homography, se3_matrix
from ..ops.sampling import warp_perspective


def _bev_to_warp_frame(x: torch.Tensor) -> torch.Tensor:
    """rotate-270 of the spatial dims of (B, C, S, S): out[r, c] = x[S-1-c, r]
    (the reference's fliplr acts on its size-1 channel dim, a no-op)."""
    return x.transpose(2, 3).flip(3)


def _distance_ramp(batch: int, size: int, offset: float, device) -> torch.Tensor:
    """Row r (from the top) carries depth (S - r) * 40/S - offset."""
    rows = torch.arange(size, dtype=torch.float32, device=device)
    ramp = (size - rows) * (40.0 / size) - offset
    return ramp[None, None, :, None].expand(batch, 1, size, size)


def assumption_quad_points(occ_map_size: int):
    """The four assumption-region corners in rotated-BEV pixels, in the
    polygon order the reference fills: p0, p2, p3, p1."""
    r = occ_map_size / 40.0
    pts = [(round(18 * r), round(31 * r)), (round(22 * r), round(31 * r)),
           (round(18 * r), round(33 * r)), (round(22 * r), round(33 * r))]
    s = occ_map_size
    rot = [
        [s - pts[3][1] - 1, pts[0][0] - 1],
        [s - pts[3][1] + (pts[2][1] - pts[1][1]) - 1, pts[0][0] - 1],
        [s - pts[3][1] - 1, pts[1][0] - 1],
        [s - pts[3][1] + (pts[2][1] - pts[1][1]) - 1, pts[1][0] - 1],
    ]
    return [rot[0], rot[2], rot[3], rot[1]]


def _quad_mask(verts: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Inclusive point-in-convex-quad fill; verts (4, 2) (x, y) in polygon
    order -> (H, W) float {0, 1}."""
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=verts.device),
        torch.arange(width, dtype=torch.float32, device=verts.device), indexing="ij")
    crosses = []
    for i in range(4):
        x1, y1 = verts[i, 0], verts[i, 1]
        x2, y2 = verts[(i + 1) % 4, 0], verts[(i + 1) % 4, 1]
        crosses.append((x2 - x1) * (ys - y1) - (y2 - y1) * (xs - x1))
    c = torch.stack(crosses)
    inside = (c >= 0).all(0) | (c <= 0).all(0)
    return inside.float()


def _shifted_ground_from_img(K3, Tr_cam2_velo, camera_height: float,
                             occ_map_size: int) -> torch.Tensor:
    """Homography front-image pixel -> rotated-BEV pixel, (B, 3, 3) fp32."""
    b = K3.shape[0]
    dev = K3.device
    ego_T_ground = se3_matrix(
        torch.eye(3, device=dev).expand(b, 3, 3),
        device_constant([0.0, 0.0, -camera_height], torch.float32, dev).expand(b, 3))
    cam_T_ground = bmv(Tr_cam2_velo, ego_T_ground)
    ground_H_img = torch.linalg.inv_ex(ground_homography(cam_T_ground, K3.float())).inverse
    rescale = occ_map_size / 40.0
    shift = device_constant([[rescale, 0.0, 0.0], [0.0, rescale, float(occ_map_size // 2)],
                             [0.0, 0.0, 1.0]], torch.float32, dev)
    return bmv(shift.expand(b, 3, 3), ground_H_img)


def _front_quad_mask(H_sg_img: torch.Tensor, occ_map_size: int, h: int,
                     w: int) -> torch.Tensor:
    """The assumption quad projected into the front view -> (B, H, W); from
    batch element 0, as the reference rasterizes it."""
    pts = device_constant(assumption_quad_points(occ_map_size), torch.float32, H_sg_img.device)
    homo = torch.cat([pts, torch.ones_like(pts[:, :1])], 1)  # (4, 3)
    q = bmv(torch.linalg.inv_ex(H_sg_img[:1]).inverse, homo.T[None])[0].T  # (4, 3)
    img_pts = torch.round(q[:, :2] / (q[:, 2:3] + 1e-8))
    return _quad_mask(img_pts, h, w).expand(H_sg_img.shape[0], h, w)


def cgt_scale_label(bev_layout: torch.Tensor | None, K3: torch.Tensor,
                    Tr_cam2_velo: torch.Tensor, *, kind: str, split: str,
                    occ_map_size: int, out_hw: tuple[int, int]) -> torch.Tensor:
    """The metric-scale depth label in the front view, (B, 1, H, W) fp32,
    0 where unsupervised.

    bev_layout: (B, S, S) binary road/both mask (None for kind "dynamic");
    K3 (B, 3, 3) odometry intrinsics; Tr_cam2_velo (B, 4, 4); kind
    "static" | "dynamic" | "both"; split "argo" | "odometry" | "raw";
    out_hw the full-resolution front view the label is drawn at.
    """
    if kind not in ("static", "dynamic", "both"):
        raise ValueError(kind)
    b = K3.shape[0]
    s = occ_map_size
    h, w = out_hw
    if split == "argo":
        camera_height, offset = 0.33, 1.9
    else:
        camera_height = 1.73
        offset = 0.0 if kind == "dynamic" else 0.27

    ramp = _bev_to_warp_frame(_distance_ramp(b, s, offset, K3.device))
    H_sg_img = _shifted_ground_from_img(K3, Tr_cam2_velo, camera_height, s)
    # The reference passes inv(H) to the warper. `inv_ex` is `inv` without
    # the check of its status on the host, which waits for the device.
    M = torch.linalg.inv_ex(H_sg_img).inverse
    dist_front = warp_perspective(ramp, M, (h, w), padding_mode="zeros")
    if kind == "dynamic":
        return dist_front * _front_quad_mask(H_sg_img, s, h, w)[:, None]
    if bev_layout is None:
        raise ValueError(f"cgt_scale_label: kind {kind} needs a bev_layout")
    layout = _bev_to_warp_frame(bev_layout[:, None].float())
    layout_front = warp_perspective(layout, M, (h, w), padding_mode="zeros")
    if kind == "both":
        return dist_front * layout_front
    layout_bin = (layout_front >= 1.0 - 1e-6).float()
    return dist_front * layout_bin * _front_quad_mask(H_sg_img, s, h, w)[:, None]
