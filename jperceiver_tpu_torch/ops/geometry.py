"""Camera and rigid-body geometry (counterpart of
`jperceiver_tpu/ops/geometry.py`).

The JAX package pins these small matmuls to `precision=HIGHEST`. Here the
products are written as sums of products in fp32 (float64 for float64
operands), so no TF32 or reduced-precision matmul can reach them whatever
the global flags say; results come back in the input dtype. Depth maps are
(B, 1, H, W).
"""

from __future__ import annotations

import torch

from .._device import device_constant


def at_least_f32(t: torch.Tensor) -> torch.Tensor:
    """t in fp32, or in float64 when it is float64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b summed in at least fp32, returned in a's dtype."""
    a32, b32 = at_least_f32(a), at_least_f32(b)
    dt = torch.promote_types(a32.dtype, b32.dtype)
    prod = a32.to(dt)[..., :, :, None] * b32.to(dt)[..., None, :, :]
    return prod.sum(-2).to(a.dtype)


def bmv(a: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Batched (B, I, J) @ (B or 1, J, N), summed over j in order in at
    least fp32, returned in that dtype."""
    dt = torch.promote_types(at_least_f32(a).dtype, pts.dtype)
    a, pts = a.to(dt), pts.to(dt)
    out = a[:, :, 0, None] * pts[:, None, 0]
    for j in range(1, a.shape[2]):
        out = out + a[:, :, j, None] * pts[:, None, j]
    return out


def disp_to_depth(disp: torch.Tensor, min_depth: float, max_depth: float):
    """Sigmoid disparity -> (scaled_disp, depth):
    depth = 1 / (1/max + (1/min - 1/max) * disp)."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    return scaled_disp, 1.0 / scaled_disp


def rot_from_axisangle(vec: torch.Tensor) -> torch.Tensor:
    """Axis-angle (B, 3) -> rotation matrix (B, 4, 4) (Rodrigues)."""
    angle = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
    axis = vec / (angle + 1e-7)
    ca = torch.cos(angle)[..., 0]
    sa = torch.sin(angle)[..., 0]
    c1 = 1.0 - ca
    x, y, z = axis.unbind(-1)
    xs, ys, zs = x * sa, y * sa, z * sa
    xc, yc, zc = x * c1, y * c1, z * c1
    xyc, yzc, zxc = x * yc, y * zc, z * xc
    rot = torch.stack(
        [
            x * xc + ca, xyc - zs, zxc + ys,
            xyc + zs, y * yc + ca, yzc - xs,
            zxc - ys, yzc + xs, z * zc + ca,
        ],
        dim=-1,
    ).reshape(vec.shape[0], 3, 3)
    out = torch.zeros((vec.shape[0], 4, 4), dtype=vec.dtype, device=vec.device)
    out[:, :3, :3] = rot
    out[:, 3, 3].fill_(1.0)
    return out


def _translation_matrix(t: torch.Tensor) -> torch.Tensor:
    """(B, 3) -> homogeneous (B, 4, 4) translation."""
    out = torch.eye(4, dtype=t.dtype, device=t.device).repeat(t.shape[0], 1, 1)
    out[:, :3, 3] = t
    return out


def transformation_from_parameters(axisangle: torch.Tensor,
                                   translation: torch.Tensor,
                                   invert: bool = False) -> torch.Tensor:
    """(axis-angle, translation) -> SE3 (B, 4, 4): T @ R, or R^T @ T(-t)
    when inverted."""
    r = rot_from_axisangle(axisangle)
    t = translation
    if invert:
        r = r.transpose(1, 2)
        t = -t
    tm = _translation_matrix(t)
    return _matmul(r, tm) if invert else _matmul(tm, r)


def se3_matrix(rotation: torch.Tensor, translation: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3) rotation + (B, 3) translation -> (B, 4, 4) homogeneous."""
    out = torch.eye(4, dtype=rotation.dtype, device=rotation.device)
    out = out.repeat(rotation.shape[0], 1, 1)
    out[:, :3, :3] = rotation
    out[:, :3, 3] = translation
    return out


def se3_inverse(mat: torch.Tensor) -> torch.Tensor:
    """Inverse of batched rigid transforms (B, 4, 4) without a solve."""
    r = mat[:, :3, :3].transpose(1, 2)
    t = -_matmul(r, mat[:, :3, 3:])[..., 0]
    return se3_matrix(r, t)


def se3_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for batched (B, 4, 4) rigid transforms, summed in fp32, in
    a's dtype."""
    return _matmul(a, b)


def ground_homography(camera_T_ground: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Homography image <- ground plane, K @ [r1 | r2 | t]: (B, 4, 4) and
    (B, 3, 3) -> (B, 3, 3)."""
    cols = torch.stack([camera_T_ground[:, :3, 0], camera_T_ground[:, :3, 1],
                        camera_T_ground[:, :3, 3]], -1)
    return _matmul(K, cols)


def _pixel_grid(height: int, width: int, device) -> torch.Tensor:
    """Homogeneous pixel grid (1, 3, H*W) fp32 with (x, y, 1) rows."""
    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=device),
                            torch.arange(width, dtype=torch.float32, device=device),
                            indexing="ij")
    return torch.stack([xs, ys, torch.ones_like(xs)]).reshape(1, 3, height * width)


def backproject(depth: torch.Tensor, inv_K: torch.Tensor) -> torch.Tensor:
    """Depth (B, 1, H, W) and inverse intrinsics (B, 4, 4) -> homogeneous
    camera points (B, 4, H*W), fp32 (float64 for float64 operands)."""
    b, _, h, w = depth.shape
    rays = bmv(inv_K[:, :3, :3], _pixel_grid(h, w, depth.device))
    pts = at_least_f32(depth).reshape(b, 1, h * w) * rays
    return torch.cat([pts, torch.ones_like(pts[:, :1])], 1)


def project(points: torch.Tensor, K: torch.Tensor, T: torch.Tensor,
            height: int, width: int, eps: float = 1e-7) -> torch.Tensor:
    """Camera points (B, 4, H*W) through pose T (B, 4, 4) and intrinsics K
    (B, 4, 4) -> sampling grid (B, H, W, 2) in [-1, 1], (x, y),
    align-corners convention, fp32 (float64 for float64 operands)."""
    b = points.shape[0]
    P = _matmul(at_least_f32(K), at_least_f32(T))[:, :3, :]
    cam = bmv(P, points)
    xy = cam[:, :2] / (cam[:, 2:3] + eps)
    xy = xy.reshape(b, 2, height, width).permute(0, 2, 3, 1)
    scale = device_constant([width - 1, height - 1], xy.dtype, xy.device)
    return (xy / scale - 0.5) * 2.0
