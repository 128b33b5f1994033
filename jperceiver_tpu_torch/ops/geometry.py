"""Rigid-body geometry of the inference path (counterpart of
`jperceiver_tpu/ops/geometry.py:43-108`).

The JAX package pins these small matmuls to `precision=HIGHEST`. Here the
4x4 products are written as fp32 sums of products, so no TF32 or
reduced-precision matmul can reach them whatever the global flags say;
results come back in the input dtype.
"""

from __future__ import annotations

import torch


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b summed in fp32, returned in a's dtype."""
    prod = a.float()[..., :, :, None] * b.float()[..., None, :, :]
    return prod.sum(-2).to(a.dtype)


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
    out[:, 3, 3] = 1.0
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
