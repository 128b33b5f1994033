"""Resizes and bilinear sampling (counterpart of the matching functions of
`jperceiver_tpu/ops/sampling.py`). Images are NCHW; sampling grids are
(B, Ho, Wo, 2) with (x, y) in [-1, 1], as `F.grid_sample` takes them.

`grid_sample` samples fp32 taps: the JAX package's bf16 and uint8 taps and
its packed-patch gather are TPU lowerings of the same function.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize, half-pixel centres, antialiased when it downsamples.

    `jax.image.resize` widens its triangle kernel by the downsampling
    factor; `antialias=True` is the same filter. Without it the 1024^2 ->
    192x640 pose resize differs from the JAX package by up to 0.47.

    The forward is `F.interpolate`; the backward is the resize's transpose
    as two products with its interpolation matrices (`_ResizeBilinear`),
    where CUDA's interpolate backward adds atomically, in an order that
    changes from run to run.
    """
    return _ResizeBilinear.apply(img, out_h, out_w)


def _interpolate(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    return F.interpolate(img, size=(out_h, out_w), mode="bilinear",
                         align_corners=False, antialias=True)


_RESIZE_MATRICES: dict = {}


def _resize_matrix(n_in: int, n_out: int, like: torch.Tensor) -> torch.Tensor:
    """The (n_in, n_out) weights of the 1-D resize n_in -> n_out, entry
    (k, j) the weight of input k in output j, as the forward computes them:
    the resize of the identity along one axis (the other axis kept, whose
    weights are 1 and 0). Cached by size, dtype and device."""
    key = (n_in, n_out, like.dtype, like.device)
    m = _RESIZE_MATRICES.get(key)
    if m is None:
        eye = torch.eye(n_in, dtype=like.dtype, device=like.device)[None, None]
        m = _RESIZE_MATRICES[key] = _interpolate(eye, n_in, n_out)[0, 0]
    return m


class _ResizeBilinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, out_h, out_w):
        ctx.in_hw = img.shape[-2:]
        return _interpolate(img, out_h, out_w)

    @staticmethod
    def backward(ctx, g):
        (h, w), (oh, ow) = ctx.in_hw, g.shape[-2:]
        gi = g
        if (oh, ow) != (h, w):
            # out = Wh^T x Ww, so d/dx = Wh g Ww^T.
            gi = _resize_matrix(h, oh, g) @ g @ _resize_matrix(w, ow, g).T
        return gi, None, None


def upsample2x_nearest(img: torch.Tensor) -> torch.Tensor:
    """x2 nearest-neighbour upsample."""
    return F.interpolate(img, scale_factor=2, mode="nearest")


def grid_sample(img: torch.Tensor, grid: torch.Tensor,
                padding_mode: str = "border") -> torch.Tensor:
    """Bilinear sampling of img (B, C, H, W) at grid (B, Ho, Wo, 2), with
    the align-corners convention of the reference's `Project`; padding
    "border" or "zeros". Taps and result in the image's dtype, at least
    fp32: (B, C, Ho, Wo)."""
    if padding_mode not in ("border", "zeros"):
        raise ValueError(f"unsupported padding_mode: {padding_mode}")
    dt = torch.promote_types(img.dtype, torch.float32)
    return F.grid_sample(img.to(dt), grid.to(dt), mode="bilinear",
                         padding_mode=padding_mode, align_corners=True)


def grid_sample_multi(img: torch.Tensor, grids: torch.Tensor,
                      padding_mode: str = "border") -> torch.Tensor:
    """One image (B, C, H, W) sampled at S grids (B, S, Ho, Wo, 2) ->
    (B, S, C, Ho, Wo), as one `grid_sample` over the stacked grids."""
    b, s, ho, wo, _ = grids.shape
    out = grid_sample(img, grids.reshape(b, s * ho, wo, 2), padding_mode)
    return out.reshape(b, img.shape[1], s, ho, wo).transpose(1, 2)


def warp_perspective(src: torch.Tensor, M: torch.Tensor, dsize: tuple[int, int],
                     padding_mode: str = "zeros") -> torch.Tensor:
    """Perspective warp dst(p) = src(M^-1 p) in pixel coordinates, the
    `torchgeometry.warp_perspective` semantics of the CGT label: src
    (B, C, H, W), M (B, 3, 3), dsize (out_h, out_w) -> (B, C, out_h, out_w)."""
    from .geometry import bmv

    out_h, out_w = dsize
    b, _, h, w = src.shape
    m_inv = torch.linalg.inv_ex(M.float()).inverse  # no status check on the host
    ys, xs = torch.meshgrid(torch.arange(out_h, dtype=torch.float32, device=src.device),
                            torch.arange(out_w, dtype=torch.float32, device=src.device),
                            indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)]).reshape(1, 3, out_h * out_w)
    q = bmv(m_inv, pix)
    q = q[:, :2] / (q[:, 2:3] + 1e-8)
    gx = q[:, 0] * (2.0 / max(w - 1, 1)) - 1.0
    gy = q[:, 1] * (2.0 / max(h - 1, 1)) - 1.0
    grid = torch.stack([gx, gy], -1).reshape(b, out_h, out_w, 2)
    return grid_sample(src, grid, padding_mode)


def resize_area(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Area (average-pool) downsample by integer factors, as
    `F.interpolate(mode="area")` does at the ratios the smoothness loss
    uses."""
    h, w = img.shape[2], img.shape[3]
    if (h, w) == (out_h, out_w):
        return img
    fh, fw = h // out_h, w // out_w
    if fh * out_h != h or fw * out_w != w:
        raise ValueError(f"resize_area needs integer factors, got {h}x{w} -> "
                         f"{out_h}x{out_w}")
    return F.avg_pool2d(img, (fh, fw))
