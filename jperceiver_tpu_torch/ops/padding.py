"""Reflection padding (counterpart of `jperceiver_tpu/ops/padding.py`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def reflect_pad(x: torch.Tensor, p: int = 1) -> torch.Tensor:
    """NCHW reflection pad (torch ReflectionPad2d semantics, the edge is not
    repeated): pad row -1 mirrors row 1, pad row H mirrors row H-2.

    The forward is `F.pad(mode="reflect")`; the backward folds the pad
    strips back by slices and adds in a fixed order (`_ReflectPad`), where
    CUDA's reflection-pad backward adds atomically, in an order that
    changes from run to run at the pixels that take several cotangents."""
    return _ReflectPad.apply(x, p)


class _ReflectPad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, p):
        ctx.p = p
        return F.pad(x, (p, p, p, p), mode="reflect")

    @staticmethod
    def backward(ctx, g):
        p = ctx.p
        h, w = g.shape[-2] - 2 * p, g.shape[-1] - 2 * p

        def fold_cols(t):  # (..., r, w + 2p) -> (..., r, w): the side strips added in
            out = t[..., p:p + w].clone()
            out[..., 1:p + 1] += t[..., :p].flip(-1)
            out[..., w - 1 - p:w - 1] += t[..., p + w:].flip(-1)
            return out

        gi = fold_cols(g[..., p:p + h, :])
        gi[..., 1:p + 1, :] += fold_cols(g[..., :p, :]).flip(-2)
        gi[..., h - 1 - p:h - 1, :] += fold_cols(g[..., p + h:, :]).flip(-2)
        return gi, None
