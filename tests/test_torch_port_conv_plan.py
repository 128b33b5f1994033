"""The bf16 K3/K4 tile plans replayed on the CPU.

On the card the bf16 kernels read every operand as TMA boxes: for K3, per
output tile and (tap, 64-channel chunk), one box of the activation and one
of the weight; for K4, per pixel tile of a split, one box of the activation
for each (tap, chunk) item and the cotangent's boxes. `k3_plan` and
`k4_plan` say which boxes, and the kernels compute the same coordinates
from their block index. Here each box is cut out of the tensor with plain
slicing, zero-filled outside it as TMA fills it, multiplied and summed in
the kernels' order of tiles, splits and channel padding. The result must be
`conv3x3_plain` / `conv3x3_wgrad_plain`: an index error in a plan shows up
here before any card runs it.

Shapes: the nine K3 site shapes of the 1024^2 step (channels as they are,
extents / 8), each as the forward and as the data-grad (pad 2 - pad, the
channels swapped), and small shapes whose extents leave tail tiles, at pads
0, 1 and 2, with B = 2.
"""

import numpy as np
import pytest
import torch

from jperceiver_tpu_torch.ops.cuda.conv3x3 import (conv3x3_plain, conv3x3_wgrad_plain,
                                                   k3_plan, k4_plan)

_CHUNK = 64


def _box(t: torch.Tensor, coords, width: int, box_w: int, box_h: int,
         channels: int) -> torch.Tensor:
    """The (box_h * box_w, width) box of t (B, H, W, stored channels) at
    (c0, x0, y0, b), rows x fastest, zero outside t and past `channels`."""
    c0, x0, y0, b = coords
    _, hh, ww, _ = t.shape
    cc = channels
    out = torch.zeros(box_h, box_w, width, dtype=t.dtype)
    ylo, yhi = max(y0, 0), min(y0 + box_h, hh)
    xlo, xhi = max(x0, 0), min(x0 + box_w, ww)
    chi = min(c0 + width, cc)
    if ylo < yhi and xlo < xhi and c0 < chi:
        out[ylo - y0:yhi - y0, xlo - x0:xhi - x0, :chi - c0] = t[b, ylo:yhi, xlo:xhi, c0:chi]
    return out.reshape(box_h * box_w, width)


def _nhwc(t: torch.Tensor, channels: int) -> torch.Tensor:
    """t as a (B, H, W, channels) copy whose channels past t's hold NaN: a
    box that read them would poison the result."""
    th = t.permute(0, 2, 3, 1)
    return torch.nn.functional.pad(th, (0, channels - t.shape[1]), value=float("nan"))


def replay_k3(x, w, bias, pad, plan):
    """K3 computed box by box as `plan` has the kernel read and write it."""
    xs = _nhwc(x, plan.c_store)
    # The weight as the kernel's (C, 9, O) tensor map (innermost first), read
    # in (64, 1, bn) boxes at (c0, tap, n0): here a (1, O, 9, C) tensor.
    wk = _nhwc(w, plan.c_store).reshape(1, plan.o, 9, plan.c_store)
    y = torch.full((plan.b, plan.ho, plan.wo, plan.o_store), float("nan"))
    rows = plan.box_w * plan.box_h
    for t in range(plan.tiles):
        b, oy0, ox0 = plan.tile_origin(t)
        for n in range(plan.n_tiles):
            n0 = n * plan.bn
            acc = torch.zeros(rows, plan.bn)
            for tap in range(9):
                for chunk in range(plan.kchunks):
                    a = _box(xs, plan.box(t, tap, chunk), _CHUNK, plan.box_w, plan.box_h,
                             plan.c)
                    wb = _box(wk, (chunk * _CHUNK, tap, n0, 0), _CHUNK, 1, plan.bn, plan.c)
                    acc += a @ wb.T
            cols = torch.arange(n0, n0 + plan.bn)
            acc += torch.where(cols < plan.o, bias[cols.clamp(max=plan.o - 1)], 0.0)
            for r in range(rows):
                oy, ox = oy0 + r // plan.box_w, ox0 + r % plan.box_w
                ncols = min(plan.bn, plan.o_store - n0)
                if oy < plan.ho and ox < plan.wo and ncols > 0:
                    y[b, oy, ox, n0:n0 + ncols] = acc[r, :ncols]
    return y[..., :plan.o].permute(0, 3, 1, 2)


def replay_k4(x, g, pad, plan):
    """K4 computed box by box: per split, per pair of (tap, chunk) items and
    output-channel tile, the pixel tiles of the split in order; then the
    partials summed over splits in order."""
    xs, gs = _nhwc(x, plan.c_store), _nhwc(g, plan.o_store)
    items = 9 * plan.kchunks
    partial = torch.full((plan.splits, 9, _CHUNK * plan.kchunks, plan.bn * plan.n_tiles),
                         float("nan"))
    for s in range(plan.splits):
        t_range = range(s * plan.tiles_per_split,
                        min(plan.tiles, (s + 1) * plan.tiles_per_split))
        assert len(t_range) > 0  # every split has pixels
        for pair in range(-(-items // 2)):
            for item in range(2 * pair, min(2 * pair + 2, items)):
                tap, chunk = divmod(item, plan.kchunks)
                for n in range(plan.n_tiles):
                    n0 = n * plan.bn
                    acc = torch.zeros(_CHUNK, plan.bn)
                    for t in t_range:
                        b, oy0, ox0 = plan.tile_origin(t)
                        xb = _box(xs, plan.box(t, tap, chunk), _CHUNK, plan.box_w, plan.box_h,
                                  plan.c)
                        gb = torch.cat([_box(gs, (n0 + j, ox0, oy0, b), _CHUNK, plan.box_w,
                                             plan.box_h, plan.o)
                                        for j in range(0, plan.bn, _CHUNK)], 1)
                        acc += xb.T @ gb
                    partial[s, tap, chunk * _CHUNK:(chunk + 1) * _CHUNK, n0:n0 + plan.bn] = acc
    total = partial[0]
    for s in range(1, plan.splits):
        total = total + partial[s]
    return total[:, :plan.c, :plan.o].permute(2, 1, 0).reshape(plan.o, plan.c, 3, 3)


# (c_in, c_out, output extent, pad) of the step's K3 sites, extents / 8.
_SITES = [(64, 64, 32, 1), (128, 128, 16, 1), (256, 256, 8, 1), (256, 256, 8, 0),
          (513, 256, 8, 0), (256, 256, 16, 0), (513, 256, 16, 0), (256, 256, 32, 0),
          (513, 256, 32, 0)]
# (B, c_in, c_out, H, W, pad): extents that leave tail tiles, B = 2.
_ODD = [(2, 8, 5, 19, 35, 0), (2, 8, 5, 19, 35, 1), (2, 8, 5, 19, 35, 2),
        (2, 40, 72, 21, 34, 1), (2, 72, 40, 23, 36, 2), (1, 16, 8, 70, 9, 1)]


def _k3_cases():
    for c, o, e, pad in _SITES:
        yield 1, c, o, e + 2 - 2 * pad, e + 2 - 2 * pad, pad  # the forward
        # The data-grad: K3 on the cotangent (o channels) at pad 2 - pad.
        yield 1, o, c, e, e, 2 - pad
    yield from _ODD


def _tol(ref):
    # fp32 sums of 9C products in another order.
    return 1e-5 * max(1.0, ref.abs().max().item())


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("b,c,o,h,w,pad", list(_k3_cases()))
def test_k3_plan_replay_matches_plain(b, c, o, h, w, pad, sms):
    """sms 132 is the H100's plan; sms 1 keeps the widest output tiles
    (176 and 256 channels), which the card's plan narrows at these small
    extents."""
    plan = k3_plan(b, h, w, c, o, pad, sms)
    assert plan.box_w * plan.box_h == 128 and plan.c_store % 8 == 0 == plan.o_store % 8
    assert plan.kchunks == -(-c // 64)
    rng = np.random.default_rng(c + o + h + pad)
    x = torch.from_numpy(rng.standard_normal((b, c, h, w)).astype(np.float32))
    wt = torch.from_numpy((rng.standard_normal((o, c, 3, 3)) / np.sqrt(9 * c)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(o).astype(np.float32))
    ref = conv3x3_plain(x, wt, bias, pad)
    y = replay_k3(x, wt, bias, pad, plan)
    assert y.shape == ref.shape and torch.isfinite(y).all()
    assert (y - ref).abs().max().item() <= _tol(ref)


def _k4_cases():
    for c, o, e, pad in _SITES:
        yield 1, c, o, e + 2 - 2 * pad, e + 2 - 2 * pad, pad
    yield from ((b, c, o, h, w, pad) for b, c, o, h, w, pad in _ODD if pad < 2)
    yield 2, 64, 64, 64, 96, 1  # 192 tiles: more than one split on the H100's plan


@pytest.mark.parametrize("b,c,o,h,w,pad", list(_k4_cases()))
def test_k4_plan_replay_matches_plain(b, c, o, h, w, pad):
    plan = k4_plan(b, h, w, c, o, pad)
    assert plan.box_w * plan.box_h == 64
    assert (plan.splits - 1) * plan.tiles_per_split < plan.tiles <= plan.splits * plan.tiles_per_split
    rng = np.random.default_rng(c + o + h + pad + 1)
    x = torch.from_numpy(rng.standard_normal((b, c, h, w)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((b, o, h + 2 * pad - 2, w + 2 * pad - 2))
                         .astype(np.float32))
    ref = conv3x3_wgrad_plain(x, g, pad)
    dw = replay_k4(x, g, pad, plan)
    assert dw.shape == ref.shape and torch.isfinite(dw).all()
    assert (dw - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def test_plans_at_the_step_sites():
    """The boxes and tile widths the 1024^2 step runs, and the channel
    padding: only the 513-channel concat is copied (576 wide)."""
    p = k3_plan(1, 256, 256, 64, 64, 1)
    assert (p.box_w, p.box_h, p.bn, p.c_store, p.tiles) == (128, 1, 64, 64, 512)
    p = k3_plan(1, 258, 258, 513, 256, 0)  # iconv at 256^2
    assert (p.box_w, p.box_h, p.bn, p.c_store, p.kchunks) == (128, 1, 256, 576, 9)
    p = k3_plan(1, 64, 64, 256, 256, 1)
    assert (p.box_w, p.box_h) == (64, 2) and p.bn == 64  # 32 tiles: narrowed to fill SMs
    p = k3_plan(1, 256, 256, 256, 513, 2)  # iconv's data-grad: 513 outputs stored 576
    assert (p.o_store, p.bn, p.n_tiles, p.c_store) == (576, 176, 3, 256)
    assert p.box_w * p.box_h == 128 and p.tiles * 128 < 1.1 * 258 * 258
    q = k4_plan(1, 258, 258, 513, 256, 0)
    assert (q.box_w, q.box_h, q.bn, q.c_store, q.splits) == (64, 1, 256, 576, 3)
    q = k4_plan(1, 256, 256, 64, 64, 1)
    assert (q.bn, q.splits) == (64, 26) and q.splits * q.tiles_per_split >= 1024
