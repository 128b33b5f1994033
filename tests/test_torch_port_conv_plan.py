"""The K3/K4 tile plans replayed on the CPU.

On the card the bf16 kernels and K3's TF32 path read every operand as TMA
boxes: for K3, per output tile and (tap, channel chunk: 64 in bf16, 32 in
TF32), one box of the activation and one of the weight; for K4, per 128-pixel tile of a split, one box of the
activation for each of a block's (tap, chunk) items (two adjacent whole
chunks of one tap in one load) and the cotangent's boxes. `k3_plan` and
`k4_plan` say which boxes, and the kernels compute the same coordinates
from their block index. Here each box is cut out of the tensor with plain
slicing, zero-filled outside it as TMA fills it, multiplied and summed in
the kernels' order of tiles, splits and channel padding. The result must be
`conv3x3_plain` / `conv3x3_wgrad_plain`: an index error in a plan shows up
here before any card runs it.

Shapes: the nine K3 site shapes of the 1024^2 step (channels as they are,
extents / 8), each as the forward and as the data-grad (pad 2 - pad, the
channels swapped), and small shapes whose extents leave tail tiles, at pads
0, 1 and 2, with B = 2. The K4 replay is also held to the JAX package's
`_wgrad` on the same numpy inputs. K3's and K4's TF32 plans are replayed
on operands rounded as the TF32 kernels round them, against the plain
version of the rounded operands; K4's reads its 64-channel items and
output tiles as boxes of 32 channels (one 128-byte row of fp32), on tiles
of 64 pixels.
"""

import functools

import numpy as np
import pytest
import torch

from jperceiver_tpu_torch.ops.cuda.conv3x3 import (K4_CHAIN, conv3x3_plain,
                                                   conv3x3_wgrad_plain, k3_plan, k4_plan,
                                                   round_tf32)

_CHUNK = 64


@pytest.fixture(autouse=True)
def _one_thread():
    """The replays are thousands of small tensor operations: one intra-op
    thread runs them fastest, and keeps parallel test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    # in (chunk, 1, bn) boxes at (c0, tap, n0): here a (1, O, 9, C) tensor.
    wk = _nhwc(w, plan.c_store).reshape(1, plan.o, 9, plan.c_store)
    width = plan.chunk
    y = torch.full((plan.b, plan.ho, plan.wo, plan.o_store), float("nan"))
    rows = plan.box_w * plan.box_h
    for t in range(plan.tiles):
        b, oy0, ox0 = plan.tile_origin(t)
        for n in range(plan.n_tiles):
            n0 = n * plan.bn
            acc = torch.zeros(rows, plan.bn)
            for tap in range(9):
                for chunk in range(plan.kchunks):
                    a = _box(xs, plan.box(t, tap, chunk), width, plan.box_w, plan.box_h,
                             plan.c)
                    wb = _box(wk, (chunk * width, tap, n0, 0), width, 1, plan.bn, plan.c)
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
    """K4 computed box by box: per split, per block along the grid's x (its
    one or two (tap, chunk) items, `plan.k4_items`) and output-channel
    tile, the split's tiles (128 pixels in bf16, 64 in TF32) in order, each
    box a 128-byte row of channels, summed `flush_tiles` at a
    time and each sum added into a second sum, which is the split's
    partial; then `sum_splits`: the partials added over the splits in
    order, into (O, C, 3, 3). A block's two x boxes come in one load only
    for one tap's adjacent whole chunks (the pair map has no zero fill past
    C), and each item is some block's exactly once."""
    xs, gs = _nhwc(x, plan.c_store), _nhwc(g, plan.o_store)
    width = 128 // plan.elem  # channels of a box row: 64 in bf16, 32 in fp32
    blocks = [plan.k4_items(j) for j in range(-(-9 * plan.kchunks // 2))]
    items = [item for _, its in blocks for item in its]
    assert sorted(items) == [(tap, k) for tap in range(9) for k in range(plan.kchunks)]
    for paired, its in blocks:
        if paired:
            (t0, k0), (t1, k1) = its
            assert t0 == t1 and k1 == k0 + 1 and (k1 + 1) * _CHUNK <= plan.c
    partial = torch.full((plan.splits, 9, _CHUNK * plan.kchunks, plan.bn * plan.n_tiles),
                         float("nan"))
    for s in range(plan.splits):
        t_range = range(s * plan.tiles_per_split,
                        min(plan.tiles, (s + 1) * plan.tiles_per_split))
        assert len(t_range) > 0  # every split has pixels
        for _, its in blocks:
            for tap, chunk in its:
                for n in range(plan.n_tiles):
                    n0 = n * plan.bn
                    slot = None
                    acc = torch.zeros(_CHUNK, plan.bn)
                    for i, t in enumerate(t_range):
                        b, oy0, ox0 = plan.tile_origin(t)
                        c0, x0, y0, _ = plan.box(t, tap, chunk)
                        xb = torch.cat([_box(xs, (c0 + j, x0, y0, b), width, plan.box_w,
                                             plan.box_h, plan.c)
                                        for j in range(0, _CHUNK, width)], 1)
                        gb = torch.cat([_box(gs, (n0 + j, ox0, oy0, b), width, plan.box_w,
                                             plan.box_h, plan.o)
                                        for j in range(0, plan.bn, width)], 1)
                        acc += xb.T @ gb
                        # The accumulator goes into the second sum every
                        # flush_tiles tiles and after the last.
                        if (i + 1) % plan.flush_tiles == 0 or i + 1 == len(t_range):
                            slot = acc if slot is None else slot + acc
                            acc = torch.zeros(_CHUNK, plan.bn)
                    partial[s, tap, chunk * _CHUNK:(chunk + 1) * _CHUNK, n0:n0 + plan.bn] = slot
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


def _k3_operands(b, c, o, h, w, pad):
    rng = np.random.default_rng(c + o + h + pad)
    x = torch.from_numpy(rng.standard_normal((b, c, h, w)).astype(np.float32))
    wt = torch.from_numpy((rng.standard_normal((o, c, 3, 3)) / np.sqrt(9 * c)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(o).astype(np.float32))
    return x, wt, bias


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("b,c,o,h,w,pad", list(_k3_cases()))
def test_k3_plan_replay_matches_plain(b, c, o, h, w, pad, sms):
    """sms 132 is the H100's plan; sms 1 keeps the widest output tiles
    (176 and 256 channels), which the card's plan narrows at these small
    extents."""
    plan = k3_plan(b, h, w, c, o, pad, sms)
    assert plan.box_w * plan.box_h == 128 and plan.c_store % 8 == 0 == plan.o_store % 8
    assert plan.kchunks == -(-c // 64)
    x, wt, bias = _k3_operands(b, c, o, h, w, pad)
    ref = conv3x3_plain(x, wt, bias, pad)
    y = replay_k3(x, wt, bias, pad, plan)
    assert y.shape == ref.shape and torch.isfinite(y).all()
    assert (y - ref).abs().max().item() <= _tol(ref)


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("b,c,o,h,w,pad", list(_k3_cases()))
def test_k3_tf32_plan_replay_matches_plain(b, c, o, h, w, pad, sms):
    """K3's TF32 plan (fp32 operands, 32-channel chunks: one 128-byte box
    row): the same boxes of half the channels, operands stored in whole
    16 bytes (4 channels) or else whole 128-byte rows. The replay rounds x
    and the weight as the kernel and the wrapper do, and is held to the
    plain version of the rounded operands."""
    plan = k3_plan(b, h, w, c, o, pad, sms, elem=4)
    assert plan.chunk == 32 and plan.kchunks == -(-c // 32)
    assert plan.box_w * plan.box_h == 128 and plan.c_store % 4 == 0 == plan.o_store % 4
    assert plan.c_store == c or plan.c_store == -(-c // 32) * 32
    bf16 = k3_plan(b, h, w, c, o, pad, sms)
    assert (plan.box_w, plan.box_h, plan.bn) == (bf16.box_w, bf16.box_h, bf16.bn)
    x, wt, bias = _k3_operands(b, c, o, h, w, pad)
    xr, wr = round_tf32(x), round_tf32(wt)
    ref = conv3x3_plain(xr, wr, bias, pad)
    y = replay_k3(xr, wr, bias, pad, plan)
    assert y.shape == ref.shape and torch.isfinite(y).all()
    assert (y - ref).abs().max().item() <= _tol(ref)


def _k4_cases():
    for c, o, e, pad in _SITES:
        yield 1, c, o, e + 2 - 2 * pad, e + 2 - 2 * pad, pad
    yield from ((b, c, o, h, w, pad) for b, c, o, h, w, pad in _ODD if pad < 2)
    yield 2, 64, 64, 64, 96, 1  # 96 tiles: more than one split on the H100's plan
    # 256 outputs (two 128-wide tiles) over several splits; 136 channels:
    # 27 items, so the last pair holds one.
    yield 2, 72, 256, 34, 34, 1
    yield 4, 136, 256, 34, 34, 0
    # 200 channels: one pair of whole chunks a tap, then two chunks past it
    # (the second partial), loaded a box each.
    yield 2, 200, 136, 18, 20, 1


@functools.lru_cache(maxsize=None)
def _k4_replayed(b, c, o, h, w, pad):
    """One K4 case's numpy inputs (x, g) and its replay, computed once for
    the two tests that hold it to the plain version and to JAX."""
    rng = np.random.default_rng(c + o + h + pad + 1)
    x = rng.standard_normal((b, c, h, w)).astype(np.float32)
    g = rng.standard_normal((b, o, h + 2 * pad - 2, w + 2 * pad - 2)).astype(np.float32)
    return x, g, replay_k4(torch.from_numpy(x), torch.from_numpy(g), pad,
                           k4_plan(b, h, w, c, o, pad))


@pytest.mark.parametrize("b,c,o,h,w,pad", list(_k4_cases()))
def test_k4_plan_replay_matches_plain(b, c, o, h, w, pad):
    plan = k4_plan(b, h, w, c, o, pad)
    assert plan.box_w * plan.box_h == 128
    assert (plan.splits - 1) * plan.tiles_per_split < plan.tiles <= plan.splits * plan.tiles_per_split
    # The second sum takes the accumulator at least every K4_CHAIN wgmma (16 pixels each).
    assert 1 <= plan.flush_tiles <= plan.tiles_per_split
    assert plan.flush_tiles * 128 <= K4_CHAIN * 16
    x, g, dw = _k4_replayed(b, c, o, h, w, pad)
    ref = conv3x3_wgrad_plain(torch.from_numpy(x), torch.from_numpy(g), pad)
    assert dw.shape == ref.shape and torch.isfinite(dw).all()
    assert (dw - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("b,c,o,h,w,pad", list(_k4_cases()))
def test_k4_tf32_plan_replay_matches_plain(b, c, o, h, w, pad):
    """K4's TF32 plan (fp32 operands): tiles of 64 pixels, the bf16 plan's
    output-tile width and items, boxes of 32 channels, the second sum every
    K4_CHAIN wgmma of 8 pixels. The replay rounds x and the cotangent as
    the kernel does, and is held to the plain version of the rounded
    operands."""
    plan = k4_plan(b, h, w, c, o, pad, elem=4)
    bf16 = k4_plan(b, h, w, c, o, pad)
    assert plan.box_w * plan.box_h == 64 and plan.elem == 4 and plan.chunk == 64
    assert (plan.bn, plan.kchunks, plan.xpairs) == (bf16.bn, bf16.kchunks, bf16.xpairs)
    assert plan.c_store % 4 == 0 and (plan.c_store == c or plan.c_store == -(-c // 32) * 32)
    assert (plan.splits - 1) * plan.tiles_per_split < plan.tiles <= plan.splits * plan.tiles_per_split
    assert 1 <= plan.flush_tiles <= plan.tiles_per_split
    assert plan.flush_tiles * 64 <= K4_CHAIN * 8
    rng = np.random.default_rng(c + o + h + pad + 2)
    x = round_tf32(torch.from_numpy(rng.standard_normal((b, c, h, w)).astype(np.float32)))
    g = round_tf32(torch.from_numpy(
        rng.standard_normal((b, o, h + 2 * pad - 2, w + 2 * pad - 2)).astype(np.float32)))
    dw = replay_k4(x, g, pad, plan)
    ref = conv3x3_wgrad_plain(x, g, pad)
    assert dw.shape == ref.shape and torch.isfinite(dw).all()
    assert (dw - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("b,c,o,h,w,pad", list(_k4_cases()))
def test_k4_plan_replay_matches_jax_wgrad(b, c, o, h, w, pad):
    """The same replay against the JAX package's `_wgrad`
    (`jperceiver_tpu/ops/pallas/conv3x3.py:206-220`, XLA on the CPU in
    fp32) on the same numpy inputs: fp32 sums in another order, within
    1e-5 of the largest |dW|."""
    import jax.numpy as jnp

    from jperceiver_tpu.ops.pallas.conv3x3 import _wgrad

    x, g, dw = _k4_replayed(b, c, o, h, w, pad)
    ref = np.asarray(_wgrad(jnp.asarray(x.transpose(0, 2, 3, 1)),
                            jnp.asarray(g.transpose(0, 2, 3, 1)), pad)).transpose(3, 2, 0, 1)
    dw = dw.numpy()
    assert dw.shape == ref.shape and np.isfinite(dw).all()
    assert np.abs(dw - ref).max() <= 1e-5 * np.abs(ref).max()


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
    # TF32: the same tiles, 32 channels a K step; the concat is copied 544
    # wide (17 chunks), 513 outputs are stored 544 wide.
    p = k3_plan(1, 258, 258, 513, 256, 0, elem=4)
    assert (p.box_w, p.box_h, p.bn, p.c_store, p.kchunks) == (128, 1, 256, 544, 17)
    p = k3_plan(1, 256, 256, 256, 513, 2, elem=4)
    assert (p.o_store, p.bn, p.n_tiles, p.c_store, p.kchunks) == (544, 176, 3, 256, 8)
    p = k3_plan(1, 256, 256, 64, 64, 1, elem=4)
    assert (p.box_w, p.box_h, p.bn, p.c_store, p.kchunks) == (128, 1, 64, 64, 2)
    # K4: 128-pixel tiles, at most 128 wide (the second fp32 sum in
    # registers), its accumulator added into that sum every K4_CHAIN wgmma
    # (16 pixels each: 2 tiles), and the pixels split so that waves x
    # (tiles a block + 6) plus the partials' bytes is least.
    q = k4_plan(1, 258, 258, 513, 256, 0)
    assert (q.box_w, q.box_h, q.bn, q.c_store, q.splits) == (128, 1, 128, 576, 3)
    assert q.flush_tiles * 128 == K4_CHAIN * 16 and q.tiles_per_split == 171
    # 513 channels: 4 pairs of whole chunks a tap, each one x load, then the
    # ninth chunk (one real channel, zero-filled past it) a box an item.
    assert q.xpairs == 4 and q.k4_items(0) == (True, [(0, 0), (0, 1)])
    assert q.k4_items(36) == (False, [(0, 8), (1, 8)]) and q.k4_items(40) == (False, [(8, 8)])
    q = k4_plan(3, 258, 258, 513, 256, 0)  # the preset fit's B = 3: 5 waves of 82 x 8 blocks
    assert (q.bn, q.splits, q.tiles_per_split) == (128, 8, 192)
    q = k4_plan(8, 258, 258, 513, 256, 0)  # B = 8: the longest chains of the step's sites
    assert (q.splits, q.tiles_per_split) == (8, 512)
    q = k4_plan(1, 66, 66, 513, 256, 0)  # 32 tiles of 64 x 2: one split in two waves
    assert (q.box_w, q.box_h, q.splits, q.tiles_per_split) == (64, 2, 1, 32)
    q = k4_plan(1, 256, 256, 64, 64, 1)  # 64 wide, 5 blocks a split: one wave of 26 splits
    assert (q.bn, q.splits, q.tiles_per_split, q.xpairs) == (64, 26, 20, 0)
    assert q.k4_items(0) == (False, [(0, 0), (1, 0)])  # one chunk: two taps a block
    q = k4_plan(1, 64, 64, 256, 256, 1)  # 36 blocks a split: three splits in one wave
    assert (q.box_w, q.box_h, q.splits, q.tiles_per_split, q.xpairs) == (64, 2, 3, 11, 2)
    q = k4_plan(1, 128, 128, 128, 128, 1)  # 9 blocks a split: 13 splits in one wave
    assert (q.bn, q.splits, q.tiles_per_split) == (128, 13, 10)
    # K4 in TF32: tiles of 64 pixels (the same bytes a step), so twice the
    # tiles, the bf16 widths and items, the split model unchanged (on the
    # H100 its choice was the fastest split count, or within 1% of it, at
    # every site at B = 1 and 3: `chip_conv_sweep.py --k4-tf32`), and the
    # second sum every 2 tiles (16 wgmma of 8 pixels); the operands are
    # read where they lie, the 513-channel concat in its 544-wide copy.
    q = k4_plan(1, 258, 258, 513, 256, 0, elem=4)
    assert (q.box_w, q.box_h, q.bn, q.c_store, q.splits, q.tiles_per_split) == (
        64, 1, 128, 544, 8, 128)
    assert q.flush_tiles * 64 == K4_CHAIN * 8 and q.tiles == 1024 and q.xpairs == 4
    q = k4_plan(3, 258, 258, 513, 256, 0, elem=4)
    assert (q.splits, q.tiles_per_split) == (8, 384)
    q = k4_plan(1, 66, 66, 513, 256, 0, elem=4)
    assert (q.box_w, q.box_h, q.splits, q.tiles_per_split) == (64, 1, 3, 22)
    q = k4_plan(1, 256, 256, 64, 64, 1, elem=4)
    assert (q.bn, q.splits, q.tiles_per_split, q.c_store) == (64, 26, 40, 64)
    q = k4_plan(3, 256, 256, 64, 64, 1, elem=4)
    assert (q.splits, q.tiles_per_split) == (26, 119)
    q = k4_plan(1, 128, 128, 128, 128, 1, elem=4)
    assert (q.bn, q.splits, q.tiles_per_split) == (128, 14, 19)


@pytest.mark.parametrize("b,c,o,h,w,pad", [(1, 64, 64, 2, 2, 0), (0, 64, 64, 8, 8, 1),
                                           (1, 64, 0, 8, 8, 1)])
def test_k4_plan_refuses_no_work(b, c, o, h, w, pad):
    """A launch with no output pixel, image or channel has no plan: the
    wrapper raises on the card rather than run anything in its place."""
    with pytest.raises(ValueError):
        k4_plan(b, h, w, c, o, pad)
