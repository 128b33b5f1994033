"""3x3 stride-1 convolution: kernels K3 (forward and data-grad) and K4
(weight-grad), their plain versions, their tile plans, and the
differentiable `conv3x3_fwd`.

Counterpart of `jperceiver_tpu/ops/pallas/conv3x3.py` (`pallas_conv3x3` for
pad 1, `pallas_conv3x3_valid` for pad 0, each a `custom_vjp`). The kernels
are `csrc/conv3x3.cu`, an implicit GEMM over channels-last tiles, and
`csrc/conv3x3_wgrad.cu`, a pixel-split GEMM with a deterministic reduction;
see there for their design and bound. In bf16 both load their tiles with
TMA, one box per tap, and multiply with wgmma; `k3_plan` and `k4_plan` say
which boxes, and the CPU tests replay those plans with tensor slicing.

Contract: operands in their input dtype (bf16 or fp32), fp32 accumulation,
the bias added to the fp32 accumulator, the output in the input dtype.
Tensors are NCHW at this interface; the kernels read channels-last memory,
so the wrappers take an NCHW tensor in channels-last memory format as it is
and return outputs in that format.

The backward is the JAX `custom_vjp`'s (`conv3x3.py:237-248`): the
data-grad is K3 itself on the cotangent (cast to the input dtype) with the
flipped, transposed weights at pad `2 - pad`; the weight-grad is K4 in
fp32, returned in the weight operand's dtype; the bias-grad is a sum.

Each wrapper launches its kernel for a CUDA tensor and takes the plain
version only for a CPU tensor.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import _build

# Launches of the kernels (not of the plain versions) in this process:
# K3 as the forward, K3 as the data-grad, K4.
LAUNCHES = {"conv3x3": 0, "conv3x3_dgrad": 0, "conv3x3_wgrad": 0}

_DTYPES = (torch.float32, torch.bfloat16)
_F32_C_ALIGN = 32  # fp32 K3's K step: input channels are zero-padded to this
_F32_WG_TILE = 64  # fp32 K4's tile: channels and output channels are padded to this
_F32_WG_BK = 32    # fp32 K4's pixel chunk granule

# bf16 tiles. A TMA box holds 64 channels (one 128-byte swizzled row) of
# box_w x box_h pixels of one image. TMA needs strides in multiples of 16
# bytes (8 channels) and fills channels past the real count with zeros.
_CHUNK = 64
_K3_PIXELS, _K4_PIXELS = 128, 64
# The most `wgmma` (16 pixels each) K4's accumulator sums before the kernel
# adds it into its second fp32 sum, in registers: wgmma's own adds lose
# precision with the length of that chain (`k4_plan`).
K4_CHAIN = 16
# What a wave of K4 blocks costs beyond its tiles (pipeline fill, the
# partial's store), in tiles of a block (`k4_plan`).
_K4_WAVE_TILES = 4
_K3_WIDTHS, _K4_WIDTHS = (256, 176, 128, 64), (128, 64)
_BOX_WIDTHS = (128, 64, 32, 16, 8)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def channels_stored(c: int) -> int:
    """The channel stride of a bf16 operand the wrapper has to copy (its
    pixel stride is not a multiple of 8): whole 128-byte rows, so that no
    64-channel box row straddles two of them (`chip_conv_sweep.py`, H100:
    K3 at 513 -> 256 @ 256^2 took 0.266 ms on an activation stored 520 wide,
    0.248 ms at 576). A count that needs no copy is kept."""
    return c if c % 8 == 0 else _ceil(c, _CHUNK) * _CHUNK


@dataclass(frozen=True)
class TilePlan:
    """Which TMA boxes a bf16 K3 or K4 launch reads, as its kernel computes
    them from the block index.

    The output pixels (B, Ho, Wo) are cut into tiles of box_w x box_h pixels
    of one image, numbered x fastest, then y, then image. Input channels are
    read 64 at a time (`kchunks` chunks), zero past `c`. K3 gives a block
    one tile and `bn` output channels and loops over (tap, chunk); K4 gives
    a block two (tap, chunk) items, `bn` output channels and a split of
    `tiles_per_split` consecutive tiles, and loops over the tiles, adding
    its `wgmma` accumulator into a second fp32 sum every `flush_tiles`
    tiles; at the end it writes that sum as the split's partial. An
    operand that has to be copied is stored `c_store` (`o_store`) channels
    wide; K3's output is stored `o_store` wide.
    """

    b: int
    h: int
    w: int
    c: int
    o: int
    pad: int
    box_w: int
    box_h: int
    bn: int
    splits: int = 1
    tiles_per_split: int = 0
    flush_tiles: int = 0

    @property
    def ho(self) -> int:
        return self.h + 2 * self.pad - 2

    @property
    def wo(self) -> int:
        return self.w + 2 * self.pad - 2

    @property
    def tiles_x(self) -> int:
        return _ceil(self.wo, self.box_w)

    @property
    def tiles_y(self) -> int:
        return _ceil(self.ho, self.box_h)

    @property
    def tiles(self) -> int:
        return self.b * self.tiles_x * self.tiles_y

    @property
    def c_store(self) -> int:
        return channels_stored(self.c)

    @property
    def o_store(self) -> int:
        return channels_stored(self.o)

    @property
    def kchunks(self) -> int:
        return _ceil(self.c, _CHUNK)

    @property
    def n_tiles(self) -> int:
        return _ceil(self.o, self.bn)

    def tile_origin(self, t: int) -> tuple[int, int, int]:
        """(image, oy0, ox0) of output tile t."""
        tx, ty = t % self.tiles_x, (t // self.tiles_x) % self.tiles_y
        return t // (self.tiles_x * self.tiles_y), ty * self.box_h, tx * self.box_w

    def box(self, t: int, tap: int, chunk: int) -> tuple[int, int, int, int]:
        """Coordinates (c0, x0, y0, image), innermost first, of the box of
        the activation that output tile t reads through tap (ky*3 + kx) and
        channel chunk `chunk`. Negative or past-the-end coordinates are
        zero-filled by TMA: that is the padding."""
        b, oy0, ox0 = self.tile_origin(t)
        ky, kx = divmod(tap, 3)
        return chunk * _CHUNK, ox0 + kx - self.pad, oy0 + ky - self.pad, b


def _pick_box(ho: int, wo: int, pixels: int) -> tuple[int, int]:
    """The box_w x box_h = `pixels` shape whose tiles cover (ho, wo) with
    the fewest pixels, the widest of equals."""
    best = None
    for bw in _BOX_WIDTHS:
        if bw > pixels:
            continue
        bh = pixels // bw
        area = _ceil(wo, bw) * bw * _ceil(ho, bh) * bh
        if best is None or area < best[0]:
            best = (area, bw, bh)
    return best[1], best[2]


@functools.lru_cache(maxsize=512)
def k3_plan(b: int, h: int, w: int, c: int, o: int, pad: int, sms: int = 132) -> TilePlan:
    """The tile plan of a bf16 K3 launch on x (b, c, h, w) with o outputs:
    tiles of 128 pixels, and the output-tile width that takes the fewest
    waves of blocks on `sms` SMs weighed by a block's time, about bn + 53
    (fitted to `chip_conv_sweep.py` at 256 -> 256 @ 128^2 on the H100:
    28.6, 17.4 and 14.3 us a wave of blocks 256, 128 and 64 wide)."""
    ho, wo = h + 2 * pad - 2, w + 2 * pad - 2
    box_w, box_h = _pick_box(ho, wo, _K3_PIXELS)
    tiles = b * _ceil(wo, box_w) * _ceil(ho, box_h)
    bn = min(_K3_WIDTHS, key=lambda n: (_ceil(tiles * _ceil(o, n), sms) * (n + 53),
                                        _ceil(o, n) * n, -n))
    return TilePlan(b, h, w, c, o, pad, box_w, box_h, bn)


@functools.lru_cache(maxsize=512)
def k4_plan(b: int, h: int, w: int, c: int, o: int, pad: int, sms: int = 132) -> TilePlan:
    """The tile plan of a bf16 K4 launch on x (b, c, h, w) and a cotangent
    of o channels: tiles of 64 pixels, the output-tile width (64 or 128:
    the kernel's second sum sits in registers beside its accumulator) that
    covers o with the fewest columns, the widest of equals, and the pixels
    cut into the splits that make the kernel's critical path least: waves
    of blocks on the `sms` SMs times (the tiles a block sums plus
    _K4_WAVE_TILES), of equals the fewest splits (each writes 9 x 64
    kchunks x o fp32 partials that `sum_splits` reads again), with at
    least 16 tiles a split.

    Within a split the kernel sums K4_CHAIN `wgmma` in its accumulator
    before it adds them into the second fp32 sum: summed in the accumulator
    alone, 1,024 tiles came out 71x the plain version's distance to float64
    at 513 -> 256 @ 256^2 and B = 3 on the H100 (`chip_conv_sweep.py
    --k4-flush`)."""
    ho, wo = h + 2 * pad - 2, w + 2 * pad - 2
    box_w, box_h = _pick_box(ho, wo, _K4_PIXELS)
    tiles = b * _ceil(wo, box_w) * _ceil(ho, box_h)
    bn = min(_K4_WIDTHS, key=lambda n: (_ceil(o, n) * n, -n))
    blocks = _ceil(9 * _ceil(c, _CHUNK), 2) * _ceil(o, bn)
    splits = min(range(1, max(1, tiles // 16) + 1),
                 key=lambda s: (_ceil(blocks * s, sms) * (_ceil(tiles, s) + _K4_WAVE_TILES), s))
    per_split = _ceil(tiles, splits)
    return TilePlan(b, h, w, c, o, pad, box_w, box_h, bn, _ceil(tiles, per_split), per_split,
                    min(K4_CHAIN * 16 // _K4_PIXELS, per_split))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _stream(t: torch.Tensor) -> int:
    """The current CUDA stream of t's device as a raw handle, without
    building the `torch.cuda.Stream` object that
    `torch.cuda.current_stream(device)` returns: the step is host-bound and
    makes 78 K3/K4 calls."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                  pad: int) -> torch.Tensor:
    """F.conv2d on fp32-upcast operands, bias in fp32, cast back to x.dtype."""
    y = F.conv2d(x.float(), w.float(), None if b is None else b.float(),
                 padding=pad)
    return y.to(x.dtype)


def conv3x3_wgrad_plain(x: torch.Tensor, g: torch.Tensor, pad: int) -> torch.Tensor:
    """The JAX `_wgrad` (`conv3x3.py:206-220`): dW (O, C, 3, 3) fp32, nine
    fp32 contractions of the shifted, zero-padded x with g over pixels."""
    xp = F.pad(x.float(), (pad, pad, pad, pad))
    gf = g.float()
    ho, wo = g.shape[2], g.shape[3]
    taps = [torch.einsum("bchw,bohw->oc", xp[:, :, ky:ky + ho, kx:kx + wo], gf)
            for ky in range(3) for kx in range(3)]
    return torch.stack(taps, -1).reshape(g.shape[1], x.shape[1], 3, 3)


def _check(x, w, pad):
    if pad not in (0, 1, 2):
        raise ValueError(f"conv3x3: pad must be 0, 1 or 2, got {pad}")
    if x.dim() != 4 or w.shape[1:] != (x.shape[1], 3, 3):
        raise ValueError(
            f"conv3x3: x {tuple(x.shape)} and w {tuple(w.shape)} "
            "do not form a 3x3 conv")


def _nhwc_padded(t: torch.Tensor, channels: int) -> torch.Tensor:
    """(B, C, H, W) -> contiguous (B, H, W, channels), zero-padded channels;
    no copy for a channels-last tensor that needs no padding (the fp32
    kernels' operands)."""
    th = t.permute(0, 2, 3, 1)
    c = t.shape[1]
    return F.pad(th, (0, channels - c)) if channels != c else th.contiguous()


def _tma_operand(t: torch.Tensor) -> torch.Tensor:
    """A (B, C, H, W) bf16 tensor as the (B, H, W, C) view a bf16 kernel
    reads: channels contiguous, other strides multiples of 8 elements, 16-byte
    aligned. A channels-last tensor with C a multiple of 8 is itself that
    view; anything else is copied into a `channels_stored(C)`-wide buffer,
    whose channels past C are never read."""
    th = t.permute(0, 2, 3, 1)
    if th.stride(3) == 1 and all(st % 8 == 0 for st in th.stride()[:3]) \
            and th.data_ptr() % 16 == 0:
        return th
    bsz, h, w, c = th.shape
    buf = torch.empty((bsz, h, w, channels_stored(c)), device=t.device, dtype=t.dtype)
    buf[..., :c].copy_(th)
    return buf[..., :c]


def _weight_operand(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(O, C, 3, 3) -> (O, 3, 3, channels_stored(C)) in `dtype`, one copy."""
    o, c = w.shape[:2]
    out = torch.empty((o, 3, 3, channels_stored(c)), device=w.device, dtype=dtype)
    out[..., :c].copy_(w.permute(0, 2, 3, 1))
    return out


def _strides(th: torch.Tensor) -> tuple[int, int, int]:
    """Pixel, row and image strides of a (B, H, W, C) view."""
    return th.stride(2), th.stride(1), th.stride(0)


def _conv(x, w, b, pad, counter, xh=None):
    """K3 for a CUDA tensor, the plain version for a CPU one; no autograd.
    `xh`: x as `_tma_operand` gives it, where the caller has it already."""
    if not x.is_cuda:
        return conv3x3_plain(x, w, b, pad)
    if x.dtype not in _DTYPES:
        raise TypeError(f"conv3x3: dtype {x.dtype} is not bf16 or fp32")
    bsz, c, h, wd = x.shape
    o = w.shape[0]
    ho, wo = h + 2 * pad - 2, wd + 2 * pad - 2
    stream = _stream(x)
    if x.dtype == torch.bfloat16:
        p = k3_plan(bsz, h, wd, c, o, pad, _sm_count(x.device.index))
        xh = _tma_operand(x) if xh is None else xh
        wk = _weight_operand(w, x.dtype)
        # The kernel adds a bf16 bias as it is (it converts exactly), any
        # other in fp32.
        bias = None if b is None else b.to(
            device=x.device, dtype=b.dtype if b.dtype == torch.bfloat16 else torch.float32)
        ys = torch.empty((bsz, ho, wo, p.o_store), device=x.device, dtype=x.dtype)
        err = _build.library().jp_conv3x3_fwd_bf16(
            xh.data_ptr(), wk.data_ptr(), None if bias is None else bias.contiguous().data_ptr(),
            ys.data_ptr(), bsz, h, wd, c, *_strides(xh), wk.shape[3], o, p.o_store, pad,
            p.box_w, p.box_h, p.bn, int(b is not None and b.dtype == torch.bfloat16), stream)
        y = ys.permute(0, 3, 1, 2)
        y = y[:, :o] if p.o_store != o else y
    else:
        cp = _ceil(c, _F32_C_ALIGN) * _F32_C_ALIGN
        xh, wk = _nhwc_padded(x, cp), _nhwc_padded(w.to(device=x.device, dtype=x.dtype), cp)
        bias = None if b is None else b.to(device=x.device, dtype=torch.float32).contiguous()
        y = torch.empty((bsz, o, ho, wo), device=x.device, dtype=x.dtype,
                        memory_format=torch.channels_last)
        _aligned(xh, wk)
        err = _build.library().jp_conv3x3_fwd_f32(
            xh.data_ptr(), wk.data_ptr(), None if bias is None else bias.data_ptr(),
            y.data_ptr(), bsz, h, wd, cp, o, pad, stream)
    _build.check(err, "conv3x3")
    LAUNCHES[counter] += 1
    return y


def _aligned(*ts: torch.Tensor) -> None:
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("conv3x3: operands are not 16-byte aligned")


def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor, pad: int) -> torch.Tensor:
    """dL/dW (O, C, 3, 3) fp32 of the 3x3 conv of x (B, C, H, W) at `pad`,
    given the output cotangent g (B, O, Ho, Wo) in x's dtype: kernel K4 for
    a CUDA tensor, the plain version for a CPU one."""
    if pad not in (0, 1, 2):
        raise ValueError(f"conv3x3_wgrad: pad must be 0, 1 or 2, got {pad}")
    if not x.is_cuda:
        return conv3x3_wgrad_plain(x, g, pad)
    if x.dtype not in _DTYPES or g.dtype != x.dtype:
        raise TypeError(f"conv3x3_wgrad: dtypes {x.dtype}, {g.dtype}; "
                        "want one of bf16 and fp32 for both")
    bsz, c, h, wd = x.shape
    o, ho, wo = g.shape[1], g.shape[2], g.shape[3]
    if g.shape[0] != bsz or (ho, wo) != (h + 2 * pad - 2, wd + 2 * pad - 2):
        raise ValueError(f"conv3x3_wgrad: x {tuple(x.shape)} and g "
                         f"{tuple(g.shape)} do not match at pad {pad}")
    if x.dtype == torch.bfloat16:
        return _wgrad_bf16(_tma_operand(x), g, pad)
    out = torch.empty((o, c, 3, 3), device=x.device, dtype=torch.float32)
    cp = _ceil(c, _F32_WG_TILE) * _F32_WG_TILE
    op = _ceil(o, _F32_WG_TILE) * _F32_WG_TILE
    xh, gh = _nhwc_padded(x, cp), _nhwc_padded(g, op)
    _aligned(xh, gh)
    m = bsz * ho * wo
    # Split the pixels so that about four blocks run on each SM.
    sms = _sm_count(x.device.index)
    tiles = 9 * (cp // _F32_WG_TILE) * (op // _F32_WG_TILE)
    steps = _ceil(m, _F32_WG_BK)
    splits = max(1, min(_ceil(4 * sms, tiles), steps // 16))
    chunk = _ceil(steps, splits) * _F32_WG_BK
    splits = _ceil(m, chunk)
    partial = torch.empty((splits, 9, cp, op), device=x.device, dtype=torch.float32)
    err = _build.library().jp_conv3x3_wgrad_f32(
        xh.data_ptr(), gh.data_ptr(), partial.data_ptr(), out.data_ptr(),
        bsz, h, wd, c, cp, o, op, pad, chunk, splits, _stream(x))
    _build.check(err, "conv3x3_wgrad")
    LAUNCHES["conv3x3_wgrad"] += 1
    return out


def _wgrad_bf16(xh: torch.Tensor, g: torch.Tensor, pad: int) -> torch.Tensor:
    """K4 in bf16 on x as `_tma_operand` gives it, (B, H, W, C)."""
    bsz, h, wd, c = xh.shape
    o = g.shape[1]
    p = k4_plan(bsz, h, wd, c, o, pad, _sm_count(xh.device.index))
    gh = _tma_operand(g)
    out = torch.empty((o, c, 3, 3), device=xh.device, dtype=torch.float32)
    partial = torch.empty((p.splits, 9, _CHUNK * p.kchunks, p.bn * p.n_tiles),
                          device=xh.device, dtype=torch.float32)
    err = _build.library().jp_conv3x3_wgrad_bf16(
        xh.data_ptr(), gh.data_ptr(), partial.data_ptr(), out.data_ptr(),
        bsz, h, wd, c, *_strides(xh), o, *_strides(gh), pad, p.box_w, p.box_h, p.bn,
        p.splits, p.tiles_per_split, p.flush_tiles, _stream(xh))
    _build.check(err, "conv3x3_wgrad")
    LAUNCHES["conv3x3_wgrad"] += 1
    return out


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, pad):
        ctx.pad = pad
        ctx.bias_dtype = None if b is None else b.dtype
        # bf16 on the card: the operand K3 reads is the one K4 reads in the
        # backward, so a copy made for TMA (the 513-channel concat) is made
        # once and saved instead of x.
        xh = _tma_operand(x) if x.is_cuda and x.dtype == torch.bfloat16 else None
        ctx.save_for_backward(x if xh is None else xh, w)
        return _conv(x, w, b, pad, "conv3x3", xh)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        pad = ctx.pad
        dx = dw = db = None
        nhwc = x.is_cuda and x.dtype == torch.bfloat16
        dtype = x.dtype
        if ctx.needs_input_grad[0]:
            # (O, C, ky, kx) -> (C, O, 2-ky, 2-kx): the data-grad is a conv.
            wt = w.flip(2, 3).transpose(0, 1)
            dx = _conv(g.to(dtype), wt.to(dtype), None, 2 - pad, "conv3x3_dgrad")
        if ctx.needs_input_grad[1]:
            gd = g.to(dtype)
            dw = (_wgrad_bf16(x, gd, pad) if nhwc else conv3x3_wgrad(x, gd, pad)).to(w.dtype)
        if ctx.bias_dtype is not None and ctx.needs_input_grad[2]:
            db = g.float().sum((0, 2, 3)).to(ctx.bias_dtype)
        return dx, dw, db, None


def conv3x3_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                pad: int) -> torch.Tensor:
    """3x3 stride-1 conv: x (B, C, H, W), w (O, C, 3, 3), b (O,) or None,
    differentiable in x, w and b.

    pad 1 is SAME zero padding; pad 0 is VALID on a pre-padded input; pad 2
    is the full conv (the data-grad of VALID).
    """
    _check(x, w, pad)
    return _Conv3x3.apply(x, w, b, pad)


# -- the two eligibility gates (`jperceiver_tpu/ops/pallas/conv3x3.py:261-306`)

def shallow_gate(c_in: int, c_out: int, h: int, w: int) -> bool:
    """`use_pallas_conv`: 48 <= C_in <= 128, C_out <= 128, H*W >= 128^2,
    H and W even (h, w are the OUTPUT extent)."""
    if h < 8 or w < 8 or h % 2 or w % 2:
        return False
    if not (48 <= c_in <= 128 and c_out <= 128):
        return False
    return h * w >= 16384


def deep_gate(c_in: int, c_out: int, h: int, w: int) -> bool:
    """`use_pallas_conv_deep`: C_in >= 128, C_out >= 128, H*W >= 64^2."""
    if h < 8 or w < 8:
        return False
    return c_in >= 128 and c_out >= 128 and h * w >= 4096


def conv_site_eligible(c_in: int, c_out: int, h: int, w: int,
                       shallow: bool, deep: bool) -> bool:
    """Whether a stride-1 3x3 site goes to K3, deep gate first as in JAX
    (`jperceiver_tpu/models/common.py:373-389`)."""
    if deep and deep_gate(c_in, c_out, h, w):
        return True
    return shallow and shallow_gate(c_in, c_out, h, w)
