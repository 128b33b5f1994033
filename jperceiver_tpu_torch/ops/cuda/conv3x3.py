"""3x3 stride-1 convolution: kernels K3 (forward and data-grad) and K4
(weight-grad), their plain versions, their tile plans, and the
differentiable `conv3x3_fwd`.

Counterpart of `jperceiver_tpu/ops/pallas/conv3x3.py` (`pallas_conv3x3` for
pad 1, `pallas_conv3x3_valid` for pad 0, each a `custom_vjp`). The kernels
are `csrc/conv3x3.cu`, an implicit GEMM over channels-last tiles, and
`csrc/conv3x3_wgrad.cu`, a pixel-split GEMM with a deterministic reduction;
see there for their design and bound. In bf16 both load their tiles with
TMA, one box per tap, and multiply with wgmma; so do both on fp32 operands
in TF32, 32 channels a box row; `k3_plan` and `k4_plan` say which boxes,
and the CPU tests replay those plans with tensor slicing.

Contract: operands in their input dtype (bf16 or fp32), fp32 accumulation,
the bias added to the fp32 accumulator, the output in the input dtype.
Float32 K3 and K4 calls follow `torch.backends.cudnn.allow_tf32`, read at
each call, as cuDNN's fp32 convolution does (`k3_path`, `k4_path`): set
(PyTorch's default), the operands go to TF32 products, rounded to nearest
even at 10 mantissa bits (`round_tf32`: K3's weight here, K3's activation
and both of K4's operands in the kernels), with fp32 accumulation -- the
benchmark's reference rounds every convolution's operands and incoming
gradient so; off, they stay exact fp32 products on the CUDA cores. A TF32
kernel's bound at a site is its operations at 494.7 TFLOP/s or its bytes
at 3.35 TB/s; K3 reaches 0.16-0.70 of it at the step's sites, 0.52 at the
widest at B = 3 (`csrc/conv3x3.cu`); K4's shares are in
`csrc/conv3x3_wgrad.cu`.
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

import collections
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import _build

# Launches of the kernels (not of the plain versions) in this process:
# K3 as the forward, K3 as the data-grad, K4.
LAUNCHES = {"conv3x3": 0, "conv3x3_dgrad": 0, "conv3x3_wgrad": 0}
# Of K3's and K4's launches (each counted in LAUNCHES too), those that took the TF32 path.
TF32_LAUNCHES = {"conv3x3": 0, "conv3x3_dgrad": 0, "conv3x3_wgrad": 0}
# The same launches by what each computed: (kernel, dtype, N, H, W, C_in, C_out, pad), the
# kernel a key of LAUNCHES, H and W the input's, the channels unpadded.
SHAPES: collections.Counter = collections.Counter()

_DTYPES = (torch.float32, torch.bfloat16)
_F32_C_ALIGN = 32  # fp32 K3's K step: input channels are zero-padded to this
_F32_WG_TILE = 64  # fp32 K4's tile: channels and output channels are padded to this
_F32_WG_BK = 32    # fp32 K4's pixel chunk granule

# bf16 tiles. A TMA box holds 64 channels (one 128-byte swizzled row) of
# box_w x box_h pixels of one image. TMA needs strides in multiples of 16
# bytes (8 channels) and fills channels past the real count with zeros.
_CHUNK = 64
_K3_PIXELS = 128
_K4_PIXELS = {2: 128, 4: 64}  # by element size: a TF32 step reads the same bytes
# The most `wgmma` (16 pixels each in bf16, 8 in TF32) K4's accumulator sums
# before the kernel adds it into its second fp32 sum, in registers: wgmma's
# own adds lose precision with the length of that chain (`k4_plan`). At 128
# pixels a bf16 step, or 64 a TF32 one, that is every 2 steps. The adds cost
# next to nothing: with no second sum at all a bf16 step is no faster (within
# 4%, `chip_conv_sweep.py --k4-anatomy` on the H100), since what sets it is
# the step's loads.
K4_CHAIN = 16
# What a wave of K4 blocks costs beyond its tiles (pipeline fill, the
# partial's store), in tiles of a block, and the bytes of fp32 partials that
# `sum_splits` reads in about a tile's time (`k4_plan`).
_K4_WAVE_TILES = 6
_K4_SUM_BYTES = 2.5e6
_K3_WIDTHS, _K4_WIDTHS = (256, 176, 128, 64), (128, 64)
_BOX_WIDTHS = (128, 64, 32, 16, 8)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def channels_stored(c: int, elem: int = 2) -> int:
    """The channel stride of an operand of `elem`-byte channels (2: bf16,
    4: fp32) that the wrapper has to copy (its pixel stride is not a
    multiple of 16 bytes): whole 128-byte rows, so that no box row straddles
    two of them (`chip_conv_sweep.py`, H100: bf16 K3 at 513 -> 256 @ 256^2
    took 0.266 ms on an activation stored 520 wide, 0.248 ms at 576). A
    count that needs no copy is kept."""
    return c if (c * elem) % 16 == 0 else _ceil(c, 128 // elem) * (128 // elem)


@dataclass(frozen=True)
class TilePlan:
    """Which TMA boxes a K3 or K4 launch on the tensor cores (bf16, or fp32
    in TF32: `elem` bytes an element) reads, as its kernel computes them
    from the block index.

    The output pixels (B, Ho, Wo) are cut into tiles of box_w x box_h pixels
    of one image, numbered x fastest, then y, then image. Input channels are
    read `chunk` at a time (`kchunks` chunks), zero past `c`: for K3 a box
    row, 64 in bf16 and 32 in TF32 (128 bytes either way); for K4 an item's
    64 channels at either size (two box rows in TF32). K3 gives a block
    one tile and `bn` output channels and loops over (tap, chunk); K4 gives
    a block two (tap, chunk) items (`k4_items`), `bn` output channels and
    a split of `tiles_per_split` consecutive tiles, and loops over the
    tiles, adding its `wgmma` accumulator into a second fp32 sum every
    `flush_tiles` tiles; at the end it writes that sum as the split's
    partial. Where a block's two items are one tap's adjacent whole chunks
    its x boxes come in one load, and so do its g boxes where its output
    channels are whole chunks. An
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
    chunk: int = _CHUNK
    elem: int = 2

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
        return channels_stored(self.c, self.elem)

    @property
    def o_store(self) -> int:
        return channels_stored(self.o, self.elem)

    @property
    def kchunks(self) -> int:
        return _ceil(self.c, self.chunk)

    @property
    def n_tiles(self) -> int:
        return _ceil(self.o, self.bn)

    @property
    def xpairs(self) -> int:
        """K4: the pairs of whole 64-channel chunks of x a tap."""
        return (self.c // _CHUNK) // 2

    def k4_items(self, j: int) -> tuple[bool, list[tuple[int, int]]]:
        """K4 block j's (tap, chunk) items along the grid's x, and whether
        its two x boxes come in one load, as the kernel's `block_items`
        gives them: the first 9 * xpairs blocks take each tap's chunk pairs
        (2k, 2k + 1), the rest the chunks past those two at a time,
        tap-major; ceil(9 kchunks / 2) blocks in all."""
        if j < 9 * self.xpairs:
            tap, k = divmod(j, self.xpairs)
            return True, [(tap, 2 * k), (tap, 2 * k + 1)]
        left = self.kchunks - 2 * self.xpairs
        q = 2 * (j - 9 * self.xpairs)
        return False, [(qq // left, 2 * self.xpairs + qq % left)
                       for qq in range(q, min(q + 2, 9 * left))]

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
        return chunk * self.chunk, ox0 + kx - self.pad, oy0 + ky - self.pad, b


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
def k3_plan(b: int, h: int, w: int, c: int, o: int, pad: int, sms: int = 132,
            elem: int = 2) -> TilePlan:
    """The tile plan of a K3 launch on x (b, c, h, w) with o outputs, of
    `elem`-byte operands (2: the bf16 kernel; 4: the TF32 one, which reads
    32 channels a K step where bf16 reads 64, in boxes of the same bytes):
    tiles of 128 pixels, and the output-tile width that takes the fewest
    waves of blocks on `sms` SMs weighed by a block's time, about bn + 53
    (fitted to `chip_conv_sweep.py` at 256 -> 256 @ 128^2 on the H100 in
    bf16: 28.6, 17.4 and 14.3 us a wave of blocks 256, 128 and 64 wide; a
    TF32 step moves the same bytes for half the products at half the
    rate, so the same weights hold)."""
    ho, wo = h + 2 * pad - 2, w + 2 * pad - 2
    box_w, box_h = _pick_box(ho, wo, _K3_PIXELS)
    tiles = b * _ceil(wo, box_w) * _ceil(ho, box_h)
    bn = min(_K3_WIDTHS, key=lambda n: (_ceil(tiles * _ceil(o, n), sms) * (n + 53),
                                        _ceil(o, n) * n, -n))
    return TilePlan(b, h, w, c, o, pad, box_w, box_h, bn, chunk=128 // elem, elem=elem)


@functools.lru_cache(maxsize=512)
def k4_plan(b: int, h: int, w: int, c: int, o: int, pad: int, sms: int = 132,
            elem: int = 2) -> TilePlan:
    """The tile plan of a K4 launch on x (b, c, h, w) and a cotangent of o
    channels, of `elem`-byte operands (2: the bf16 kernel; 4: the TF32 one):
    tiles of 128 pixels in bf16 and 64 in TF32 (a step's boxes hold the
    same bytes, for half the products at half the rate), the output-tile
    width (64 or 128: the kernel's second sum sits in registers beside its
    accumulator) that covers o with the fewest columns, the widest of
    equals, and the pixels
    cut into the splits that make the launch's time least: waves of blocks
    on the `sms` SMs times (the tiles a block sums plus _K4_WAVE_TILES),
    plus the splits' fp32 partials (9 x 64 kchunks x o each) that
    `sum_splits` reads, _K4_SUM_BYTES a tile; of equals the fewest splits,
    with at least 8 tiles a split. (Fitted to `chip_conv_sweep.py` on the
    H100 at the step's sites, B = 1: a 128-pixel tile takes a block about
    1 us at 128 wide, 0.7 at 64. The TF32 plan keeps the weights in its
    64-pixel tiles: at every site at B = 1 and 3 its split count was the
    fastest that `chip_conv_sweep.py --k4-tf32` tried, or within 1%.)

    What bounds the kernel on the H100 is its loads, per load and per step
    more than per byte (`chip_conv_sweep.py --k4-anatomy`): so the tiles
    are 128 pixels (64 took 1.4-1.6x as long a pixel), and a block's two x
    boxes come in one load where its items are one tap's adjacent whole
    chunks (`TilePlan.k4_items`), as do its two g boxes at 128 wide. At
    the small sites the launch's fill and `sum_splits` weigh as much as
    the steps, which the wave and partial terms above price.

    Within a split the kernel sums K4_CHAIN `wgmma` in its accumulator
    before it adds them into the second fp32 sum: summed in the accumulator
    alone, 4,096 `wgmma` came out 71x the plain version's distance to
    float64 at 513 -> 256 @ 256^2 and B = 3 on the H100 (`chip_conv_sweep.py
    --k4-flush`)."""
    ho, wo = h + 2 * pad - 2, w + 2 * pad - 2
    if min(b, c, o, ho, wo) < 1:
        raise ValueError(f"k4_plan: no work in x ({b}, {c}, {h}, {w}) -> {o} at pad {pad}")
    pixels = _K4_PIXELS[elem]
    box_w, box_h = _pick_box(ho, wo, pixels)
    tiles = b * _ceil(wo, box_w) * _ceil(ho, box_h)
    bn = min(_K4_WIDTHS, key=lambda n: (_ceil(o, n) * n, -n))
    blocks = _ceil(9 * _ceil(c, _CHUNK), 2) * _ceil(o, bn)
    partial = 9 * _CHUNK * _ceil(c, _CHUNK) * bn * _ceil(o, bn) * 4
    splits = min(range(1, max(1, tiles // 8) + 1),
                 key=lambda s: (_ceil(blocks * s, sms) * (_ceil(tiles, s) + _K4_WAVE_TILES)
                                + s * partial / _K4_SUM_BYTES, s))
    per_split = _ceil(tiles, splits)
    # A wgmma sums 32 bytes of pixels: 16 in bf16, 8 in TF32.
    return TilePlan(b, h, w, c, o, pad, box_w, box_h, bn, _ceil(tiles, per_split), per_split,
                    min(K4_CHAIN * (32 // elem) // pixels, per_split), elem=elem)


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


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """An fp32 tensor rounded to TF32: to nearest, ties to even, at 10
    mantissa bits (the 13 low bits cleared), by an integer add-and-mask --
    the TF32 kernel's own rounding of its activation
    (`csrc/hopper.cuh::round_tf32`), bit for bit."""
    i = t.view(torch.int32)
    return ((i + ((i >> 13) & 1) + 0xFFF) & -0x2000).view(torch.float32)


def k3_path(device_type: str, dtype: torch.dtype, allow_tf32: bool) -> str:
    """Which K3 a call runs: "plain" on the CPU; on CUDA "bf16" for bf16,
    and for fp32 "tf32" where `torch.backends.cudnn.allow_tf32` is set (the
    flag that sends cuDNN's fp32 convolutions to TF32), else "f32", the
    exact CUDA-core kernel."""
    if device_type != "cuda":
        return "plain"
    if dtype == torch.bfloat16:
        return "bf16"
    if dtype != torch.float32:
        raise TypeError(f"conv3x3: dtype {dtype} is not bf16 or fp32")
    return "tf32" if allow_tf32 else "f32"


# Which K4 a call runs: K3's rule, so that a float32 weight gradient takes
# TF32 exactly where the same conv's forward and data-grad do, as cuDNN's
# three do under the flag.
k4_path = k3_path


def _path(x: torch.Tensor) -> str:
    """The K3 and K4 path of a call on x, the flag read now."""
    return k3_path(x.device.type, x.dtype, torch.backends.cudnn.allow_tf32)


def _nhwc_padded(t: torch.Tensor, channels: int) -> torch.Tensor:
    """(B, C, H, W) -> contiguous (B, H, W, channels), zero-padded channels;
    no copy for a channels-last tensor that needs no padding (the fp32
    kernels' operands)."""
    th = t.permute(0, 2, 3, 1)
    c = t.shape[1]
    return F.pad(th, (0, channels - c)) if channels != c else th.contiguous()


def _tma_operand(t: torch.Tensor) -> torch.Tensor:
    """A (B, C, H, W) bf16 or fp32 tensor as the (B, H, W, C) view a TMA
    kernel reads: channels contiguous, other strides multiples of 16 bytes,
    16-byte aligned. A channels-last tensor whose C channels fill whole 16
    bytes is itself that view; anything else is copied into a
    `channels_stored(C)`-wide buffer, whose channels past C are never read."""
    th = t.permute(0, 2, 3, 1)
    per16 = 16 // t.element_size()
    if th.stride(3) == 1 and all(st % per16 == 0 for st in th.stride()[:3]) \
            and th.data_ptr() % 16 == 0:
        return th
    bsz, h, w, c = th.shape
    buf = torch.empty((bsz, h, w, channels_stored(c, t.element_size())), device=t.device,
                      dtype=t.dtype)
    buf[..., :c].copy_(th)
    return buf[..., :c]


def _weight_operand(w: torch.Tensor, dtype: torch.dtype, tf32: bool = False) -> torch.Tensor:
    """(O, C, 3, 3) -> (O, 3, 3, channels_stored(C)) in `dtype`, one copy;
    with `tf32` rounded to TF32 first."""
    if tf32:
        w = round_tf32(w.to(dtype))
    o, c = w.shape[:2]
    out = torch.empty((o, 3, 3, channels_stored(c, dtype.itemsize)), device=w.device,
                      dtype=dtype)
    out[..., :c].copy_(w.permute(0, 2, 3, 1))
    return out


def _strides(th: torch.Tensor) -> tuple[int, int, int]:
    """Pixel, row and image strides of a (B, H, W, C) view."""
    return th.stride(2), th.stride(1), th.stride(0)


def _conv(x, w, b, pad, counter, xh=None):
    """K3 for a CUDA tensor, the plain version for a CPU one; no autograd.
    `xh`: x as `_tma_operand` gives it, where the caller has it already."""
    path = _path(x)
    if path == "plain":
        return conv3x3_plain(x, w, b, pad)
    bsz, c, h, wd = x.shape
    o = w.shape[0]
    ho, wo = h + 2 * pad - 2, wd + 2 * pad - 2
    stream = _stream(x)
    if path in ("bf16", "tf32"):
        # TF32 is the bf16 design on fp32 operands, 32 channels a K step: the
        # weight is rounded to TF32 here, the activation in the kernel.
        tf32 = path == "tf32"
        p = k3_plan(bsz, h, wd, c, o, pad, _sm_count(x.device.index), x.element_size())
        xh = _tma_operand(x) if xh is None else xh
        wk = _weight_operand(w, x.dtype, tf32)
        # The bf16 kernel adds a bf16 bias as it is (it converts exactly),
        # any other in fp32.
        bias_bf16 = not tf32 and b is not None and b.dtype == torch.bfloat16
        bias = None if b is None else b.to(
            device=x.device, dtype=torch.bfloat16 if bias_bf16 else torch.float32).contiguous()
        ys = torch.empty((bsz, ho, wo, p.o_store), device=x.device, dtype=x.dtype)
        args = (xh.data_ptr(), wk.data_ptr(), None if bias is None else bias.data_ptr(),
                ys.data_ptr(), bsz, h, wd, c, *_strides(xh), wk.shape[3], o, p.o_store, pad,
                p.box_w, p.box_h, p.bn)
        if tf32:
            err = _build.library().jp_conv3x3_fwd_tf32(*args, stream)
            TF32_LAUNCHES[counter] += 1
        else:
            err = _build.library().jp_conv3x3_fwd_bf16(*args, int(bias_bf16), stream)
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
    _count(counter, x.dtype, bsz, h, wd, c, o, pad)
    return y


def _count(kernel: str, dtype: torch.dtype, n: int, h: int, w: int, c: int, o: int,
           pad: int) -> None:
    LAUNCHES[kernel] += 1
    SHAPES[(kernel, str(dtype).removeprefix("torch."), n, h, w, c, o, pad)] += 1


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
    if _path(x) != "f32":
        return _wgrad_tma(_tma_operand(x), g, pad)
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
    _count("conv3x3_wgrad", x.dtype, bsz, h, wd, c, o, pad)
    return out


def _wgrad_tma(xh: torch.Tensor, g: torch.Tensor, pad: int) -> torch.Tensor:
    """K4 on the tensor cores, bf16 or (fp32 operands) TF32, on x as
    `_tma_operand` gives it, (B, H, W, C); the cotangent is read through
    `_tma_operand` too."""
    bsz, h, wd, c = xh.shape
    o = g.shape[1]
    tf32 = xh.dtype == torch.float32
    p = k4_plan(bsz, h, wd, c, o, pad, _sm_count(xh.device.index), xh.element_size())
    gh = _tma_operand(g)
    out = torch.empty((o, c, 3, 3), device=xh.device, dtype=torch.float32)
    partial = torch.empty((p.splits, 9, _CHUNK * p.kchunks, p.bn * p.n_tiles),
                          device=xh.device, dtype=torch.float32)
    lib = _build.library()
    err = (lib.jp_conv3x3_wgrad_tf32 if tf32 else lib.jp_conv3x3_wgrad_bf16)(
        xh.data_ptr(), gh.data_ptr(), partial.data_ptr(), out.data_ptr(),
        bsz, h, wd, c, *_strides(xh), o, *_strides(gh), pad, p.box_w, p.box_h, p.bn,
        p.splits, p.tiles_per_split, p.flush_tiles, _stream(xh))
    _build.check(err, "conv3x3_wgrad")
    if tf32:
        TF32_LAUNCHES["conv3x3_wgrad"] += 1
    _count("conv3x3_wgrad", xh.dtype, bsz, h, wd, c, o, pad)
    return out


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, pad):
        ctx.pad = pad
        ctx.bias_dtype = None if b is None else b.dtype
        # bf16 and TF32 on the card: a copy made for TMA (the 513-channel
        # concat) is made once and saved instead of x; K4 on the tensor
        # cores reads it in the backward as it is.
        ctx.nhwc = _path(x) in ("bf16", "tf32")
        xh = _tma_operand(x) if ctx.nhwc else None
        ctx.save_for_backward(x if xh is None else xh, w)
        return _conv(x, w, b, pad, "conv3x3", xh)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        pad = ctx.pad
        dx = dw = db = None
        dtype = x.dtype
        if ctx.needs_input_grad[0]:
            # (O, C, ky, kx) -> (C, O, 2-ky, 2-kx): the data-grad is a conv,
            # on the path the flags give at this call.
            wt = w.flip(2, 3).transpose(0, 1)
            dx = _conv(g.to(dtype), wt.to(dtype), None, 2 - pad, "conv3x3_dgrad")
        if ctx.needs_input_grad[1]:
            gd = g.to(dtype)
            if ctx.nhwc and _path(x) != "f32":
                dw = _wgrad_tma(x, gd, pad)
            else:
                dw = conv3x3_wgrad(x.permute(0, 3, 1, 2) if ctx.nhwc else x, gd, pad)
            dw = dw.to(w.dtype)
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
