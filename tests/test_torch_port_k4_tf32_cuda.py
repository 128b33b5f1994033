"""K4's TF32 path on the card: the weight gradient of float32 operands on
the tensor cores, as cuDNN's fp32 convolution runs it.

Marked `cuda`: they skip without a CUDA device and run on the card with
`python -m pytest tests/test_torch_port_k4_tf32_cuda.py -m cuda`. Shapes:
every K3 site of the 1024^2 step (`chip_conv_sweep.py::SITES`, whose
weight gradients are K4's) at B = 1 and 3, and small shapes whose extents
leave tail tiles or whose channels leave part chunks, at pads 0 and 1.

Each case runs K4 through the conv's backward (the forward's saved TMA
operand, the cotangent as it arrives) and holds it to a float64 weight
gradient of the operands rounded as the kernel rounds them (`round_tf32`,
x and the cotangent both), two ways:

- elementwise, within (M + splits) * 2^-23 of the sum of the products'
  magnitudes, for M = B * Ho * Wo pixels: fp32 accumulation over M terms
  and the split sum, each add off by at most one unit in the last place
  (2^-23: the tensor cores may truncate their adds), in any order;
- at most 0.15 of the TF32 gap (the largest distance between the float64
  weight gradients of the rounded and of the exact operands): the
  accumulation's own error, while operands truncated instead of rounded
  read several times that (the test checks that its reference tells them
  apart).

Under `allow_tf32 = False` the call runs the exact CUDA-core kernel, bit
for bit its C entry point on the operands the wrapper always made. Two
calls give the same bits, a captured replay gives its eager call's bits,
and `tf32_launch_counts()["conv3x3_wgrad"]` counts each launch, exactly
under capture.
"""

import math

import pytest
import torch

from chip_conv_sweep import SITES
from jperceiver_tpu_torch.ops.cuda import (GraphLaunches, conv3x3_fwd, conv3x3_wgrad,
                                           launch_counts, reset_launch_counts,
                                           tf32_launch_counts)
from jperceiver_tpu_torch.ops.cuda import conv3x3 as k3
from jperceiver_tpu_torch.ops.cuda.conv3x3 import round_tf32

pytestmark = pytest.mark.cuda

# Tolerance in TF32 gaps (see the docstring).
GAPS = 0.15

# (B, c_in, c_out, H, W, pad): the step's sites at B = 1 and 3, then tail
# tiles and part chunks (513 channels: four pairs of whole chunks and one
# channel past them; 200: one pair and two part items; 136 -> 256 over two
# 128-wide output tiles; 40 -> 72: one part item, a part output tile).
CASES = [(bsz, c, o, e + 2 - 2 * pad, e + 2 - 2 * pad, pad)
         for bsz in (1, 3) for c, o, e, pad in SITES] + [
    (2, 8, 5, 19, 35, 0), (2, 8, 5, 19, 35, 1), (2, 40, 72, 21, 34, 1),
    (1, 16, 8, 70, 9, 1), (2, 513, 256, 11, 13, 0), (2, 200, 136, 18, 20, 1),
    (4, 136, 256, 34, 34, 0), (2, 72, 256, 34, 34, 1)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    flag, threads = torch.backends.cudnn.allow_tf32, torch.get_num_threads()
    torch.set_num_threads(1)
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = flag
    torch.set_num_threads(threads)


def _operands(dev, bsz, c, o, h, w, pad, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(bsz, c, h, w, device=dev, generator=g)
    x = x.contiguous(memory_format=torch.channels_last)
    wt = torch.randn(o, c, 3, 3, device=dev, generator=g) / math.sqrt(9 * c)
    gy = torch.randn(bsz, o, h + 2 * pad - 2, w + 2 * pad - 2, device=dev, generator=g)
    return x, wt, gy.contiguous(memory_format=torch.channels_last)


def _truncated(t):
    return (t.view(torch.int32) & -0x2000).view(torch.float32)


def _wgrad64(x, g, pad):
    """The plain version's nine contractions, in float64."""
    return torch.nn.grad.conv2d_weight(x.double(), (g.shape[1], x.shape[1], 3, 3), g.double(),
                                       padding=pad)


def _hold(dw, x, g, pad):
    """dw against float64 of the rounded operands, both ways."""
    xr, gr = round_tf32(x), round_tf32(g)
    ref = _wgrad64(xr, gr, pad)
    gap = (ref - _wgrad64(x, g, pad)).abs().max().item()
    mags = _wgrad64(xr.abs(), gr.abs(), pad)
    err = (dw.double() - ref).abs()
    plan = k3.k4_plan(x.shape[0], x.shape[2], x.shape[3], x.shape[1], g.shape[1], pad, elem=4)
    terms = g.shape[0] * g.shape[2] * g.shape[3] + plan.splits
    assert dw.shape == ref.shape and torch.isfinite(dw).all()
    assert (err <= terms * 2.0 ** -23 * mags).all()
    assert err.max().item() <= GAPS * gap
    trunc = _wgrad64(_truncated(x), _truncated(g), pad)
    assert (trunc - ref).abs().max().item() > 2 * GAPS * gap


@pytest.mark.parametrize("bsz,c,o,h,w,pad", CASES)
def test_k4_tf32_weight_grad(cuda, bsz, c, o, h, w, pad):
    """Through the conv's backward (the weight alone needs a gradient): K4
    on the forward's saved operand, on the TF32 path, counted once."""
    x, wt, gy = _operands(cuda, bsz, c, o, h, w, pad, c + o + h + pad)
    torch.backends.cudnn.allow_tf32 = True
    reset_launch_counts()
    wg = wt.clone().requires_grad_(True)
    conv3x3_fwd(x, wg, None, pad).backward(gy)
    torch.cuda.synchronize()
    assert tf32_launch_counts() == {"conv3x3": 1, "conv3x3_dgrad": 0, "conv3x3_wgrad": 1}
    assert launch_counts()["conv3x3_wgrad"] == 1
    _hold(wg.grad, x, gy, pad)


@pytest.mark.parametrize("bsz,c,o,h,w,pad", CASES[:len(SITES)] + CASES[2 * len(SITES):])
def test_k4_exact_path_without_tf32(cuda, bsz, c, o, h, w, pad):
    """allow_tf32 off: the CUDA-core kernel on the zero-padded channels-last
    operands and the wrapper's split, bit for bit; no TF32 launch."""
    x, _, gy = _operands(cuda, bsz, c, o, h, w, pad, c + o + h + pad + 1)
    torch.backends.cudnn.allow_tf32 = False
    reset_launch_counts()
    dw = conv3x3_wgrad(x, gy, pad)
    assert tf32_launch_counts() == {"conv3x3": 0, "conv3x3_dgrad": 0, "conv3x3_wgrad": 0}
    cp, op = -(-c // 64) * 64, -(-o // 64) * 64
    xh, gh = k3._nhwc_padded(x, cp), k3._nhwc_padded(gy, op)
    m = gy.shape[0] * gy.shape[2] * gy.shape[3]
    steps = -(-m // 32)
    splits = max(1, min(-(-4 * k3._sm_count(0) // (9 * cp * op // 4096)), steps // 16))
    chunk = -(-steps // splits) * 32
    splits = -(-m // chunk)
    part = torch.empty(splits, 9, cp, op, device=cuda)
    out = torch.empty(o, c, 3, 3, device=cuda)
    err = k3._build.library().jp_conv3x3_wgrad_f32(
        xh.data_ptr(), gh.data_ptr(), part.data_ptr(), out.data_ptr(), bsz, h, w, c, cp, o, op,
        pad, chunk, splits, k3._stream(x))
    k3._build.check(err, "conv3x3_wgrad")
    assert torch.equal(dw, out)


@pytest.mark.parametrize("bsz,c,o,h,w,pad", [CASES[0], CASES[len(SITES) - 1],
                                             CASES[2 * len(SITES) - 1],
                                             CASES[2 * len(SITES) + 4]])
def test_k4_tf32_repeats_and_replays(cuda, bsz, c, o, h, w, pad):
    """Two eager calls give the same bits; K4 captured in a graph replays
    its eager call's bits, and the TF32 count follows the replays."""
    x, _, gy = _operands(cuda, bsz, c, o, h, w, pad, 7)
    torch.backends.cudnn.allow_tf32 = True
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = conv3x3_wgrad(x, gy, pad).clone()
        again = conv3x3_wgrad(x, gy, pad)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(eager.view(torch.int32), again.view(torch.int32))
    graph, launches = torch.cuda.CUDAGraph(), GraphLaunches()
    reset_launch_counts()
    with launches.capture(), torch.cuda.graph(graph):
        out = conv3x3_wgrad(x, gy, pad)
    assert launches.per_replay_tf32 == {"conv3x3_wgrad": 1}
    assert tf32_launch_counts()["conv3x3_wgrad"] == 0
    for n in (1, 2):
        graph.replay()
        launches.replayed()
        torch.cuda.synchronize()
        assert torch.equal(out.view(torch.int32), eager.view(torch.int32))
        assert tf32_launch_counts() == {"conv3x3": 0, "conv3x3_dgrad": 0, "conv3x3_wgrad": n}
