"""K3's TF32 path on the card: the forward and the data-grad of float32
operands on the tensor cores, as cuDNN's fp32 convolution runs them.

Marked `cuda`: they skip without a CUDA device and run on the card with
`python -m pytest tests/test_torch_port_k3_tf32_cuda.py -m cuda`. Shapes:
every K3 site of the 1024^2 step (`chip_conv_sweep.py::SITES`) at B = 1
and 3, and small shapes whose extents leave tail tiles, at pads 0, 1 and 2.

Each case holds the TF32 kernel to a float64 `F.conv2d` of the operands
rounded as the kernel rounds them (`round_tf32`), two ways:

- elementwise, within 9C * 2^-23 of the sum of the products' magnitudes:
  fp32 accumulation over 9C terms, each add off by at most one unit in
  the last place (2^-23: the tensor cores may truncate their adds), in
  any order of summation, plus the bias's add;
- at most 0.15 of the TF32 gap (the largest distance between the
  float64 convolutions of the rounded and of the exact operands): the
  accumulation's own error, 0.046 of it at worst on the H100 at 513
  channels, while operands truncated instead of rounded read about one
  gap (the test checks that its reference tells them apart).

Under `allow_tf32 = False` the call runs the exact kernel as before, bit
for bit its C entry point on the operands the wrapper always made; a
captured replay gives its eager call's bits; `tf32_launch_counts()`
counts each launch, exactly under capture.
"""

import math

import pytest
import torch
import torch.nn.functional as F

from chip_conv_sweep import SITES
from jperceiver_tpu_torch.ops.cuda import (GraphLaunches, conv3x3_fwd, launch_counts,
                                           reset_launch_counts, tf32_launch_counts)
from jperceiver_tpu_torch.ops.cuda import conv3x3 as k3
from jperceiver_tpu_torch.ops.cuda.conv3x3 import round_tf32

pytestmark = pytest.mark.cuda

# Tolerance in TF32 gaps (see the docstring).
GAPS = 0.15

# (B, c_in, c_out, H, W, pad): the step's sites at B = 1 and 3, then tail tiles.
CASES = [(bsz, c, o, e + 2 - 2 * pad, e + 2 - 2 * pad, pad)
         for bsz in (1, 3) for c, o, e, pad in SITES] + [
    (2, 8, 5, 19, 35, 0), (2, 8, 5, 19, 35, 1), (2, 8, 5, 19, 35, 2),
    (2, 40, 72, 21, 34, 1), (2, 72, 40, 23, 36, 2), (1, 16, 8, 70, 9, 1),
    (2, 513, 256, 11, 13, 0), (2, 256, 513, 9, 10, 2)]


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
    b = torch.randn(o, device=dev, generator=g)
    gy = torch.randn(bsz, o, h + 2 * pad - 2, w + 2 * pad - 2, device=dev, generator=g)
    return x, wt, b, gy.contiguous(memory_format=torch.channels_last)


def _truncated(t):
    return (t.view(torch.int32) & -0x2000).view(torch.float32)


def _hold(y, x, w, b, pad):
    """y against float64 of the rounded operands, both ways."""
    xr, wr = round_tf32(x).double(), round_tf32(w).double()
    bd = None if b is None else b.double()
    ref = F.conv2d(xr, wr, bd, padding=pad)
    gap = (ref - F.conv2d(x.double(), w.double(), bd, padding=pad)).abs().max().item()
    mags = F.conv2d(xr.abs(), wr.abs(), None if b is None else bd.abs(), padding=pad)
    err = (y.double() - ref).abs()
    terms = 9 * x.shape[1] + 1
    assert y.shape == ref.shape and torch.isfinite(y).all()
    assert (err <= terms * 2.0 ** -23 * mags).all()
    assert err.max().item() <= GAPS * gap
    trunc = F.conv2d(_truncated(x).double(), _truncated(w).double(), bd, padding=pad)
    assert (trunc - ref).abs().max().item() > 2 * GAPS * gap


@pytest.mark.parametrize("bsz,c,o,h,w,pad", CASES)
def test_k3_tf32_forward_and_data_grad(cuda, bsz, c, o, h, w, pad):
    x, wt, b, gy = _operands(cuda, bsz, c, o, h, w, pad, c + o + h + pad)
    torch.backends.cudnn.allow_tf32 = True
    reset_launch_counts()
    xg = x.clone().requires_grad_(True)
    y = conv3x3_fwd(xg, wt, b, pad)
    y.backward(gy)
    torch.cuda.synchronize()
    assert tf32_launch_counts() == {"conv3x3": 1, "conv3x3_dgrad": 1, "conv3x3_wgrad": 0}
    assert launch_counts()["conv3x3"] == launch_counts()["conv3x3_dgrad"] == 1
    _hold(y.detach(), x, wt, b, pad)
    # The data-grad: K3 on the cotangent at pad 2 - pad with the flipped,
    # transposed weight, both rounded as the gradient reaching cuDNN's
    # backward is.
    _hold(xg.grad, gy, wt.flip(2, 3).transpose(0, 1), None, 2 - pad)


@pytest.mark.parametrize("bsz,c,o,h,w,pad", CASES[:len(SITES)] + CASES[2 * len(SITES):])
def test_k3_exact_path_without_tf32(cuda, bsz, c, o, h, w, pad):
    """allow_tf32 off: the CUDA-core kernel on the zero-padded channels-last
    operands, bit for bit, as the forward and as the data-grad; no TF32
    launch."""
    x, wt, b, gy = _operands(cuda, bsz, c, o, h, w, pad, c + o + h + pad + 1)
    torch.backends.cudnn.allow_tf32 = False
    reset_launch_counts()
    y = conv3x3_fwd(x, wt, b, pad)
    dx = k3._conv(gy, wt.flip(2, 3).transpose(0, 1), None, 2 - pad, "conv3x3_dgrad")
    assert tf32_launch_counts() == {"conv3x3": 0, "conv3x3_dgrad": 0, "conv3x3_wgrad": 0}

    def f32k(x, w, b, pad):
        cp = -(-x.shape[1] // 32) * 32
        xh, wk = k3._nhwc_padded(x, cp), k3._nhwc_padded(w, cp)
        bsz, _, h, wd = x.shape
        out = torch.empty((bsz, w.shape[0], h + 2 * pad - 2, wd + 2 * pad - 2), device=x.device,
                          memory_format=torch.channels_last)
        err = k3._build.library().jp_conv3x3_fwd_f32(
            xh.data_ptr(), wk.data_ptr(), None if b is None else b.data_ptr(), out.data_ptr(),
            bsz, h, wd, cp, w.shape[0], pad, k3._stream(x))
        k3._build.check(err, "conv3x3")
        return out

    assert torch.equal(y, f32k(x, wt, b, pad))
    assert torch.equal(dx, f32k(gy, wt.flip(2, 3).transpose(0, 1), None, 2 - pad))


@pytest.mark.parametrize("bsz,c,o,h,w,pad", [CASES[0], CASES[len(SITES) - 1],
                                             CASES[2 * len(SITES) + 2]])
def test_k3_tf32_captured_replay_is_eager(cuda, bsz, c, o, h, w, pad):
    """The forward and the data-grad captured in one graph replay their
    eager call's bits, and the TF32 count follows the replays."""
    x, wt, b, gy = _operands(cuda, bsz, c, o, h, w, pad, 7)
    wf = wt.flip(2, 3).transpose(0, 1)
    torch.backends.cudnn.allow_tf32 = True

    def body():
        return (k3._conv(x, wt, b, pad, "conv3x3"),
                k3._conv(gy, wf, None, 2 - pad, "conv3x3_dgrad"))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = [t.clone() for t in body()]
    torch.cuda.current_stream().wait_stream(side)
    graph, launches = torch.cuda.CUDAGraph(), GraphLaunches()
    reset_launch_counts()
    with launches.capture(), torch.cuda.graph(graph):
        out = body()
    assert launches.per_replay_tf32 == {"conv3x3": 1, "conv3x3_dgrad": 1}
    assert tf32_launch_counts() == {"conv3x3": 0, "conv3x3_dgrad": 0, "conv3x3_wgrad": 0}
    for n in (1, 2):
        graph.replay()
        launches.replayed()
        torch.cuda.synchronize()
        assert torch.equal(out[0], eager[0]) and torch.equal(out[1], eager[1])
        assert tf32_launch_counts() == {"conv3x3": n, "conv3x3_dgrad": n, "conv3x3_wgrad": 0}
