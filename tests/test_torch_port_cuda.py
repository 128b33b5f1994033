"""The port's CUDA kernels against their plain versions, on a GPU.

Marked `cuda`: they skip where no CUDA device is present, and run on the
card with `python -m pytest tests/test_torch_port_cuda.py -m cuda`.
`chip_smoke.py` checks the same kernels at the full-size shapes.
"""

import math

import pytest
import torch

from jperceiver_tpu_torch.ops.cuda import (conv3x3_fwd, conv3x3_plain,
                                           launch_counts, maxpool5x5_fwd,
                                           maxpool5x5_plain,
                                           reset_launch_counts)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,o", [(8, 5), (64, 64), (513, 256), (40, 72)])
@pytest.mark.parametrize("pad", [0, 1])
@pytest.mark.parametrize("channels_last", [True, False])
def test_conv3x3_kernel(cuda, dtype, c, o, pad, channels_last):
    g = torch.Generator(device=cuda).manual_seed(c + o + pad)
    x = torch.randn(2, c, 19, 35, device=cuda, generator=g).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    w = (torch.randn(o, c, 3, 3, device=cuda, generator=g) / math.sqrt(9 * c)).to(dtype)
    b = torch.randn(o, device=cuda, generator=g).to(dtype)
    reset_launch_counts()
    y = conv3x3_fwd(x, w, b, pad)
    assert launch_counts()["conv3x3"] == 1
    ref = conv3x3_plain(x, w, b, pad)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == ref.shape
    scale = max(1.0, ref.float().abs().max().item())
    tol = (1e-4 if dtype == torch.float32 else 1e-2) * scale
    assert (y.float() - ref.float()).abs().max().item() <= tol
    y0 = conv3x3_fwd(x, w, None, pad)
    ref0 = conv3x3_plain(x, w, None, pad)
    assert (y0.float() - ref0.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [256, 13, 4])
def test_maxpool5x5_kernel_bit_exact(cuda, dtype, c):
    g = torch.Generator(device=cuda).manual_seed(c)
    x = torch.relu(torch.round(4 * torch.randn(2, c, 17, 30, device=cuda,
                                               generator=g)) / 4).to(dtype)
    reset_launch_counts()
    y = maxpool5x5_fwd(x)
    assert launch_counts()["maxpool5x5"] == 1
    assert torch.equal(y, maxpool5x5_plain(x))
    assert torch.equal(y, torch.nn.functional.max_pool2d(x, 5, 1, 2))


def test_eval_step_kernels_on_off(cuda):
    from jperceiver_tpu_torch.data import synthetic_batch
    from jperceiver_tpu_torch.engine import make_eval_step
    from jperceiver_tpu_torch.models import JPerceiver, set_kernels

    torch.manual_seed(0)
    model = JPerceiver(occ_map_size=64)
    step = make_eval_step(model)
    batch = synthetic_batch(1, 256, 256)
    reset_launch_counts()
    on = step(batch)
    counts = launch_counts()
    assert counts["conv3x3"] > 0 and counts["maxpool5x5"] == 16
    set_kernels(model, False, False, False)
    off = step(batch)
    for k in on:
        scale = max(1.0, off[k].abs().max().item())
        assert (on[k] - off[k]).abs().max().item() <= 1e-3 * scale, k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,o,pad", [(64, 64, 1), (513, 256, 0), (40, 72, 1), (128, 8, 0)])
def test_conv3x3_backward_kernels(cuda, dtype, c, o, pad):
    """K3 as the data-grad (at pad 2 - pad; 513 output channels for the
    iconv) and K4 against their plain versions, through the autograd
    Function."""
    from jperceiver_tpu_torch.ops.cuda import conv3x3_plain, conv3x3_wgrad_plain

    g = torch.Generator(device=cuda).manual_seed(c + o)
    x = torch.randn(2, c, 21, 34, device=cuda, generator=g).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_()
    w = (torch.randn(o, c, 3, 3, device=cuda, generator=g) / math.sqrt(9 * c)).to(dtype)
    w.requires_grad_()
    b = torch.randn(o, device=cuda, generator=g).to(dtype).requires_grad_()
    y = conv3x3_fwd(x, w, b, pad)
    gy = torch.randn(y.shape, device=cuda, generator=g).to(dtype)
    reset_launch_counts()
    y.backward(gy)
    counts = launch_counts()
    assert counts["conv3x3_dgrad"] == 1 and counts["conv3x3_wgrad"] == 1
    dx_ref = conv3x3_plain(gy, w.detach().flip(2, 3).transpose(0, 1), None, 2 - pad)
    dw_ref = conv3x3_wgrad_plain(x.detach(), gy, pad)
    torch.cuda.synchronize()
    assert x.grad.dtype == w.grad.dtype == b.grad.dtype == dtype
    scale = max(1.0, dx_ref.float().abs().max().item())
    tol = (1e-4 if dtype == torch.float32 else 1e-2) * scale
    assert (x.grad.float() - dx_ref.float()).abs().max().item() <= tol
    # K4 sums in fp32 in another order; the bf16 result is one rounding of it.
    wtol = (1e-4 if dtype == torch.float32 else 1e-2) * dw_ref.abs().max().item()
    assert (w.grad.float() - dw_ref).abs().max().item() <= wtol
    torch.testing.assert_close(b.grad.float(), gy.float().sum((0, 2, 3)), rtol=1e-2, atol=1e-2)


# (B, C, O, H, W, pad) of the bf16 kernels' tile paths (the fp32 kernels run
# them too): a width that is not a multiple of the 128-pixel box, so tail
# tiles run; W = 64 (the 64x2 box) and W < 64; pad 2 with 513 outputs (the
# iconv's data-grad, stored 576 wide); C = 544 (half a channel chunk) and
# 576; B = 2, so boxes meet the image edge; O = 8, below one wgmma n-tile.
_TILE_CASES = [(1, 64, 64, 9, 200, 1), (1, 64, 64, 64, 64, 1), (1, 16, 24, 40, 40, 1),
               (1, 256, 513, 18, 20, 2), (1, 544, 64, 12, 30, 0), (1, 576, 64, 12, 30, 1),
               (2, 64, 64, 20, 33, 1), (1, 64, 8, 16, 40, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,o,h,w,pad", _TILE_CASES)
def test_conv3x3_tile_paths(cuda, dtype, b, c, o, h, w, pad):
    """K3 forward, K3 as the data-grad (pad 2 - pad) and K4 against their
    plain versions at shapes that reach each tile path."""
    from jperceiver_tpu_torch.ops.cuda import conv3x3_wgrad, conv3x3_wgrad_plain
    from jperceiver_tpu_torch.ops.cuda.conv3x3 import _conv

    g = torch.Generator(device=cuda).manual_seed(c + o + pad)
    x = torch.randn(b, c, h, w, device=cuda, generator=g).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    wt = (torch.randn(o, c, 3, 3, device=cuda, generator=g) / math.sqrt(9 * c)).to(dtype)
    bias = torch.randn(o, device=cuda, generator=g).to(dtype)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    reset_launch_counts()
    y = conv3x3_fwd(x, wt, bias, pad)
    ref = conv3x3_plain(x, wt, bias, pad)
    torch.cuda.synchronize()
    assert y.shape == ref.shape and y.dtype == dtype
    assert (y.float() - ref.float()).abs().max().item() <= tol * max(1.0, ref.float().abs().max().item())
    gy = torch.randn(y.shape, device=cuda, generator=g).to(dtype)
    wflip = wt.flip(2, 3).transpose(0, 1)
    dx = _conv(gy, wflip, None, 2 - pad, "conv3x3_dgrad")
    dx_ref = conv3x3_plain(gy, wflip, None, 2 - pad)
    dw = conv3x3_wgrad(x, gy, pad)
    dw_ref = conv3x3_wgrad_plain(x, gy, pad)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert (counts["conv3x3"], counts["conv3x3_dgrad"], counts["conv3x3_wgrad"]) == (1, 1, 1)
    assert dx.shape == x.shape
    assert (dx.float() - dx_ref.float()).abs().max().item() <= tol * max(
        1.0, dx_ref.float().abs().max().item())
    # K4's result is fp32 in both dtypes: fp32 sums in another order.
    assert dw.shape == (o, c, 3, 3) and dw.dtype == torch.float32
    assert (dw - dw_ref).abs().max().item() <= 1e-4 * dw_ref.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_wgrad_splits_and_repeats_bit_for_bit(cuda, dtype):
    """A K4 problem whose pixels the plan splits, run twice: the same bits,
    and the plain version's values."""
    from jperceiver_tpu_torch.ops.cuda import conv3x3_wgrad, conv3x3_wgrad_plain
    from jperceiver_tpu_torch.ops.cuda.conv3x3 import _sm_count, k4_plan

    assert k4_plan(2, 64, 96, 128, 128, 1, _sm_count(cuda.index or 0)).splits > 1
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(2, 128, 64, 96, device=cuda, generator=g).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    gy = torch.randn(2, 128, 64, 96, device=cuda, generator=g).to(dtype)
    gy = gy.contiguous(memory_format=torch.channels_last)
    a = conv3x3_wgrad(x, gy, 1)
    b = conv3x3_wgrad(x, gy, 1)
    ref = conv3x3_wgrad_plain(x, gy, 1)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert (a - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


def test_conv3x3_wgrad_long_chains_at_b8(cuda):
    """K4 at the step's widest site, 513 -> 256 @ 256^2, at B = 8, where a
    split sums the most tiles: within its gate (1e-4 of the largest |dW|)
    and the same bits twice. Before the second-level sum the accumulator's
    own adds took this site past the gate from B = 4 on."""
    from jperceiver_tpu_torch.ops.cuda import conv3x3_wgrad, conv3x3_wgrad_plain

    g = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn(8, 513, 258, 258, device=cuda, generator=g).bfloat16()
    x = x.contiguous(memory_format=torch.channels_last)
    gy = torch.randn(8, 256, 256, 256, device=cuda, generator=g).bfloat16()
    gy = gy.contiguous(memory_format=torch.channels_last)
    a = conv3x3_wgrad(x, gy, 0)
    b = conv3x3_wgrad(x, gy, 0)
    ref = conv3x3_wgrad_plain(x, gy, 0)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert (a - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


# (C, O, output extent, pad) of step sites whose K4 plan at B = 3 splits the
# pixels (3 and 14 splits).
_K4_B3_SITES = [(256, 256, 64, 1), (128, 128, 128, 1)]


@pytest.mark.parametrize("c,o,e,pad", _K4_B3_SITES)
def test_conv3x3_wgrad_b3_bit_for_bit(cuda, c, o, e, pad):
    """K4 at the preset fit's B = 3 at a step site whose plan splits the
    pixels: the same bits in two runs, and the plain version's values."""
    from jperceiver_tpu_torch.ops.cuda import conv3x3_wgrad, conv3x3_wgrad_plain
    from jperceiver_tpu_torch.ops.cuda.conv3x3 import _sm_count, k4_plan

    hin = e + 2 - 2 * pad
    assert k4_plan(3, hin, hin, c, o, pad, _sm_count(cuda.index or 0)).splits > 1
    g = torch.Generator(device=cuda).manual_seed(c + e)
    x = torch.randn(3, c, hin, hin, device=cuda, generator=g).bfloat16()
    x = x.contiguous(memory_format=torch.channels_last)
    gy = torch.randn(3, o, e, e, device=cuda, generator=g).bfloat16()
    gy = gy.contiguous(memory_format=torch.channels_last)
    a = conv3x3_wgrad(x, gy, pad)
    b = conv3x3_wgrad(x, gy, pad)
    ref = conv3x3_wgrad_plain(x, gy, pad)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert (a - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


def test_conv3x3_wgrad_f64_distance_at_the_widest_site(cuda):
    """K4 at 513 -> 256 @ 256^2, B = 3: its largest distance to float64
    (cuDNN in fp64 on the same bf16 inputs) within 1.3x the plain
    version's: the second fp32 sum keeps the long pixel chains about as
    close as fp32 adds rounded to nearest."""
    from jperceiver_tpu_torch.ops.cuda import conv3x3_wgrad, conv3x3_wgrad_plain

    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(3, 513, 258, 258, device=cuda, generator=g).bfloat16()
    x = x.contiguous(memory_format=torch.channels_last)
    gy = torch.randn(3, 256, 256, 256, device=cuda, generator=g).bfloat16()
    gy = gy.contiguous(memory_format=torch.channels_last)
    dw = conv3x3_wgrad(x, gy, 0)
    ref = conv3x3_wgrad_plain(x, gy, 0)
    dw64 = torch.nn.grad.conv2d_weight(x.double(), dw.shape, gy.double(), padding=0)
    err = (dw.double() - dw64).abs().max().item()
    plain_err = (ref.double() - dw64).abs().max().item()
    assert err <= 1.3 * plain_err


def test_conv3x3_wgrad_refuses_without_fallback(cuda):
    """A bf16 shape that K4's plan refuses (no output pixel) raises on the
    card, and nothing runs in the kernel's place."""
    from jperceiver_tpu_torch.ops.cuda import conv3x3_wgrad

    x = torch.zeros(1, 64, 2, 2, device=cuda, dtype=torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    gy = torch.zeros(1, 64, 0, 0, device=cuda, dtype=torch.bfloat16)
    reset_launch_counts()
    with pytest.raises(ValueError):
        conv3x3_wgrad(x, gy, 0)
    assert launch_counts()["conv3x3_wgrad"] == 0


@pytest.mark.parametrize("f", [2, 3])
@pytest.mark.parametrize("dtype,b", [(torch.float32, 1), (torch.bfloat16, 1),
                                     (torch.bfloat16, 2), (torch.float32, 3)])
@pytest.mark.parametrize("h,w", [(37, 45), (2, 3)])
def test_reproj_kernels(cuda, dtype, b, h, w, f):
    """K1 and K2 (routed by K1's code) against their plain versions, with
    exact frame ties (frame 1 copies frame 0 on the left half, frame 2 on
    the top half) and sizes that cut tiles and reach the reflect ring and
    corners of every tile. Pixel values are 8-bit levels k/256, so the SSIM
    window sums are exact in both versions (on arbitrary fp32 values,
    low-variance windows make the gradient depend on their order)."""
    from jperceiver_tpu_torch.ops.cuda import reproj_min, reproj_min_plain
    from jperceiver_tpu_torch.ops.cuda.reproj import _reproj_bwd_plain

    g = torch.Generator(device=cuda).manual_seed(b + h + 100 * (f - 2))
    preds = torch.round(256 * torch.rand(2, b, f, 3, h, w, device=cuda, generator=g)) / 256
    preds[:, :, 1, ..., : w // 2] = preds[:, :, 0, ..., : w // 2]
    if f > 2:
        preds[:, :, 2, :, : h // 2] = preds[:, :, 0, :, : h // 2]
    preds = preds.to(dtype).requires_grad_()
    targ = (torch.round(256 * torch.rand(b, 3, h, w, device=cuda, generator=g)) / 256).to(dtype)
    cot = torch.randn(2, b, h, w, device=cuda, generator=g)
    reset_launch_counts()
    out = reproj_min(preds, targ)
    out.backward(cot)
    assert launch_counts()["reproj_fwd"] == 1 and launch_counts()["reproj_bwd"] == 1
    ref = reproj_min_plain(preds.detach(), targ)
    dref = _reproj_bwd_plain(preds.detach(), targ, cot)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and preds.grad.dtype == dtype
    assert (out - ref).abs().max().item() <= 2e-5
    tol = (1e-4 if dtype == torch.float32 else 1e-2) * dref.float().abs().max().item()
    assert (preds.grad.float() - dref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("f", [2, 3])
@pytest.mark.parametrize("dtype,b", [(torch.float32, 1), (torch.bfloat16, 1),
                                     (torch.bfloat16, 2)])
@pytest.mark.parametrize("h,w", [(37, 45), (70, 100)])
def test_reproj_automask_kernels(cuda, dtype, b, h, w, f):
    """The fused K1 (warped frames and identity frames in one launch)
    against its plain versions on both outputs, and K2 on the fused launch's
    routing code against its plain version; B = 2 in bf16 was a TPU compiler
    fault (ROADMAP, K2). 8-bit levels and exact frame ties, as in
    `test_reproj_kernels`; 70 x 100 takes 32-row tiles' edges too."""
    from jperceiver_tpu_torch.ops.cuda import reproj_min_automask, reproj_min_plain
    from jperceiver_tpu_torch.ops.cuda.reproj import _reproj_bwd_plain

    g = torch.Generator(device=cuda).manual_seed(b + h + 10 * f)
    preds = torch.round(256 * torch.rand(4, b, f, 3, h, w, device=cuda, generator=g)) / 256
    preds[:, :, 1, ..., : w // 2] = preds[:, :, 0, ..., : w // 2]
    if f > 2:
        preds[:, :, 2, :, : h // 2] = preds[:, :, 0, :, : h // 2]
    preds = preds.to(dtype).requires_grad_()
    ident = (torch.round(256 * torch.rand(f, b, 3, h, w, device=cuda, generator=g)) / 256).to(dtype)
    targ = (torch.round(256 * torch.rand(b, 3, h, w, device=cuda, generator=g)) / 256).to(dtype)
    cot = torch.randn(4, b, h, w, device=cuda, generator=g)
    reset_launch_counts()
    out, ident_l = reproj_min_automask(preds, ident, targ)
    assert not ident_l.requires_grad and out.requires_grad
    out.backward(cot)
    assert launch_counts()["reproj_fwd"] == 1 and launch_counts()["reproj_bwd"] == 1
    ref = reproj_min_plain(preds.detach(), targ)
    ref_ident = reproj_min_plain(ident[:, :, None], targ)
    dref = _reproj_bwd_plain(preds.detach(), targ, cot)
    torch.cuda.synchronize()
    assert out.shape == (4, b, h, w) and ident_l.shape == (f, b, h, w)
    assert (out - ref).abs().max().item() <= 2e-5
    assert (ident_l - ref_ident).abs().max().item() <= 2e-5
    tol = (1e-4 if dtype == torch.float32 else 1e-2) * dref.float().abs().max().item()
    assert (preds.grad.float() - dref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reproj_tie_halves_the_cotangent(cuda, dtype):
    """Two identical frames: K1's code marks every pixel a tie, and K2 gives
    each frame exactly half of what the single frame gets; the forward
    without a gradient writes no code and K2 is not launched."""
    from jperceiver_tpu_torch.ops.cuda import reproj_min
    from jperceiver_tpu_torch.ops.cuda.reproj import _fwd

    g = torch.Generator(device=cuda).manual_seed(11)
    one = torch.rand(2, 1, 1, 3, 40, 70, device=cuda, generator=g).to(dtype)
    targ = torch.rand(1, 3, 40, 70, device=cuda, generator=g).to(dtype)
    cot = torch.randn(2, 1, 40, 70, device=cuda, generator=g)
    two = one.expand(2, 1, 2, 3, 40, 70).contiguous().requires_grad_()
    one = one.clone().requires_grad_()
    reproj_min(two, targ).backward(cot)
    reproj_min(one, targ).backward(cot)
    _, code, _ = _fwd(two.detach(), targ, route=True)
    assert torch.equal(code, torch.full_like(code, 2))
    assert torch.equal(two.grad[:, :, 0], two.grad[:, :, 1])
    assert torch.equal(2 * two.grad[:, :, 0].float(), one.grad[:, :, 0].float())
    reset_launch_counts()
    with torch.no_grad():
        _, none, _ = _fwd(two.detach(), targ, route=False)
        reproj_min(two, targ)
    assert none is None and launch_counts()["reproj_bwd"] == 0


@pytest.mark.parametrize("cot_channels_last", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [256, 13, 4])
def test_maxpool5x5_backward_kernel_bit_exact(cuda, dtype, c, cot_channels_last):
    """`maxpool5x5_bwd` against the plain backward, bit for bit, on inputs
    with ties; through autograd one launch a direction, and a cotangent that
    is not channels-last copied once and counted."""
    from jperceiver_tpu_torch.ops.cuda import (maxpool5x5, maxpool5x5_bwd,
                                               maxpool5x5_bwd_plain)

    g = torch.Generator(device=cuda).manual_seed(c + 1)
    x = torch.relu(torch.round(4 * torch.randn(2, c, 37, 70, device=cuda,
                                               generator=g)) / 4).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_()
    cot = torch.randn(2, c, 37, 70, device=cuda, generator=g).to(dtype)
    if cot_channels_last:
        cot = cot.contiguous(memory_format=torch.channels_last)
    reset_launch_counts()
    y = maxpool5x5(x)
    y.backward(cot)
    counts = launch_counts()
    assert (counts["maxpool5x5"], counts["maxpool5x5_bwd"]) == (1, 1)
    assert counts["maxpool5x5_bwd_cot_copy"] == (0 if cot_channels_last else 1)
    ref = maxpool5x5_bwd_plain(x.detach(), y.detach(), cot)
    torch.cuda.synchronize()
    assert x.grad.dtype == dtype and torch.equal(x.grad, ref)
    assert torch.equal(maxpool5x5_bwd(x.detach(), y.detach(), cot), ref)


def test_kernel_routed_blocks_reach_every_parameter(cuda):
    """A backward through a K3-routed `Conv3x3` and a K5-routed `CRPBlock`
    (the pool's backward kernel too) reaches every parameter and the input, as the routing through cuDNN and
    the plain pool does. Compared in the L2 norm of each gradient, to 1e-2:
    where two values of a pool window lie within the rounding of K3 against
    cuDNN, the max changes place between the routings, which moves a few
    elements of the cotangent whole (measured on the H100: 1e-3 of the norm
    of the conv weight's gradient)."""
    from jperceiver_tpu_torch.models.common import Conv3x3, CRPBlock, set_kernels

    torch.manual_seed(0)
    net = torch.nn.Sequential(Conv3x3(64, 64), CRPBlock(64)).to(cuda)
    x = torch.randn(1, 64, 128, 128, device=cuda).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    grads = {}
    for on in (True, False):
        set_kernels(net, on, on, on)
        net.zero_grad()
        x.grad = None
        reset_launch_counts()
        net(x).square().mean().backward()
        counts = launch_counts()
        assert (counts["conv3x3"], counts["conv3x3_dgrad"], counts["conv3x3_wgrad"],
                counts["maxpool5x5"], counts["maxpool5x5_bwd"]) == (
                    (1, 1, 1, 4, 4) if on else (0, 0, 0, 0, 0))
        grads[on] = [p.grad.clone() for p in net.parameters()] + [x.grad.clone()]
    for i, (a, ref) in enumerate(zip(grads[True], grads[False])):
        assert torch.isfinite(a).all() and ref.norm() > 0
        assert (a - ref).norm().item() <= 1e-2 * ref.norm().item(), i


@pytest.mark.parametrize("cot_channels_last", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,h,w", [(64, 36, 70), (13, 17, 23), (64, 96, 320)])
def test_maxpool3x3s2_backward_kernel_bit_exact(cuda, dtype, c, h, w, cot_channels_last):
    """`maxpool3x3s2_bwd` against the plain backward, bit for bit, on inputs
    with ties, at even and odd sizes; through autograd one launch, and a
    cotangent that is not channels-last copied once and counted."""
    from jperceiver_tpu_torch.ops.cuda import (maxpool3x3s2, maxpool3x3s2_bwd,
                                               maxpool3x3s2_bwd_plain)

    g = torch.Generator(device=cuda).manual_seed(c + h)
    x = torch.relu(torch.round(4 * torch.randn(2, c, h, w, device=cuda, generator=g)) / 4)
    x = x.to(dtype).contiguous(memory_format=torch.channels_last).requires_grad_()
    y = maxpool3x3s2(x)
    cot = torch.randn(y.shape, device=cuda, generator=g).to(dtype)
    if cot_channels_last:
        cot = cot.contiguous(memory_format=torch.channels_last)
    reset_launch_counts()
    y.backward(cot)
    counts = launch_counts()
    assert counts["maxpool3x3s2_bwd"] == 1
    assert counts["maxpool3x3s2_bwd_cot_copy"] == (0 if cot_channels_last else 1)
    ref = maxpool3x3s2_bwd_plain(x.detach(), y.detach(), cot)
    torch.cuda.synchronize()
    assert x.grad.dtype == dtype and torch.equal(x.grad, ref)
    assert torch.equal(maxpool3x3s2_bwd(x.detach(), y.detach(), cot), ref)
    # With the kernel off the plain backward runs: no launch.
    x.grad = None
    reset_launch_counts()
    maxpool3x3s2(x, False).backward(cot)
    assert launch_counts()["maxpool3x3s2_bwd"] == 0 and torch.equal(x.grad, ref)


def _twice(fn):
    """fn() run twice; each time its result's tensors cloned."""
    return [[t.detach().clone() for t in fn()] for _ in range(2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reflect_pad_backward_repeats_bit_for_bit(cuda, dtype):
    """`reflect_pad`'s backward at a decoder's size: the same gradient from
    two runs, equal to the CPU's in float64 to fp32 (bf16) rounding."""
    from jperceiver_tpu_torch.ops.padding import reflect_pad

    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(3, 64, 256, 256, device=cuda, generator=g).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_()
    cot = torch.randn(3, 64, 258, 258, device=cuda, generator=g).to(dtype)
    a, b = _twice(lambda: torch.autograd.grad(reflect_pad(x), x, cot))
    assert torch.equal(a[0], b[0])
    x64 = x.detach().cpu().double().requires_grad_()
    (ref,) = torch.autograd.grad(torch.nn.functional.pad(x64, (1,) * 4, mode="reflect"), x64,
                                 cot.cpu().double())
    eps = 2.0 ** -24 if dtype == torch.float32 else 2.0 ** -8
    assert (a[0].cpu().double() - ref).abs().max().item() <= 4 * eps * ref.abs().max().item()


@pytest.mark.parametrize("size", [(128, 128), (256, 256), (512, 512), (375, 1242)])
def test_resize_bilinear_backward_repeats_bit_for_bit(cuda, size):
    """The disparity upsampling (x8, x4, x2 to 1024^2) and the CGT label's
    resize, fp32: the same gradient from two runs, within 4x the gradient of
    `F.interpolate` on the card from the float64 one."""
    from jperceiver_tpu_torch.ops.sampling import resize_bilinear

    src = (1024, 1024) if size == (375, 1242) else size
    dst = size if size == (375, 1242) else (1024, 1024)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.rand(3, 1, *src, device=cuda, generator=g).requires_grad_()
    cot = torch.randn(3, 1, *dst, device=cuda, generator=g)
    a, b = _twice(lambda: torch.autograd.grad(resize_bilinear(x, *dst), x, cot))
    assert torch.equal(a[0], b[0])

    def interp(t):
        return torch.nn.functional.interpolate(t, size=dst, mode="bilinear",
                                               align_corners=False, antialias=True)

    (lib,) = torch.autograd.grad(interp(x), x, cot)
    x64 = x.detach().double().requires_grad_()
    (ref,) = torch.autograd.grad(interp(x64), x64, cot.double())
    scale = ref.abs().max().item()
    err, err_lib = ((t.double() - ref).abs().max().item() for t in (a[0], lib))
    assert err <= 4 * err_lib + 4 * 2.0 ** -24 * scale


def test_fp32_train_step_repeats_bit_for_bit(cuda):
    """The flagship step in fp32 at 256^2 (road branch, kernels on, fp32
    reprojection operands), twice from the same state: every gradient and
    the weights after the step bit for bit."""
    import copy

    from jperceiver_tpu_torch.data import synthetic_batch
    from jperceiver_tpu_torch.engine import make_train_step
    from jperceiver_tpu_torch.models import JPerceiver, set_kernels

    h = 256
    torch.manual_seed(0)
    model = JPerceiver(height=h, width=h, occ_map_size=h // 4, branches="road")
    init = copy.deepcopy(model.state_dict())
    cfg = dict(type="static", split="odometry", frame_ids=[0, -1, 1], scales=[0, 1, 2, 3],
               height=h, width=h, occ_map_size=h // 4, num_class=2, min_depth=0.1,
               max_depth=100.0, automask=True, disp_norm=True, loss_type="iou", loss_sum=3,
               loss_weight=20, loss2_weight=20, cgt_label_hw=(375, 1242),
               use_pallas_reproj=True, pallas_reproj_bf16=False)
    batch = synthetic_batch(2, h, h, h // 4, seed=0)
    runs = []
    for _ in range(2):
        model.load_state_dict(init)
        step = make_train_step(model, cfg, cuda, steps_per_epoch=10)
        set_kernels(model, True, True, True, stem_pool=True)
        reset_launch_counts()
        step(batch)
        assert launch_counts()["conv3x3_wgrad"] > 0 and launch_counts()["reproj_bwd"] == 1
        runs.append([p.grad.clone() for p in step.params] + [p.detach().clone()
                                                              for p in step.params])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def _graph_model(h=128, **kw):
    from jperceiver_tpu_torch.models import JPerceiver

    torch.manual_seed(0)
    return JPerceiver(height=h, width=h, occ_map_size=h // 4, **kw)


_GRAPH_CFG = dict(type="static", split="odometry", frame_ids=[0, -1, 1], scales=[0, 1, 2, 3],
                  height=128, width=128, occ_map_size=32, num_class=2, min_depth=0.1,
                  max_depth=100.0, automask=True, disp_norm=True, loss_type="iou", loss_sum=3,
                  loss_weight=20, loss2_weight=20, cgt_label_hw=(375, 1242),
                  optimizer=dict(type="Adam", lr=1e-4, weight_decay=0),
                  optimizer_config=dict(grad_clip=dict(max_norm=35, norm_type=2)),
                  lr_config=dict(policy="step", step=[1]))


def _bits(ts):
    return [t.detach().clone() for t in ts]


def test_captured_train_step_matches_eager_bit_for_bit(cuda):
    """Three steps of the 128^2 step (road branch, dropout and the automask
    noise drawn from the step's generator), the LR milestone between steps
    2 and 3: the captured step (eager warm-up, capture, replay) against the
    eager one from the same state, every metric, gradient and weight after
    each step, and the optimizer state, BatchNorm statistics and generator
    after the last, bit for bit; each replay's launches are the eager
    step's."""
    import copy

    from jperceiver_tpu_torch.data import synthetic_batch
    from jperceiver_tpu_torch.engine import make_train_step

    model = _graph_model(branches="road")
    init = copy.deepcopy(model.state_dict())
    batches = [synthetic_batch(1, 128, 128, 32, seed=s) for s in range(3)]
    runs = {}
    for graph in (False, None):
        model.load_state_dict(init)
        step = make_train_step(model, _GRAPH_CFG, cuda, steps_per_epoch=2, seed=3, graph=graph)
        per_step, counts = [], []
        for b in batches:
            reset_launch_counts()
            m = step(b)
            torch.cuda.synchronize()
            counts.append(launch_counts())
            per_step.append(_bits([m[k] for k in sorted(m)] + [p.grad for p in step.params]
                                  + list(step.params)))
        assert step.graphed == (graph is None)
        assert step.graphs.captures == (1 if graph is None else 0)
        last = _bits(list(model.state_dict().values())
                     + [v for st in step.optimizer.state.values() for v in st.values()])
        runs[graph] = (per_step, counts, last, step.generator.get_state())
    (eager, e_counts, e_last, e_gen), (capt, c_counts, c_last, c_gen) = runs[False], runs[None]
    for i, (a, b) in enumerate(zip(eager, capt)):
        assert all(torch.equal(x, y) for x, y in zip(a, b, strict=True)), f"step {i + 1}"
    assert all(torch.equal(x, y) for x, y in zip(e_last, c_last, strict=True))
    assert torch.equal(e_gen, c_gen)
    assert c_counts == e_counts
    assert e_counts[0]["reproj_fwd"] == e_counts[0]["reproj_bwd"] == 1


@pytest.mark.parametrize("b", [1, 2])
def test_eval_graphs_at_two_shapes_match_eager(cuda, b):
    from jperceiver_tpu_torch.engine import make_eval_step

    model = _graph_model()
    eager = make_eval_step(model, device=cuda, graph=False)
    captured = make_eval_step(model, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(b)
    xs = [torch.rand(n, 3, 3, 128, 128, device=cuda, generator=g) for n in (b, b + 2)] * 2
    for x in xs:
        reset_launch_counts()
        want = eager({"color_aug": x})
        n_eager = launch_counts()
        reset_launch_counts()
        got = captured({"color_aug": x})
        torch.cuda.synchronize()
        assert launch_counts() == n_eager
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert captured.graphs.captures == 2


def test_streaming_graphs_match_eager(cuda):
    """Chunks of 2 over 6 frames (2, 2, then 1: two graphs) and chunks of
    4 (4, then 1), each call bit for bit the eager call, twice."""
    from jperceiver_tpu_torch.engine import make_streaming_fn

    model = _graph_model(dtype=torch.bfloat16)
    g = torch.Generator(device=cuda).manual_seed(4)
    frames = torch.rand(6, 3, 128, 128, device=cuda, generator=g)
    for chunk in (2, 4):
        eager = make_streaming_fn(model, chunk, cuda, graph=False)
        captured = make_streaming_fn(model, chunk, cuda)
        for _ in range(3):
            want, got = eager(frames), captured(frames)
            assert all(torch.equal(got[k], want[k]) for k in want)
        assert captured.graphs.captures == 2


@pytest.mark.parametrize("world", [1, 2, 4])
def test_captured_ddp_step_matches_eager_bit_for_bit(cuda, world, tmp_path):
    """`world` NCCL ranks, one a card (`torch_ddp_worker.py nccl_graph`),
    at 128^2, B = 1 a rank: for bn_groups 1, the world size and ZeRO-1,
    the captured data-parallel step (graph=None at one rank, graph=True at
    more; 11 eager warm-ups, the capture, two replays, the LR milestone
    between them) against the eager one from the
    same weights and batches: every step's metrics, gradients and weights,
    then the model, optimizer state and generator, bit for bit; each
    step's launches the eager step's."""
    import os
    import socket
    import subprocess
    import sys

    from jperceiver_tpu_torch.data import synthetic_batch

    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} CUDA devices")
    model = _graph_model(branches="road")
    torch.save({"weights": {k: v.cpu() for k, v in model.state_dict().items()},
                "batch": synthetic_batch(world, 128, 128, 32, seed=5)},
               str(tmp_path / "inputs.pt"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_ddp_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, "nccl_graph", str(tmp_path)], text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1"))
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    for r in range(world):
        res = torch.load(str(tmp_path / f"nccl_graph{r}.pt"), weights_only=False)
        for name, got in res.items():
            assert got["graphed"] and got["captures"] == 1, (r, name, got)
            assert got["differing"] == [], (r, name, got["differing"])
            assert got["counts_equal"], (r, name)
            assert got["counts"]["reproj_fwd"] == got["counts"]["reproj_bwd"] == 1, got
