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


@pytest.mark.parametrize("dtype,b", [(torch.float32, 1), (torch.bfloat16, 1),
                                     (torch.bfloat16, 2), (torch.float32, 3)])
@pytest.mark.parametrize("h,w", [(37, 45), (2, 3)])
def test_reproj_kernels(cuda, dtype, b, h, w):
    """K1 and K2 against their plain versions, with exact frame ties (frame 1
    copies frame 0 on the left half) and sizes that cut tiles and reach the
    reflect ring and corners of every tile. Pixel values are 8-bit levels
    k/256, so the SSIM window sums are exact in both versions (on arbitrary
    fp32 values, low-variance windows make the gradient depend on their
    order)."""
    from jperceiver_tpu_torch.ops.cuda import reproj_min, reproj_min_plain
    from jperceiver_tpu_torch.ops.cuda.reproj import _reproj_bwd_plain

    g = torch.Generator(device=cuda).manual_seed(b + h)
    preds = torch.round(256 * torch.rand(2, b, 2, 3, h, w, device=cuda, generator=g)) / 256
    preds[:, :, 1, ..., : w // 2] = preds[:, :, 0, ..., : w // 2]
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


def test_kernel_routed_blocks_reach_every_parameter(cuda):
    """A backward through a K3-routed `Conv3x3` and a K5-routed `CRPBlock`
    reaches every parameter and the input, as the routing through cuDNN and
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
                counts["maxpool5x5"]) == ((1, 1, 1, 4) if on else (0, 0, 0, 0))
        grads[on] = [p.grad.clone() for p in net.parameters()] + [x.grad.clone()]
    for i, (a, ref) in enumerate(zip(grads[True], grads[False])):
        assert torch.isfinite(a).all() and ref.norm() > 0
        assert (a - ref).norm().item() <= 1e-2 * ref.norm().item(), i
