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
