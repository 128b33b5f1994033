"""The port's deterministic backwards, on the CPU.

Three functions of the training step keep their forward and get a backward
that adds in a fixed order, since CUDA's own backward of each adds
atomically, in an order that changes from run to run:
`ops/padding.py::reflect_pad` (`F.pad(mode="reflect")`),
`ops/sampling.py::resize_bilinear` (`F.interpolate`, bilinear, antialias)
and the CCT's hard-attention gather (`models/layout_net.py::_GatherRows`,
`torch.gather`). And `engine/trainer.py::deterministic_cudnn` holds the
step's cuDNN convolutions to deterministic algorithms.

Each forward equals the function it replaces, bit for bit (fp32, bf16 and
float64; the resize in fp32 and float64, as the step resizes fp32
disparities and the CPU has no bf16 antialiased resize). Each gradient is
held to the replaced function's autograd gradient in float64: within 1e-12
of its scale in float64, and in fp32 (bf16) no farther from it than twice
the replaced function's own fp32 (bf16) gradient, plus 4 roundings of the
scale. On the card `tests/test_torch_port_cuda.py` and
`chip_smoke.py` hold the whole step bit for bit across two runs.
"""

import pytest
import torch
import torch.nn.functional as F

from jperceiver_tpu_torch.engine.trainer import deterministic_cudnn
from jperceiver_tpu_torch.models.layout_net import _GatherRows
from jperceiver_tpu_torch.ops.padding import reflect_pad
from jperceiver_tpu_torch.ops.sampling import resize_bilinear

DTYPES = [torch.float32, torch.bfloat16, torch.float64]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grad(fn, x, cot, dtype):
    xd = x.to(dtype).requires_grad_()
    (g,) = torch.autograd.grad(fn(xd), xd, cot.to(dtype))
    assert g.dtype == dtype and g.shape == x.shape
    return g.double()


def _check_grad(fn, ref, x, cot, dtype):
    """fn's gradient at x (in `dtype`) against ref's in float64: within
    1e-12 of its scale in float64, else within twice ref's own distance in
    `dtype` plus 4 roundings of the scale."""
    want = _grad(ref, x, cot, torch.float64)
    err = (_grad(fn, x, cot, dtype) - want).abs().max().item()
    scale = want.abs().max().item()
    if dtype == torch.float64:
        assert err <= 1e-12 * scale
    else:
        eps = 2.0 ** -24 if dtype == torch.float32 else 2.0 ** -8
        ref_err = (_grad(ref, x, cot, dtype) - want).abs().max().item()
        assert err <= 2 * ref_err + 4 * eps * scale, (err, ref_err, scale)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p,shape", [(1, (2, 5, 9, 13)), (1, (1, 3, 3, 4)), (2, (2, 4, 7, 6))])
@pytest.mark.parametrize("channels_last", [False, True])
def test_reflect_pad(dtype, p, shape, channels_last):
    g = torch.Generator().manual_seed(p + shape[2])
    x = torch.randn(shape, generator=g)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    xd = x.to(dtype)
    assert torch.equal(reflect_pad(xd, p), F.pad(xd, (p,) * 4, mode="reflect"))
    cot = torch.randn(shape[:2] + (shape[2] + 2 * p, shape[3] + 2 * p), generator=g)
    _check_grad(lambda t: reflect_pad(t, p), lambda t: F.pad(t, (p,) * 4, mode="reflect"),
                x, cot, dtype)


def test_reflect_pad_backward_counts_every_pad_pixel():
    """Summing a padded all-ones map: each input pixel's gradient is the
    number of padded pixels that copy it (4 at the pixels next to a corner)."""
    x = torch.zeros(1, 1, 5, 6, dtype=torch.float64, requires_grad=True)
    reflect_pad(x).sum().backward()
    rows = torch.tensor([1.0, 2, 1, 2, 1], dtype=torch.float64)
    cols = torch.tensor([1.0, 2, 1, 1, 2, 1], dtype=torch.float64)
    assert torch.equal(x.grad[0, 0], rows[:, None] * cols[None])


# Whole-factor upsampling of the disparities (x1, x2, x4, x8 to the frame),
# the CGT label's resize (both axes, up and down) and the pose resize.
RESIZES = [((16, 16), (16, 16)), ((8, 8), (16, 16)), ((4, 4), (16, 16)), ((2, 2), (16, 16)),
           ((16, 16), (7, 19)), ((32, 32), (6, 20)), ((12, 10), (12, 25))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_bilinear(dtype, src, dst):
    g = torch.Generator().manual_seed(src[0] * 100 + dst[1])
    x = torch.rand((2, 1) + src, generator=g)
    xd = x.to(dtype)
    want = F.interpolate(xd, size=dst, mode="bilinear", align_corners=False, antialias=True)
    assert torch.equal(resize_bilinear(xd, *dst), want)
    cot = torch.randn((2, 1) + dst, generator=g)
    _check_grad(lambda t: resize_bilinear(t, *dst),
                lambda t: F.interpolate(t, size=dst, mode="bilinear", align_corners=False,
                                        antialias=True), x, cot, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gather_rows(dtype):
    g = torch.Generator().manual_seed(3)
    v = torch.randn(3, 16, 8, generator=g)
    # Some rows picked several times, some never.
    idx = torch.randint(0, 6, (3, 16), generator=g)
    vd = v.to(dtype)
    want = torch.gather(vd, 1, idx[..., None].expand(-1, -1, 8))
    assert torch.equal(_GatherRows.apply(vd, idx), want)
    cot = torch.randn(3, 16, 8, generator=g)
    _check_grad(lambda t: _GatherRows.apply(t, idx),
                lambda t: torch.gather(t, 1, idx[..., None].expand(-1, -1, 8)), v, cot, dtype)


def test_deterministic_cudnn_sets_and_restores():
    cudnn = torch.backends.cudnn
    before = cudnn.deterministic
    try:
        for start in (False, True):
            cudnn.deterministic = start
            with deterministic_cudnn():
                assert cudnn.deterministic
            assert cudnn.deterministic == start
        cudnn.deterministic = False
        with pytest.raises(RuntimeError):
            with deterministic_cudnn():
                raise RuntimeError("inside")
        assert not cudnn.deterministic
    finally:
        cudnn.deterministic = before


def test_train_step_runs_under_deterministic_cudnn():
    """Every convolution of a training step, forward and backward, runs
    with cuDNN's deterministic flag set; it is restored after the step."""
    from jperceiver_tpu_torch.data import synthetic_batch
    from jperceiver_tpu_torch.engine import make_train_step
    from jperceiver_tpu_torch.models import JPerceiver

    h = 128
    torch.manual_seed(0)
    model = JPerceiver(height=h, width=h, occ_map_size=h // 4, branches="road")
    cfg = dict(type="static", split="odometry", frame_ids=[0, -1, 1], scales=[0, 1, 2, 3],
               height=h, width=h, occ_map_size=h // 4, num_class=2, min_depth=0.1,
               max_depth=100.0, automask=True, disp_norm=True, loss_type="iou", loss_sum=3,
               loss_weight=20, loss2_weight=20, cgt_label_hw=(94, 310))
    step = make_train_step(model, cfg, "cpu", steps_per_epoch=10)
    seen = []

    def record(kind):
        return lambda *a: seen.append((kind, torch.backends.cudnn.deterministic))

    convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    hooks = [h for m in convs for h in (m.register_forward_hook(record("fwd")),
                                        m.register_full_backward_hook(record("bwd")))]
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = False
    try:
        m = step(synthetic_batch(1, h, h, h // 4, seed=0))
        assert not torch.backends.cudnn.deterministic
    finally:
        torch.backends.cudnn.deterministic = before
        for hk in hooks:
            hk.remove()
    assert torch.isfinite(m["loss"])
    kinds = {k for k, _ in seen}
    assert kinds == {"fwd", "bwd"} and all(d for _, d in seen)
