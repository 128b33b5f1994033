"""K3's and K4's TF32 paths on the CPU: which kernel a call takes, and the
rounding the paths share with cuDNN's fp32 convolution.

A float32 K3 or K4 call on the card runs the TF32 kernel where
`torch.backends.cudnn.allow_tf32` is set and the exact CUDA-core kernel
otherwise; bf16 keeps its kernel and the CPU its plain version
(`k3_path`, `k4_path`: one rule). The TF32 kernel rounds its activation to nearest, ties to
even, at 10 mantissa bits, and the wrapper rounds the weight the same way
with `round_tf32`: the benchmark's reference rounds every convolution's
operands with `portbench/reference/model.py::_tf32`, and the two must
give the same bits; K4's kernel rounds both its operands so. The kernels
themselves are held on the card by `test_torch_port_k3_tf32_cuda.py` and
`test_torch_port_k4_tf32_cuda.py`.
"""

import numpy as np
import pytest
import torch

from jperceiver_tpu_torch.ops.cuda.conv3x3 import _weight_operand, k3_path, k4_path, round_tf32
from portbench.reference.model import _tf32


_PATHS = [
    ("cuda", torch.float32, True, "tf32"),
    ("cuda", torch.float32, False, "f32"),
    ("cuda", torch.bfloat16, True, "bf16"),
    ("cuda", torch.bfloat16, False, "bf16"),
    ("cpu", torch.float32, True, "plain"),
    ("cpu", torch.float32, False, "plain"),
    ("cpu", torch.bfloat16, True, "plain"),
    ("cpu", torch.float64, True, "plain"),
]


@pytest.mark.parametrize("device,dtype,allow_tf32,path", _PATHS)
def test_k3_path(device, dtype, allow_tf32, path):
    assert k3_path(device, dtype, allow_tf32) == path


@pytest.mark.parametrize("device,dtype,allow_tf32,path", _PATHS)
def test_k4_path(device, dtype, allow_tf32, path):
    """K4 follows K3's rule: a float32 weight gradient takes TF32 exactly
    where the same conv's forward and data-grad do."""
    assert k4_path(device, dtype, allow_tf32) == path


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_k3_path_refuses_other_dtypes_on_the_card(dtype):
    with pytest.raises(TypeError):
        k3_path("cuda", dtype, True)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_k4_path_refuses_other_dtypes_on_the_card(dtype):
    with pytest.raises(TypeError):
        k4_path("cuda", dtype, True)


def test_k3_path_reads_the_flag_at_the_call():
    from jperceiver_tpu_torch.ops.cuda.conv3x3 import _path

    x = torch.zeros(1, 1, 4, 4)
    flag = torch.backends.cudnn.allow_tf32
    try:
        for value in (True, False):
            torch.backends.cudnn.allow_tf32 = value
            assert _path(x) == "plain"
            assert k3_path("cuda", x.dtype, torch.backends.cudnn.allow_tf32) == (
                "tf32" if value else "f32")
    finally:
        torch.backends.cudnn.allow_tf32 = flag


def _bits(*patterns: int) -> torch.Tensor:
    return torch.tensor(np.array(patterns, dtype=np.uint32).view(np.int32)).view(torch.float32)


# Bit patterns of each kind: the 13 low bits decide the rounding, bit 13
# breaks a tie (0x1000) to even.
_CASES = {
    "ties": _bits(0x3F801000, 0x3F803000, 0x3F805000, 0x4049F000, 0x40491000,
                  0x3F7FF000, 0x7F7FF000),
    "negatives": _bits(0xBF801000, 0xBF803000, 0xBF800FFF, 0xBF801001, 0xC0490FDB,
                       0xFF7FF000, 0xFF7FFFFF, 0x80000000),
    "subnormals": _bits(0x00000001, 0x00000FFF, 0x00001000, 0x00003000, 0x00001001,
                        0x007FFFFF, 0x807FFFFF, 0x80001000, 0x00800000),
    "infinities": _bits(0x7F800000, 0xFF800000, 0x7F7FFFFF, 0x7F7FE000, 0x7F7FF001),
    "nans": _bits(0x7FC00000, 0xFFC00000, 0x7F800001, 0x7F801000, 0x7FFFFFFF, 0xFFFFFFFF,
                  0x7FC01234),
    "random": torch.from_numpy(
        np.random.default_rng(0).standard_normal(4096).astype(np.float32)
        * np.float32(2.0) ** np.random.default_rng(1).integers(-140, 120, 4096).astype(
            np.float32)),
}


@pytest.mark.parametrize("kind", sorted(_CASES))
def test_round_tf32_is_the_reference_rounding(kind):
    """`round_tf32` gives `_tf32`'s bits, NaN and infinities included, and
    clears the 13 low bits of every finite result."""
    t = _CASES[kind]
    got, want = round_tf32(t).view(torch.int32), _tf32(t).view(torch.int32)
    assert torch.equal(got, want)
    finite = torch.isfinite(round_tf32(t))
    assert not (got[finite] & 0x1FFF).any()


def test_round_tf32_rounds_to_nearest_even():
    """Against the rounding worked out in float64: the nearest multiple of
    2^(e - 10), ties to an even mantissa."""
    t = _CASES["random"]
    t = t[torch.isfinite(t) & (t != 0) & (t.abs() >= 2.0 ** -126)]
    got = round_tf32(t).double()
    e = torch.floor(torch.log2(t.double().abs()))
    step = 2.0 ** (e - 10)
    q = t.double() / step
    want = torch.round(q) * step  # torch.round ties to even
    assert torch.equal(got, want)


def test_weight_operand_rounds_the_copy():
    """The TF32 weight operand is the weight rounded and laid out (O, 3, 3,
    C stored), also for the data-grad's flipped, transposed view; channels
    that fill no whole 16 bytes are stored 32 at a time."""
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.standard_normal((6, 5, 3, 3)).astype(np.float32))
    for src in (w, w.flip(2, 3).transpose(0, 1)):
        out = _weight_operand(src, torch.float32, tf32=True)
        assert out.shape == (src.shape[0], 3, 3, 32)
        assert torch.equal(out[..., :src.shape[1]], _tf32(src.contiguous()).permute(0, 2, 3, 1))
        exact = _weight_operand(src, torch.float32)
        assert torch.equal(exact[..., :src.shape[1]], src.permute(0, 2, 3, 1))
