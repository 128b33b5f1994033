"""The reduction of a canned profiler trace: busy time, idle gaps by host
span, time by kernel class, and the per-layer readers over it."""

from __future__ import annotations

import pytest

from portbench import flops, spec
from portbench.trace import Reduced, short_name

# One traced slice of 1000 us holding two units; times in microseconds.
EVENTS = [
    {"name": "portbench.slice", "cat": "user_annotation", "ts": 0.0, "dur": 1000.0},
    {"name": "portbench.train", "cat": "user_annotation", "ts": 0.0, "dur": 480.0},
    {"name": "portbench.train", "cat": "user_annotation", "ts": 500.0, "dur": 500.0},
    {"name": "void conv3x3_bf16_wgmma<64>(CUtensorMap)", "cat": "kernel", "ts": 10.0,
     "dur": 100.0},
    {"name": "sm90_xmma_fprop_implicit_gemm_bf16", "cat": "kernel", "ts": 100.0, "dur": 50.0},
    {"name": "void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor<float>>",
     "cat": "kernel", "ts": 200.0, "dur": 100.0},
    {"name": "void at::native::reduce_kernel<512, 1>", "cat": "kernel", "ts": 520.0,
     "dur": 80.0},
    {"name": "Memcpy HtoD (Pinned -> Device)", "cat": "gpu_memcpy", "ts": 600.0, "dur": 100.0},
    {"name": "mystery_kernel", "cat": "kernel", "ts": 900.0, "dur": 50.0},
    # Outside the slice: left out.
    {"name": "void at::native::vectorized_elementwise_kernel<4>", "cat": "kernel",
     "ts": 1200.0, "dur": 100.0},
    {"name": "aten::add", "cat": "cpu_op", "ts": 10.0, "dur": 5.0},
]


@pytest.fixture
def reduced():
    return Reduced(EVENTS, (0.0, 1000.0), spec.kernel_classes(), units=2)


def test_busy_is_the_union_of_device_operations(reduced):
    # [10, 150] U [200, 300] U [520, 700] U [900, 950]
    assert reduced.window_s == pytest.approx(1e-3)
    assert reduced.busy_s == pytest.approx((140 + 100 + 180 + 50) * 1e-6)


def test_time_by_class_and_the_unclassed(reduced):
    assert reduced.by_class["conv"] == pytest.approx(150e-6)
    assert reduced.by_class["elementwise"] == pytest.approx(100e-6)
    assert reduced.by_class["reduction"] == pytest.approx(80e-6)
    assert reduced.by_class["memcpy"] == pytest.approx(100e-6)
    assert dict(reduced.unclassed) == {"mystery_kernel": pytest.approx(50e-6)}


def test_idle_gaps_are_named_by_the_host_span(reduced):
    gaps = reduced.breakdown()["idle_gaps"]
    # [0,10] [150,200] [300,520] [700,900] [950,1000], each with its middle in a unit.
    assert gaps == [["portbench.train", pytest.approx(530e-6)]]
    assert [round(s * 1e6) for _, s in reduced.gaps] == [220, 200, 50, 50, 10]
    ops = reduced.breakdown()["device_ops"]
    assert len(ops) <= 10 and ops[0][0] in ("vectorized_elementwise_kernel", "conv3x3_bf16_wgmma",
                                           "Memcpy HtoD")


def test_short_names():
    assert short_name("void at::native::reduce_kernel<512, 1>(x)") == "at::native::reduce_kernel"
    assert short_name("void (anonymous namespace)::softmax_warp_forward<float>") == \
        "softmax_warp_forward"


class _Ctx:
    def __init__(self, reduced):
        self.reduced = reduced
        self.work = flops.WorkRecord()
        self.work.ops = [("conv", 10 ** 6, 10 ** 3)]
        self.flops_per_s = spec.peaks()["tf32_flops_per_s"]
        self.hbm_bytes_per_s = spec.peaks()["hbm_bytes_per_s"]
        self.bytes_per_element = 4


def test_readers_over_the_canned_trace(reduced):
    ctx = _Ctx(reduced)
    read = spec.metric_reader
    idle = read("device_idle_share.train")(ctx, None)
    assert idle == pytest.approx(100 * (1 - 470 / 1000))
    assert read("elementwise_ms.train")(ctx, None) == pytest.approx(1e3 * 180e-6 / 2)
    bound = max(1e6 / 494.7e12, 4e3 / 3.35e12)
    assert read("conv_roofline.train")(ctx, None) == pytest.approx(100 * bound * 2 / 150e-6)
    assert read("step_mfu.train")(ctx, None) == pytest.approx(100 * 1e6 * 2 / 1e-3 / 494.7e12)


def test_readers_return_nothing_where_there_is_nothing_to_read():
    empty = Reduced([], (0.0, 1000.0), spec.kernel_classes(), units=2)
    ctx = _Ctx(empty)
    for name in ("device_idle_share.x", "conv_roofline.x", "elementwise_ms.x"):
        assert spec.metric_reader(name)(ctx, None) is None
