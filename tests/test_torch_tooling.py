"""The port's profiling tools: `tools/complexity.py` against the JAX
package's parameter counts and a closed-form FLOP count, and
`tools/profile_step.py` with `tools/trace_summary.py` on the CPU."""

import json
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from jperceiver_tpu.data import synthetic_batch as jax_synthetic_batch
from jperceiver_tpu.models import JPerceiver as JaxJPerceiver
from jperceiver_tpu.tools.complexity import _count_params
from jperceiver_tpu_torch.models import JPerceiver
from jperceiver_tpu_torch.models.layout_net import CrossViewTransformer
from jperceiver_tpu_torch.tools import complexity, profile_step, trace_summary

# The JAX package's submodule names and the port's (the reference keys).
NAMES = {"depth_encoder": "DepthEncoder", "depth_decoder": "DepthDecoder",
         "pose_encoder": "PoseEncoder", "pose_decoder": "PoseDecoder",
         "layout_encoder": "LayoutEncoder", "cvp": "CycledViewProjection",
         "cct": "CrossViewTransformer", "layout_decoder": "LayoutDecoder",
         "layout_transform_decoder": "LayoutTransformDecoder"}


@pytest.mark.parametrize("hw", [(128, 128), (256, 256)])
def test_complexity_params_per_submodule_equal_jax(hw):
    h, w = hw
    batch = {k: jnp.asarray(v) for k, v in jax_synthetic_batch(1, h, w, h // 4).items()}
    model = JaxJPerceiver(height=h, width=w, occ_map_size=h // 4)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, batch, train=True))
    want = {}
    for name, tree in shapes["params"].items():
        base, branch = (name[:-2], "B") if name.endswith("_b") else (name, "")
        want[NAMES[base] + branch] = _count_params(tree)
    got = complexity.count(h, w)
    assert got["params"] == want
    assert got["total_params"] == _count_params(shapes["params"])


def _closed_form_flops(h, w, batch=1) -> tuple[int, dict]:
    """2 x the multiply-adds of every conv and linear layer of the eval
    forward (from their output shapes) and of the CCT's three matrix
    products (from its input shape), per child of the model."""
    with torch.device("meta"):
        model = JPerceiver(height=h, width=w, occ_map_size=h // 4)
    model.eval()
    top = {m: name.split(".")[0] for name, m in model.named_modules() if name}
    per = dict.fromkeys(dict(model.named_children()), 0)

    def conv(mod, args, out):
        per[top[mod]] += 2 * out.numel() * mod.in_channels // mod.groups * (
            mod.kernel_size[0] * mod.kernel_size[1])

    def linear(mod, args, out):
        per[top[mod]] += 2 * out.numel() * mod.in_features

    def cct(mod, args):
        b, c, hh, ww = args[0].shape
        n, qk = hh * ww, c // 8
        # energy and the depth attention: (n, qk) x (qk, n); attn @ V: (h, w) x (h, w) a channel
        per[top[mod]] += 2 * (2 * b * n * n * qk) + 2 * b * c * hh * ww * ww

    for mod in model.modules():
        if isinstance(mod, torch.nn.Conv2d):
            mod.register_forward_hook(conv)
        elif isinstance(mod, torch.nn.Linear):
            mod.register_forward_hook(linear)
        elif isinstance(mod, CrossViewTransformer):
            mod.register_forward_pre_hook(cct)
    with torch.no_grad():
        model({"color_aug": torch.empty(batch, 3, 3, h, w, device="meta")}, with_pose=True)
    return sum(per.values()), per


@pytest.mark.parametrize("hw", [(128, 128), (256, 256)])
def test_complexity_flops_equal_a_closed_form_count(hw):
    total, per = _closed_form_flops(*hw)
    got = complexity.count(*hw)
    assert got["total_flops"] == total
    assert got["flops"] == per


def test_complexity_cli_prints_the_total(capsys):
    res = complexity.main(["--height", "128", "--width", "128"])
    out = capsys.readouterr().out
    assert f"{res['total_params']:,}" in out and "GFLOP" in out


@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    torch.set_num_threads(1)
    out = str(tmp_path_factory.mktemp("trace"))
    res = profile_step.main(["--out", out, "--steps", "2", "--height", "128",
                             "--device", "cpu"])
    return res, out


def test_profile_step_writes_a_trace(profiled):
    res, out = profiled
    assert res["trace"] == os.path.join(out, "trace.json") and os.path.isfile(res["trace"])
    assert res["ms_per_step"] > 0 and res["loss"] == res["loss"]


def test_trace_summary_total_equals_the_traces_own_sum(profiled):
    res, out = profiled
    s = trace_summary.main([out, "--steps", "2", "--top", "5"])
    with open(res["trace"]) as f:
        events = json.load(f)["traceEvents"]
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    assert s["track"] == "cpu_op"  # a CPU trace has no device kernels
    tops = trace_summary.op_events(events)[1]
    assert s["total_ms_per_step"] == pytest.approx(sum(e["dur"] for e in tops) / 2 / 1e3,
                                                   rel=1e-12)
    assert sum(k["count"] for k in s["kernels"].values()) == len(tops) <= len(ops)
    # Top-level operators do not overlap on their thread, so they sum to at
    # most the span of the profiled steps.
    span = max(e["ts"] + e["dur"] for e in ops) - min(e["ts"] for e in ops)
    assert sum(e["dur"] for e in tops) <= span
    assert sum(n for n, _ in s["histogram"].values()) == pytest.approx(len(tops) / 2)
    # The step's own operators are there: the K3 sites' plain conv and the
    # stem pool's backward.
    assert any("conv2d" in n for n in s["kernels"])
    assert any("MaxPool3x3s2Backward" in n for n in s["kernels"])


def test_trace_summary_reads_device_kernels_first(tmp_path):
    events = [{"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": 0, "dur": 50,
               "pid": 1, "tid": 1},
              {"ph": "X", "cat": "kernel", "name": "void jp::conv3x3_bf16<128>(Params)",
               "ts": 5, "dur": 30, "pid": 0, "tid": 7},
              {"ph": "X", "cat": "kernel", "name": "void jp::conv3x3_bf16<128>(Params)",
               "ts": 40, "dur": 10, "pid": 0, "tid": 7}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = trace_summary.summarize(str(path), 2)
    assert s["track"] == "kernel" and s["total_ms_per_step"] == pytest.approx(0.02)
    assert s["categories"] == {"jp::conv3x3_bf16": pytest.approx(0.02)}
    assert trace_summary.category(
        "void at::native::(anonymous namespace)::reflection_pad2d_backward_out_kernel<float>"
        "(float*)") == "at::native::reflection_pad2d_backward_out_kernel"
