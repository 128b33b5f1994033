"""The port's device phase marks in a profiler trace of a CUDA graph's
replay, on a GPU.

Marked `cuda`: they skip where no CUDA device is present, and run on the
card with `python -m pytest tests/test_torch_tracing_cuda.py -m cuda`.
In one profiled replay of the captured 512^2 training step the marks run
once each in the order of `tracing.py` (`losses` twice, around `cgt`), the
phases between them hold all of the replay's device work, and the only
device work of the call outside them is the copy into the graph's inputs
and the learning rate's fill; the K3 and K4 launches `launch_shapes()`
counts are the K3 and K4 kernels of the trace. The eval step's replay is
bounded by `eval` and `end` in the same way. A training and an eval step
routed away from every hand kernel are marked all the same, and build no
kernel library.
"""

import re

import pytest
import torch

from jperceiver_tpu_torch.ops.cuda import _build, launch_shapes, reset_launch_counts

pytestmark = pytest.mark.cuda

_CFG = dict(type="static", split="odometry", frame_ids=[0, -1, 1], scales=[0, 1, 2, 3],
            height=128, width=128, occ_map_size=32, num_class=2, min_depth=0.1,
            max_depth=100.0, automask=True, disp_norm=True, loss_type="iou", loss_sum=3,
            loss_weight=20, loss2_weight=20, cgt_label_hw=(375, 1242),
            optimizer=dict(type="Adam", lr=1e-4, weight_decay=0),
            optimizer_config=dict(grad_clip=dict(max_norm=35, norm_type=2)),
            lr_config=dict(policy="step", step=[1]))
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_TRAIN_MARKS = ["forward", "losses", "cgt", "losses", "backward", "update", "end"]
# The trace's names of K3 (as the forward and as the data-grad) and of K4.
_K3 = re.compile(r"conv3x3_f32|conv3x3_bf16_wgmma")
_K4 = re.compile(r"wgrad_f32|wgrad_bf16_wgmma")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _device_ops(prof, tmp_path):
    import json

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS),
                  key=lambda e: e["ts"])


def _busy(ops, a, b):
    """Microseconds of [a, b] covered by the union of `ops`."""
    merged = []
    for e in ops:
        s, t = max(e["ts"], a), min(e["ts"] + e["dur"], b)
        if t <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return sum(t - s for s, t in merged)


def _profiled(call, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    ops = _device_ops(prof, tmp_path)
    marks = [e for e in ops if e["name"].startswith("jp_mark_")]
    return ops, marks


def _train_step(cuda, size, kernels=True):
    from jperceiver_tpu_torch.data import synthetic_batch
    from jperceiver_tpu_torch.engine import make_train_step
    from jperceiver_tpu_torch.engine.trainer import batch_to
    from jperceiver_tpu_torch.models import JPerceiver, set_kernels

    torch.manual_seed(0)
    model = JPerceiver(height=size, width=size, occ_map_size=size // 4, branches="road")
    cfg = dict(_CFG, height=size, width=size, occ_map_size=size // 4,
               use_pallas_reproj=kernels)
    step = make_train_step(model, cfg, cuda, steps_per_epoch=2, seed=3)
    if not kernels:
        set_kernels(model, False, False, False, stem_pool=False)
    batch = batch_to(synthetic_batch(1, size, size, size // 4, seed=0), cuda)
    for _ in range(2):  # the eager warm-up, then the capture and its first replay
        step(batch)
    return step, batch


def test_marks_bound_the_phases_of_a_training_replay(cuda, tmp_path):
    # At 512^2 the first stage's 64-channel convolutions pass K3's shallow
    # gate (H*W >= 128^2 at 48 <= C_in <= 128).
    step, batch = _train_step(cuda, 512)
    reset_launch_counts()
    ops, marks = _profiled(lambda: step(batch), tmp_path)
    assert step.graphs.captures == 1
    assert [m["name"][len("jp_mark_"):] for m in marks] == _TRAIN_MARKS
    first, last = marks[0], marks[-1]
    replay = _busy(ops, first["ts"], last["ts"] + last["dur"])
    phases = sum(_busy(ops, a["ts"], b["ts"]) for a, b in zip(marks, marks[1:]))
    assert phases == pytest.approx(replay, rel=0.01)
    outside = {e["name"] for e in ops
               if e["ts"] + e["dur"] <= first["ts"] or e["ts"] >= last["ts"] + last["dur"]}
    assert all(("Memcpy" in n or "copy" in n.lower() or "fill" in n.lower()) for n in outside), \
        outside
    # The replay's K3 and K4 launches by shape are the captured ones, once,
    # and are the K3 and K4 kernels that ran.
    (captured,) = step.graphs.entries.values()
    shapes = launch_shapes()
    assert shapes == captured.launches.per_replay_shapes
    k3 = sum(n for key, n in shapes.items() if key[0] in ("conv3x3", "conv3x3_dgrad"))
    k4 = sum(n for key, n in shapes.items() if key[0] == "conv3x3_wgrad")
    assert k3 > 0 and k4 > 0, shapes
    assert k3 == sum(1 for e in ops if e["cat"] == "kernel" and _K3.search(e["name"]))
    assert k4 == sum(1 for e in ops if e["cat"] == "kernel" and _K4.search(e["name"]))


def test_a_step_routed_off_every_kernel_is_marked_and_builds_no_kernel(cuda, tmp_path,
                                                                        monkeypatch):
    from jperceiver_tpu_torch.engine import make_eval_step
    from jperceiver_tpu_torch.models import JPerceiver, set_kernels

    monkeypatch.setattr(_build, "library", lambda: pytest.fail("built the kernel library"))
    step, batch = _train_step(cuda, 128, kernels=False)
    _, marks = _profiled(lambda: step(batch), tmp_path)
    assert [m["name"][len("jp_mark_"):] for m in marks] == _TRAIN_MARKS
    model = JPerceiver(height=128, width=128, occ_map_size=32)
    evaluate = make_eval_step(model, device=cuda)
    set_kernels(model, False, False, False, stem_pool=False)
    frames = torch.rand(1, 3, 3, 128, 128, device=cuda)
    for _ in range(2):
        evaluate({"color_aug": frames})
    _, marks = _profiled(lambda: evaluate({"color_aug": frames}), tmp_path)
    assert [m["name"] for m in marks] == ["jp_mark_eval", "jp_mark_end"]


def test_marks_bound_an_eval_replay(cuda, tmp_path):
    from jperceiver_tpu_torch.engine import make_eval_step
    from jperceiver_tpu_torch.models import JPerceiver

    torch.manual_seed(0)
    step = make_eval_step(JPerceiver(height=128, width=128, occ_map_size=32), device=cuda)
    frames = torch.rand(1, 3, 3, 128, 128, device=cuda)
    for _ in range(2):
        step({"color_aug": frames})
    ops, marks = _profiled(lambda: step({"color_aug": frames}), tmp_path)
    assert [m["name"] for m in marks] == ["jp_mark_eval", "jp_mark_end"]
    inside = _busy(ops, marks[0]["ts"], marks[1]["ts"] + marks[1]["dur"])
    assert inside == pytest.approx(_busy(ops, 0.0, float("inf")), rel=0.01)
