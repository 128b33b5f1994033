"""The work of one unit of a cell (a training step, a request, a streaming
call), counted on the benchmark's own plain reference model at the cell's
exact shapes, on PyTorch's meta device: shapes only, no data, no card.

Every convolution and matrix product of the pass is recorded with its
FLOPs (2 per multiply-add, as `torch.utils.flop_counter` counts them) and
its bytes (its inputs, weights and outputs, each read or written once at
the compute dtype). A training step counts the forward, the objective and
the backward, without any recompute; an eval request the forward with
pose; a streaming call each output frame's forward and pose pass. The
count follows the model's work, not how the program routes it.
"""

from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten


def _numel(t) -> int:
    return math.prod(t.shape) if isinstance(t, torch.Tensor) else 0


def _conv_macs(out_numel: int, weight) -> int:
    return out_numel * math.prod(weight.shape[1:])


class WorkRecord(TorchDispatchMode):
    """Records (op, flops, elements moved) for each convolution and matrix
    product dispatched under it."""

    def __init__(self):
        super().__init__()
        self.ops: list[tuple[str, int, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if packet is aten.convolution:
            x, w = args[0], args[1]
            self.ops.append(("conv", 2 * _conv_macs(_numel(out), w),
                             _numel(x) + _numel(w) + _numel(out) + _numel(args[2])))
        elif packet is aten.convolution_backward:
            g, x, w = args[0], args[1], args[2]
            mask = args[10]
            n = int(mask[0]) + int(mask[1])
            moved = _numel(g) + (_numel(w) + _numel(x)) * bool(mask[0]) + \
                (_numel(x) + _numel(w)) * bool(mask[1])
            self.ops.append(("conv_bwd", 2 * n * _conv_macs(_numel(g), w), moved))
        elif packet in (aten.mm, aten.bmm, aten.addmm, aten.baddbmm):
            a, b = (args[1], args[2]) if packet in (aten.addmm, aten.baddbmm) else args[:2]
            k = a.shape[-1]
            extra = _numel(args[0]) if packet in (aten.addmm, aten.baddbmm) else 0
            self.ops.append((packet.__name__, 2 * _numel(out) * k,
                             _numel(a) + _numel(b) + _numel(out) + extra))
        return out

    @property
    def flops(self) -> int:
        return sum(f for _, f, _ in self.ops)


def _meta_batch(model_cfg: dict, b: int) -> dict:
    h, w, s = model_cfg["height"], model_cfg["width"], model_cfg["occ_map_size"]
    f = len(model_cfg["frame_ids"])

    def e(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="meta")

    eye = torch.eye(4, device="meta").expand(b, 4, 4)
    return {"color": e(b, f, 3, h, w), "color_aug": e(b, f, 3, h, w),
            "K": eye, "inv_K": eye, "odometry_K": eye, "Tr_cam2_velo": eye,
            "bev_static": e(b, s, s, dtype=torch.long), "bev_dynamic": e(b, s, s, dtype=torch.long),
            "bev_both": e(b, s, s), "bev_static_sdf": e(b, 1, s, s),
            "bev_dynamic_sdf": e(b, 1, s, s)}


def count(model_cfg: dict, spec: dict) -> WorkRecord:
    """The record of one unit: `spec` {"mode": "train", "batch"},
    {"mode": "eval", "batch"} or {"mode": "stream", "frames"}."""
    from portbench.reference import losses as L
    from portbench.reference.train import meta_model

    model = meta_model(model_cfg)
    rec = WorkRecord()
    mode = spec["mode"]
    h, w = model_cfg["height"], model_cfg["width"]
    if mode == "train":
        batch = _meta_batch(model_cfg, spec["batch"])
        model.train()
        with rec:
            out = model(batch["color_aug"], with_pose=True)
            sum(L.losses(out, batch, model_cfg, None).values()).backward()
    elif mode == "eval":
        model.eval()
        with rec, torch.no_grad():
            model(torch.zeros(spec["batch"], len(model_cfg["frame_ids"]), 3, h, w,
                              device="meta"), with_pose=True)
    elif mode == "stream":
        model.eval()
        n = spec["frames"]
        frame = torch.zeros(1, 3, h, w, device="meta")
        one = WorkRecord()
        with one, torch.no_grad():
            model(frame[:, None], with_pose=False)
            model.pose(frame, frame)
        rec.ops = [(op, f * n, m * n) for op, f, m in one.ops]
    else:
        raise ValueError(f"unknown pass {mode!r}")
    return rec


def roofline_seconds(rec: WorkRecord, peak_flops: float, peak_bytes: float,
                     bytes_per_element: int) -> float:
    """The least time the chip could take for the recorded products: each
    op at the larger of its FLOPs over the peak rate and its bytes over
    the memory rate."""
    return sum(max(f / peak_flops, m * bytes_per_element / peak_bytes) for _, f, m in rec.ops)
