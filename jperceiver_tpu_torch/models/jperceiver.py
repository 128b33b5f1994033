"""JPerceiver: joint depth + pose + dual BEV layout (counterpart of
`jperceiver_tpu/models/jperceiver.py`).

Batch schema (NCHW; frames stacked on dim 1 in `frame_ids` order):
  color_aug : (B, F, 3, H, W) float32 in [0, 1]

Outputs, all float32 whatever the compute dtype, with the JAX package's
keys: `disp/0..3` (B, 1, H/2^(s+1), W/2^(s+1)); per branch `topview`,
`transform_topview` (B, num_class, S, S), `features`,
`retransform_features` (B, 128, S/32, S/32), `cv_attn`, `cm_attn`
(B, 1, S/32, S/32), with a `B` suffix for the vehicle branch; with pose,
`cam_T_cam/<f>` (B, 4, 4) for every frame f but 0.

Module names follow the reference `Baseline` state-dict keys, so the
output of `convert.state_dict_from_jax` and reference `.pth` files load
with `load_state_dict`.
"""

from __future__ import annotations

import contextlib
from typing import Any, Sequence

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..ops.geometry import at_least_f32, transformation_from_parameters
from ..ops.sampling import resize_bilinear
from .common import frozen_running_stats
from .depth_net import DepthDecoder, DepthEncoder
from .layout_net import (CrossViewTransformer, CycledViewProjection,
                         LayoutDecoder, LayoutEncoder)
from .pose_net import PoseDecoder, PoseEncoder
from .registry import register
from .resnet import num_ch_enc

POSE_INPUT_HW = (192, 640)  # pose inputs are resized to this
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# The trunks that `remat` checkpoints, as the JAX module's `setup` wraps
# them in `nn.remat`: "enc" the three encoders, "dec" the depth and layout
# decoders, "all" both.
_ENCODERS = ("DepthEncoder", "PoseEncoder", "LayoutEncoder")
_DECODERS = ("DepthDecoder", "LayoutDecoder", "LayoutTransformDecoder",
             "LayoutDecoderB", "LayoutTransformDecoderB")


@register
class JPerceiver(nn.Module):
    """The forward of eval and training. The input size is free (a
    multiple of 128 with `occ_map_size` = height / 4, as in the JAX
    package); `occ_map_size` sizes the CVP, `branches` picks the BEV
    branches ("both", "road", "vehicle"), `dtype` is the compute dtype
    (parameters stay fp32). `height`, `width`, `scales` and the depth range
    are the configuration's, kept as the JAX module keeps them.

    `remat` (False, True or "all", "enc", "dec") checkpoints trunks as the
    JAX module does: in training their activations are recomputed in the
    backward instead of kept (`torch.utils.checkpoint`, non-reentrant). A
    recompute draws no dropout (the decoder's masks are drawn before its
    checkpoint) and updates no BatchNorm running statistics. It stops once
    the last tensor the backward needs is saved (checkpoint's early stop),
    which still reaches every 3x3 conv and CRP pool of the trunk; K3 and
    K5 launch before they save their inputs, so each launches again in it.
    """

    def __init__(self, depth_layers: int = 18, pose_layers: int = 18,
                 frame_ids: Sequence[Any] = (0, -1, 1), height: int = 1024,
                 width: int = 1024, occ_map_size: int = 256, num_class: int = 2,
                 scales: Sequence[int] = (0, 1, 2, 3), min_depth: float = 0.1,
                 max_depth: float = 100.0, dtype: torch.dtype = torch.float32,
                 remat: bool | str = False, branches: str = "both"):
        super().__init__()
        if branches not in ("both", "road", "vehicle"):
            raise ValueError(f"branches must be both/road/vehicle, got {branches}")
        mode = {True: "all", False: ""}.get(remat, remat) or ""
        if mode not in ("", "all", "enc", "dec"):
            raise ValueError(f"remat must be bool/'all'/'enc'/'dec', got {remat!r}")
        self.frame_ids = tuple(frame_ids)
        self.height, self.width = height, width
        self.occ_map_size, self.num_class = occ_map_size, num_class
        self.scales = tuple(scales)
        self.min_depth, self.max_depth = min_depth, max_depth
        self.dtype = dtype
        self.remat = remat
        self.remat_trunks = frozenset(
            (_ENCODERS if mode in ("all", "enc") else ())
            + (_DECODERS if mode in ("all", "dec") else ()))
        self.branches = branches
        self.DepthEncoder = DepthEncoder(depth_layers, dtype)
        self.DepthDecoder = DepthDecoder(depth_layers, dtype=dtype)
        self.PoseEncoder = PoseEncoder(pose_layers, 2, dtype)
        self.PoseDecoder = PoseDecoder(pose_layers, dtype)
        self.LayoutEncoder = LayoutEncoder(depth_layers, dtype)
        cvp_dim = occ_map_size // 32
        depth_ch = num_ch_enc(depth_layers)[-1]
        for suffix, on in (("", branches in ("both", "road")),
                           ("B", branches in ("both", "vehicle"))):
            if not on:
                continue
            self.add_module(f"CycledViewProjection{suffix}",
                            CycledViewProjection(cvp_dim, dtype))
            self.add_module(f"CrossViewTransformer{suffix}",
                            CrossViewTransformer(128, depth_ch, dtype))
            self.add_module(f"LayoutDecoder{suffix}",
                            LayoutDecoder(num_class, 128, dtype))
            self.add_module(f"LayoutTransformDecoder{suffix}",
                            LayoutDecoder(num_class, 128, dtype))

    @classmethod
    def from_config(cls, cfg) -> "JPerceiver":
        """The model of a `model` config, reading the keys that
        `jperceiver_tpu/models/jperceiver.py::JPerceiver.from_config` reads."""
        return cls(
            dtype=_DTYPES[cfg.get("compute_dtype", "float32")],
            depth_layers=cfg.get("depth_num_layers", 18),
            pose_layers=cfg.get("pose_num_layers", 18),
            frame_ids=tuple(cfg.get("frame_ids", (0, -1, 1))),
            height=cfg.get("height", 1024),
            width=cfg.get("width", 1024),
            occ_map_size=cfg.get("occ_map_size", 256),
            num_class=cfg.get("num_class", 2),
            scales=tuple(cfg.get("scales", (0, 1, 2, 3))),
            min_depth=cfg.get("min_depth", 0.1),
            max_depth=cfg.get("max_depth", 100.0),
            remat=cfg.get("remat", False),
            branches=cls.branches_from_cfg(cfg),
        )

    @staticmethod
    def branches_from_cfg(cfg) -> str:
        """The BEV branches a config trains: with `skip_inactive_branch`
        (default True) only the branch its `type` has a loss for ("road"
        for the static types, "vehicle" for the dynamic ones, both for
        Argo_both), else both, as the JAX `_branches_from_cfg` decides."""
        if not cfg.get("skip_inactive_branch", True):
            return "both"
        t = cfg.get("type", "static")
        if t in ("static", "static_raw", "Argo_static"):
            return "road"
        if t in ("dynamic", "Argo_dynamic"):
            return "vehicle"
        return "both"

    def _trunk(self, name: str, fn, *args):
        """`fn(*args)`, checkpointed when `name` is a remat trunk and the
        forward records a graph."""
        if name not in self.remat_trunks or not (self.training and torch.is_grad_enabled()):
            return fn(*args)
        module = getattr(self, name)
        # The trunks draw nothing at random (the decoder's dropout is drawn
        # before its checkpoint), so no RNG state is kept for the recompute:
        # reading it would fail under a CUDA graph capture.
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              frozen_running_stats(module)))

    def _layout_branch(self, enc_feat, depth_feat, suffix):
        cvp = getattr(self, f"CycledViewProjection{suffix}")
        cct = getattr(self, f"CrossViewTransformer{suffix}")
        transform, retransform = cvp(enc_feat)
        fused, score, attn = cct(enc_feat, transform, retransform, depth_feat)
        dec, tdec = f"LayoutDecoder{suffix}", f"LayoutTransformDecoder{suffix}"
        return {
            "topview": self._trunk(dec, getattr(self, dec), fused),
            "transform_topview": self._trunk(tdec, getattr(self, tdec), transform),
            "features": fused,
            "retransform_features": retransform,
            "cv_attn": score,
            "cm_attn": attn,
        }

    def _pose(self, pair: torch.Tensor):
        pair = pair.contiguous(memory_format=torch.channels_last)
        return self.PoseDecoder(self._trunk("PoseEncoder", self.PoseEncoder, pair))

    def predict_poses(self, color_aug: torch.Tensor) -> dict[str, torch.Tensor]:
        """(B, F, 3, H, W) -> {"cam_T_cam/<f>": (B, 4, 4)}: frames resized
        to 192x640, pair (f, 0) for past frames and (0, f) for future ones,
        past transforms inverted; the pose math runs in fp32 (float64 in a
        float64 model)."""
        ph, pw = POSE_INPUT_HW
        feats = {f: resize_bilinear(color_aug[:, i], ph, pw)
                 for i, f in enumerate(self.frame_ids) if f != "s"}
        out = {}
        for f in self.frame_ids[1:]:
            if f == "s":
                continue  # stereo frame: fixed baseline, no pose net
            pair = [feats[f], feats[0]] if f < 0 else [feats[0], feats[f]]
            axisangle, translation = self._pose(torch.cat(pair, 1))
            out[f"cam_T_cam/{f}"] = transformation_from_parameters(
                at_least_f32(axisangle), at_least_f32(translation), invert=f < 0)
        return out

    def pose_between(self, img_a: torch.Tensor, img_b: torch.Tensor) -> torch.Tensor:
        """Two-frame pose for odometry and video: (B, 3, H, W) x 2 -> (B, 4, 4).

        Like the JAX package's `pose_between`, the pose parameters are NOT
        cast to fp32 first: under bf16 compute the transform is bf16.
        """
        ph, pw = POSE_INPUT_HW
        pair = torch.cat([resize_bilinear(img_a, ph, pw),
                          resize_bilinear(img_b, ph, pw)], 1)
        axisangle, translation = self._pose(pair)
        return transformation_from_parameters(axisangle, translation)

    def forward(self, batch: dict, train: bool | None = None,
                with_pose: bool | None = None,
                generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
        """`train` True or False puts the whole model in that mode first
        (BatchNorm on batch statistics that update the running ones, and
        the depth decoder's dropout, drawn from `generator`); None keeps
        the current mode. `with_pose` None means pose in training only,
        as the JAX `with_pose=None` does."""
        if train is not None:
            self.train(train)
        if with_pose is None:
            with_pose = self.training
        color_aug0 = batch["color_aug"][:, 0].contiguous(
            memory_format=torch.channels_last)
        depth_feats = self._trunk("DepthEncoder", self.DepthEncoder, color_aug0)
        outputs = dict(self._trunk("DepthDecoder", self.DepthDecoder.decode,
                                   self.DepthDecoder.drop(depth_feats, generator)))
        enc_feat = self._trunk("LayoutEncoder", self.LayoutEncoder, color_aug0)
        if self.branches in ("both", "road"):
            outputs.update(self._layout_branch(enc_feat, depth_feats[-1], ""))
        if self.branches in ("both", "vehicle"):
            vehicle = self._layout_branch(enc_feat, depth_feats[-1], "B")
            outputs.update({f"{k}B": v for k, v in vehicle.items()})
        if with_pose:
            outputs.update(self.predict_poses(batch["color_aug"]))
        return {k: v.float() if v.dtype == torch.bfloat16 else v
                for k, v in outputs.items()}


def conv3x3_sites(height: int = 1024, width: int = 1024,
                  occ_map_size: int = 256, branches: str = "both",
                  with_pose: bool = True) -> list[dict]:
    """Every `Conv3x3` site of one B=1 eval forward, in call order, with
    whether K3's gates (both on) pass there and the trunk (`module`, a
    child of the model) it lies in. Found by running the model on PyTorch's
    meta device: shapes only, no data, no card."""
    from ..ops.cuda.conv3x3 import conv_site_eligible
    from .common import Conv3x3

    with torch.device("meta"):
        model = JPerceiver(occ_map_size=occ_map_size, branches=branches)
    sites = []

    trunk = {m: name.split(".")[0] for name, m in model.named_modules()}

    def record(mod, args, _out):
        x, pad = args[0], mod.padding[0]
        h, w = x.shape[2] + 2 * pad - 2, x.shape[3] + 2 * pad - 2
        sites.append({
            "module": trunk[mod], "c_in": mod.in_channels, "c_out": mod.out_channels,
            "h": h, "w": w, "pad": pad, "stride": mod.stride[0],
            "k3": mod.stride == (1, 1) and conv_site_eligible(
                mod.in_channels, mod.out_channels, h, w, True, True)})

    for mod in model.modules():
        if isinstance(mod, Conv3x3):
            mod.register_forward_hook(record)
    model({"color_aug": torch.empty(1, 3, 3, height, width, device="meta")},
          with_pose=with_pose)
    return sites
