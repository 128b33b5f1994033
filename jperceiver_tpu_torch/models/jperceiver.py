"""JPerceiver: joint depth + pose + dual BEV layout, eval forward
(counterpart of `jperceiver_tpu/models/jperceiver.py`).

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

from typing import Sequence

import torch
import torch.nn as nn

from ..ops.geometry import transformation_from_parameters
from ..ops.sampling import resize_bilinear
from .depth_net import DepthDecoder, DepthEncoder
from .layout_net import (CrossViewTransformer, CycledViewProjection,
                         LayoutDecoder, LayoutEncoder)
from .pose_net import PoseDecoder, PoseEncoder
from .resnet import num_ch_enc

POSE_INPUT_HW = (192, 640)  # pose inputs are resized to this


class JPerceiver(nn.Module):
    """The eval forward. The input size is free (a multiple of 128 with
    `occ_map_size` = height / 4, as in the JAX package); `occ_map_size`
    sizes the CVP, `branches` picks the BEV branches ("both", "road",
    "vehicle"), `dtype` is the compute dtype (parameters stay fp32)."""

    def __init__(self, depth_layers: int = 18, pose_layers: int = 18,
                 frame_ids: Sequence[int] = (0, -1, 1),
                 occ_map_size: int = 256, num_class: int = 2,
                 dtype: torch.dtype = torch.float32, branches: str = "both"):
        super().__init__()
        if branches not in ("both", "road", "vehicle"):
            raise ValueError(f"branches must be both/road/vehicle, got {branches}")
        self.frame_ids = tuple(frame_ids)
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

    def _layout_branch(self, enc_feat, depth_feat, suffix):
        cvp = getattr(self, f"CycledViewProjection{suffix}")
        cct = getattr(self, f"CrossViewTransformer{suffix}")
        transform, retransform = cvp(enc_feat)
        fused, score, attn = cct(enc_feat, transform, retransform, depth_feat)
        return {
            "topview": getattr(self, f"LayoutDecoder{suffix}")(fused),
            "transform_topview":
                getattr(self, f"LayoutTransformDecoder{suffix}")(transform),
            "features": fused,
            "retransform_features": retransform,
            "cv_attn": score,
            "cm_attn": attn,
        }

    def _pose(self, pair: torch.Tensor):
        pair = pair.contiguous(memory_format=torch.channels_last)
        return self.PoseDecoder(self.PoseEncoder(pair))

    def predict_poses(self, color_aug: torch.Tensor) -> dict[str, torch.Tensor]:
        """(B, F, 3, H, W) -> {"cam_T_cam/<f>": (B, 4, 4)}: frames resized
        to 192x640, pair (f, 0) for past frames and (0, f) for future ones,
        past transforms inverted; the pose math runs in fp32."""
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
                axisangle.float(), translation.float(), invert=f < 0)
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

    def forward(self, batch: dict, with_pose: bool = False) -> dict[str, torch.Tensor]:
        color_aug0 = batch["color_aug"][:, 0].contiguous(
            memory_format=torch.channels_last)
        depth_feats = self.DepthEncoder(color_aug0)
        outputs = dict(self.DepthDecoder(depth_feats))
        enc_feat = self.LayoutEncoder(color_aug0)
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
    whether K3's gates (both on) pass there. Found by running the model on
    PyTorch's meta device: shapes only, no data, no card."""
    from ..ops.cuda.conv3x3 import conv_site_eligible
    from .common import Conv3x3

    with torch.device("meta"):
        model = JPerceiver(occ_map_size=occ_map_size, branches=branches)
    sites = []

    def record(mod, args, _out):
        x, pad = args[0], mod.padding[0]
        h, w = x.shape[2] + 2 * pad - 2, x.shape[3] + 2 * pad - 2
        sites.append({
            "c_in": mod.in_channels, "c_out": mod.out_channels,
            "h": h, "w": w, "pad": pad, "stride": mod.stride[0],
            "k3": mod.stride == (1, 1) and conv_site_eligible(
                mod.in_channels, mod.out_channels, h, w, True, True)})

    for mod in model.modules():
        if isinstance(mod, Conv3x3):
            mod.register_forward_hook(record)
    model({"color_aug": torch.empty(1, 3, 3, height, width, device="meta")},
          with_pose=with_pose)
    return sites
