"""The multi-task training objective (counterpart of
`jperceiver_tpu/losses/multitask.py`): the BEV layout losses, the CGT
scale loss, the photometric reprojection loss with automasking and the
edge-aware smoothness, per scale, under the JAX package's keys and weights.
`total_loss` sums every entry, so the layout terms count twice, as the
reference's `batch_processor` does.

Tensors are NCHW; every loss is computed in fp32 whatever the compute
dtype of the model. The reprojection stack goes through `reproj_min`, or
with automask `reproj_min_automask`, which gives the identity pairs' losses
from the same launch (kernels K1/K2 on the card), unless
`use_pallas_reproj` is False, when it runs the JAX package's unfused path
in plain PyTorch.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from .. import parallel as dist
from .._device import device_constant
from ..ops.cuda import reproj_min, reproj_min_automask
from ..ops.geometry import backproject, disp_to_depth, project
from ..ops.photometric import reprojection_loss
from ..ops.sampling import grid_sample_multi, resize_area, resize_bilinear
from ..ops.seg_losses import topview_seg_loss
from ..ops.smoothness import edge_aware_smoothness
from ..tracing import mark
from .cgt import cgt_scale_label

# Garg/Eigen crop for full-resolution (375, 1242) KITTI raw.
_GARG_CROP = (153, 371, 44, 1197)


def _masked_abs_rel(pred, gt, mask):
    """The abs-rel over the mask's support of the global batch. Under a
    process group the denominator is the ranks' sum (the mask carries no
    gradient) and the numerator is scaled by the world size, so that DDP's
    average of the ranks' gradients is the gradient of the global ratio."""
    num = ((gt - pred).abs() / gt.clamp_min(1e-6) * mask).sum()
    return num * dist.world_size() / dist.global_sum(mask.sum()).clamp_min(1.0)


def _scale_loss(depth_pred, scale_label, model_type: str):
    """abs-rel against the CGT label over its support."""
    h, w = scale_label.shape[2], scale_label.shape[3]
    depth_pred = resize_bilinear(depth_pred, h, w).clamp(1e-3, 80.0)
    mask = (scale_label > 0).to(depth_pred.dtype)
    if model_type == "static_raw":
        t, b_, l, r = _GARG_CROP
        crop = torch.zeros((h, w), dtype=depth_pred.dtype, device=depth_pred.device)
        crop[t:b_, l:r] = 1.0
        mask = mask * crop
    return _masked_abs_rel(depth_pred, scale_label, mask)


def _warped_frames_all(outputs, batch, scales, frame_ids, height, width,
                       min_depth, max_depth):
    """Monodepth2 image synthesis for every scale: {frame: (B, S, 3, H, W)},
    each source frame sampled at the scales' grids in one `grid_sample`."""
    grids = []
    for scale in scales:
        disp = resize_bilinear(outputs[f"disp/{scale}"], height, width)
        _, depth = disp_to_depth(disp, min_depth, max_depth)
        cam_points = backproject(depth, batch["inv_K"])
        # The stereo frame is warped by the rig's fixed baseline, not a pose.
        grids.append({f: project(cam_points, batch["K"],
                                 batch["stereo_T"] if f == "s" else outputs[f"cam_T_cam/{f}"],
                                 height, width) for f in frame_ids[1:]})
    return {f: grid_sample_multi(batch["color"][:, i],
                                 torch.stack([g[f] for g in grids], 1), "border")
            for i, f in enumerate(frame_ids[1:], start=1)}


def reproj_operand_bf16(cfg, use_kernel: bool, batch_size: int) -> bool:
    """`pallas_reproj_bf16` ("auto": the fused path is on and the batch is
    1), as the JAX package resolves it, so the port computes what the JAX
    flagship computes."""
    v = cfg.get("pallas_reproj_bf16", "auto")
    if v == "auto":
        return bool(use_kernel) and batch_size == 1
    return bool(v)


def compute_losses(outputs: Mapping[str, torch.Tensor],
                   batch: Mapping[str, torch.Tensor], cfg,
                   noise: torch.Tensor | None = None,
                   generator: torch.Generator | None = None) -> dict:
    """The reference-keyed loss dict, every entry a 0-d fp32 tensor.

    outputs: the model's fp32 outputs; batch: the training batch on the
    outputs' device (see `data/synthetic.py`); cfg: anything with
    `.get(key, default)` and the JAX package's keys. The automask
    tie-break noise, 1e-5 x N(0, 1) of shape (S, F-1, B, H, W), is `noise`
    when given, else drawn from `generator`.
    """
    model_type = cfg.get("type")
    frame_ids = tuple(cfg.get("frame_ids"))
    scales = tuple(cfg.get("scales"))
    height, width = cfg.get("height"), cfg.get("width")
    min_depth, max_depth = cfg.get("min_depth"), cfg.get("max_depth")
    loss = {}
    seg_kwargs = dict(loss_type=cfg.get("loss_type", "iou"),
                      loss_sum=int(cfg.get("loss_sum", 1)))
    dev = outputs[f"disp/{scales[0]}"].device

    branches = []
    if model_type in ("static", "static_raw", "Argo_static", "Argo_both"):
        branches.append(("", "static", float(cfg.get("static_weight", 5.0)),
                         float(cfg.get("loss_weightS", cfg.get("loss_weight", 1.0))),
                         float(cfg.get("loss2_weightS", cfg.get("loss2_weight", 1.0)))))
    if model_type in ("dynamic", "Argo_dynamic", "Argo_both"):
        branches.append(("B", "dynamic", float(cfg.get("dynamic_weight", 15.0)),
                         float(cfg.get("loss_weight", 1.0)),
                         float(cfg.get("loss2_weight", 1.0))))
    for sfx, kind, cw, lw, l2w in branches:
        weight = device_constant([1.0, cw], torch.float32, dev)
        labels = batch[f"bev_{kind}"].long()
        sdf = batch.get(f"bev_{kind}_sdf")
        for key in ("topview", "transform_topview"):
            loss[f"{key}_loss{sfx}"] = topview_seg_loss(
                outputs[f"{key}{sfx}"], labels, weight, loss_weight=lw,
                loss2_weight=l2w, sdf=sdf, **seg_kwargs)
        loss[f"transform_loss{sfx}"] = (
            outputs[f"features{sfx}"] - outputs[f"retransform_features{sfx}"]).abs().mean()
        loss[f"layout_loss{sfx}"] = (loss[f"topview_loss{sfx}"]
                                     + 0.001 * loss[f"transform_loss{sfx}"]
                                     + loss[f"transform_topview_loss{sfx}"])

    # ---- CGT scale label
    full_hw = tuple(cfg.get("cgt_label_hw", (375, 1242)))
    cgt_kind = {"static": "static", "static_raw": "static", "Argo_static": "static",
                "dynamic": "dynamic", "Argo_dynamic": "dynamic",
                "Argo_both": "both"}.get(model_type)
    if cgt_kind is None:
        raise ValueError(f"unknown model type {model_type}")
    layout = {"static": batch.get("bev_static"), "dynamic": None,
              "both": batch.get("bev_both")}[cgt_kind]
    mark("cgt", dev)  # the CGT label's phase of the step (`tracing.py`)
    scale_label = cgt_scale_label(
        layout, batch["odometry_K"][:, :3, :3], batch["Tr_cam2_velo"],
        kind=cgt_kind, split=cfg.get("split", "odometry"),
        occ_map_size=cfg.get("occ_map_size"), out_hw=full_hw)
    mark("losses", dev)

    # ---- per-scale depth losses
    target = batch["color"][:, 0]
    automask = bool(cfg.get("automask", True))
    disp_norm = bool(cfg.get("disp_norm", True))
    smoothness_weight = float(cfg.get("smoothness_weight", 1e-3))
    scale_weight = float(cfg.get("scale_weight", 0.1))
    n_scales = len(scales)
    fids = list(frame_ids[1:])
    n_f = len(fids)
    b = target.shape[0]

    all_preds = _warped_frames_all(outputs, batch, scales, frame_ids, height,
                                   width, min_depth, max_depth)
    ident = batch["color"][:, 1:n_f + 1].transpose(0, 1)  # (F, B, 3, H, W)
    use_kernel = cfg.get("use_pallas_reproj", "auto")
    use_kernel = True if use_kernel == "auto" else bool(use_kernel)
    if use_kernel:
        targ = target
        # "auto" reads the global batch, as JAX does on the sharded array.
        if reproj_operand_bf16(cfg, use_kernel, b * dist.world_size()):
            targ = targ.to(torch.bfloat16)
        pstack = torch.stack([all_preds[f] for f in fids], 2)  # (B, S, F, 3, H, W)
        pstack = pstack.transpose(0, 1).to(targ.dtype)
        if automask:
            # The identity pairs' losses (F, B, H, W) come from the same
            # launch; they are pure data, so they get no backward.
            min_warp, ident_l = reproj_min_automask(pstack, ident.to(targ.dtype), targ)
        else:
            min_warp = reproj_min(pstack, targ)
    else:
        if automask:
            with torch.no_grad():
                ident_l = reprojection_loss(ident, target)[:, :, 0]  # (F, B, H, W)
        preds = torch.stack([all_preds[f][:, si] for si in range(n_scales)
                             for f in fids])
        warp_l = reprojection_loss(preds, target)[:, :, 0].reshape(
            n_scales, n_f, b, height, width)
    if automask:
        if noise is None:
            # Drawn for the global batch; this rank keeps its rows.
            noise = dist.rank_rows(lambda shape: torch.randn(
                shape, generator=generator, device=dev), (n_scales, n_f, b, height, width),
                dim=2) * 1e-5

    img_pyr = target
    for si, scale in enumerate(scales):
        disp = outputs[f"disp/{scale}"]
        _, depth = disp_to_depth(disp, min_depth, max_depth)
        if use_kernel:
            min_reconstruct = min_warp[si]
            if automask:
                ident_n = ident_l + noise[si]
                ident_min = ident_n[0]
                for k in range(1, n_f):
                    ident_min = torch.minimum(ident_min, ident_n[k])
                min_reconstruct = torch.minimum(min_reconstruct, ident_min)
        else:
            per_scale = warp_l[si]
            if automask:
                per_scale = torch.cat([ident_l + noise[si], per_scale], 0)
            min_reconstruct = per_scale.amin(0)
        loss[f"min_reconstruct_loss/{scale}"] = min_reconstruct.mean() / n_scales
        loss[f"scale_loss/{scale}"] = (
            scale_weight * _scale_loss(depth, scale_label, model_type)
            / (2 ** scale) / n_scales)
        if disp_norm:
            disp = disp / (disp.mean((2, 3), keepdim=True) + 1e-7)
        dh, dw = disp.shape[2], disp.shape[3]
        while (img_pyr.shape[2] > dh and img_pyr.shape[2] % 2 == 0
               and (img_pyr.shape[2] // 2) % dh == 0):
            img_pyr = resize_area(img_pyr, img_pyr.shape[2] // 2, img_pyr.shape[3] // 2)
        smooth = edge_aware_smoothness(
            disp, img_pyr if tuple(img_pyr.shape[2:]) == (dh, dw) else target)
        loss[f"smooth_loss/{scale}"] = smoothness_weight * smooth / (2 ** scale) / n_scales
    return loss


def total_loss(loss_dict: Mapping[Any, torch.Tensor]) -> torch.Tensor:
    """The sum of every entry, layout double count included."""
    return sum(loss_dict.values())
