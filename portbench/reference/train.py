"""The plain reference of the training step, the eval step and streaming.

The training step: the model's forward in training mode, the objective
(`losses.py`), the backward, the clip of the global gradient norm and
Adam, in plain PyTorch: `torch.linalg.vector_norm`, then per parameter
m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2, p -= lr m^ / (sqrt(v^) + eps).
"""

from __future__ import annotations

import contextlib

import torch

from . import losses as L
from .model import STAGES, ReferenceModel, transformation_from_parameters


def first_output_keys(frame_ids) -> tuple:
    """The outputs of a training step's first forward that are compared:
    the four disparities and the pose of each source frame."""
    return ("disp/0", "disp/1", "disp/2", "disp/3",
            *(f"cam_T_cam/{f}" for f in frame_ids[1:]))


def structure(model_cfg: dict) -> tuple[int, int, str]:
    """(depth_layers, pose_layers, branches) of a model configuration, read
    as the program's `JPerceiver.from_config` reads them: each ResNet depth
    from `depth_num_layers` and `pose_num_layers`, 18 where absent; with
    `skip_inactive_branch` (true where absent) the branch that the `type`
    has losses for ("road" for the static types, "vehicle" for the dynamic
    ones, "both" for any other), else both. Raises ValueError, naming the
    key, where the reference cannot compute what the configuration asks
    for: a depth outside `STAGES`, or the vehicle branch alone (the
    objective has no vehicle-only losses)."""
    depths = []
    for key in ("depth_num_layers", "pose_num_layers"):
        depth = model_cfg.get(key, 18)
        if depth not in STAGES:
            raise ValueError(f"{key} = {depth!r}: the reference builds ResNet depths "
                             f"{sorted(STAGES)}")
        depths.append(depth)
    kind = model_cfg.get("type", "static")
    if not model_cfg.get("skip_inactive_branch", True):
        branches = "both"
    elif kind in ("static", "static_raw", "Argo_static"):
        branches = "road"
    elif kind in ("dynamic", "Argo_dynamic"):
        raise ValueError(f"type = {kind!r}: the reference has no losses for the vehicle "
                         "branch alone")
    else:
        branches = "both"
    return depths[0], depths[1], branches


def meta_model(model_cfg: dict, remat: bool = False) -> ReferenceModel:
    """The reference model of a model configuration on the meta device:
    shapes, no data."""
    depth_layers, pose_layers, branches = structure(model_cfg)
    with torch.device("meta"):
        return ReferenceModel(model_cfg["occ_map_size"], branches, tuple(model_cfg["frame_ids"]),
                              remat, depth_layers=depth_layers, pose_layers=pose_layers)


def build(model_cfg: dict, weights: dict, device, remat: bool = False) -> ReferenceModel:
    """The reference model of a model configuration with `weights` (fp32)."""
    model = meta_model(model_cfg, remat).to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model


@contextlib.contextmanager
def exact():
    """TF32 off, as it was after: the reference computes in fp32."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


@torch.no_grad()
def calibrated_weights(model_cfg: dict, weights: dict, color_aug: torch.Tensor,
                       gen_seed: int) -> dict:
    """`weights` as a trained model carries them, from one training-mode
    forward of the reference over `color_aug` (B, F, 3, H, W): the
    BatchNorm running statistics of that batch, so that the eval forward's
    activations keep their scale, and each disparity head's convolution
    rescaled so that its logits have mean 0 and deviation 1 there. With
    seeded weights alone the depth decoder's sums put the heads' logits
    past +-5, where every precision rounds the sigmoid to the same value."""
    model = build(model_cfg, weights, color_aug.device)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 1.0
    heads = {f"DepthDecoder.disp{i}.0.conv": getattr(model.DepthDecoder, f"disp{i}")[0].conv
             for i in (1, 2, 3, 4)}
    moments = {}
    hooks = [conv.register_forward_hook(
        lambda mod, args, out, name=name: moments.__setitem__(name, (out.mean(), out.std())))
        for name, conv in heads.items()]
    model.train()
    gen = torch.Generator(device=color_aug.device).manual_seed(gen_seed)
    with exact():
        model(color_aug, with_pose=True, generator=gen)
    for h in hooks:
        h.remove()
    out = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for name, (mean, std) in moments.items():
        out[f"{name}.weight"] /= std
        out[f"{name}.bias"] = (out[f"{name}.bias"] - mean) / std
    return out


def shapes(model_cfg: dict) -> dict:
    """{name: shape} of the model's state dict."""
    return {k: tuple(v.shape) for k, v in meta_model(model_cfg).state_dict().items()}


class Adam:
    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8, max_norm=None):
        self.params, self.lr, self.b1, self.b2, self.eps = params, lr, b1, b2, eps
        self.max_norm = max_norm
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self):
        grads = [p.grad for p in self.params]
        if self.max_norm is not None:
            norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
            if norm > self.max_norm:
                for g in grads:
                    g.mul_(self.max_norm / norm)
        self.t += 1
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            mh = m / (1 - self.b1 ** self.t)
            vh = v / (1 - self.b2 ** self.t)
            p.sub_(self.lr * mh / (vh.sqrt() + self.eps))


def train_readings(model: ReferenceModel, cfg: dict, batches: list, gen_seed: int,
                   device) -> dict:
    """Runs one training step on each batch and reads: `loss` (each step's
    total), `scale` (the sum of its terms' magnitudes), `outputs` (step 1's
    forward, `first_output_keys`), `grad` (each parameter's gradient norm as Adam got it at step
    1, from its first moment) and `change` (each parameter's distance from
    its start after the last step), by parameter name."""
    model.train()
    names = [n for n, p in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    start = [p.detach().clone() for p in params]
    clip = (cfg.get("optimizer_config") or {}).get("grad_clip") or {}
    opt = Adam(params, float(cfg["optimizer"]["lr"]), max_norm=clip.get("max_norm"))
    gen = torch.Generator(device=device).manual_seed(gen_seed)
    out = {"loss": [], "scale": [], "grad": None, "change": None, "outputs": None}
    for i, batch in enumerate(batches):
        for p in params:
            p.grad = None
        outputs = model(batch["color_aug"], with_pose=True, generator=gen)
        terms = L.losses(outputs, batch, cfg["model"], gen)
        loss = sum(terms.values())
        loss.backward()
        opt.step()
        out["loss"].append(float(loss.detach()))
        out["scale"].append(float(sum(t.detach().abs() for t in terms.values())))
        if i == 0:
            out["outputs"] = {k: outputs[k].detach().cpu()
                              for k in first_output_keys(model.frame_ids)}
            out["grad"] = dict(zip(names, [float(m.norm()) / (1 - opt.b1) for m in opt.m]))
        del outputs, loss
    with torch.no_grad():
        out["change"] = {n: float((p - s).norm()) for n, p, s in zip(names, params, start)}
    return out


@torch.no_grad()
def first_outputs(model: ReferenceModel, batch: dict, gen_seed: int) -> dict:
    """The outputs of step 1's forward (training mode, the same dropout
    draws), without the step."""
    model.train()
    gen = torch.Generator(device=batch["color"].device).manual_seed(gen_seed)
    outputs = model(batch["color_aug"], with_pose=True, generator=gen)
    return {k: outputs[k].cpu() for k in first_output_keys(model.frame_ids)}


@torch.no_grad()
def eval_outputs(model: ReferenceModel, color_aug: torch.Tensor) -> dict:
    """The eval step's outputs of one request (B, F, 3, H, W), with pose."""
    model.eval()
    return model(color_aug, with_pose=True)


def rigid_inverse(t: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(t)
    r = t[:, :3, :3].transpose(1, 2)
    out[:, :3, :3] = r
    out[:, :3, 3:] = -r @ t[:, :3, 3:]
    out[:, 3, 3] = 1.0
    return out


@torch.no_grad()
def stream_outputs(model: ReferenceModel, clip: torch.Tensor, keys, chunk: int = 8) -> dict:
    """Streaming over a clip (T, 3, H, W): for each frame after the first,
    `disp` (the depth decoder's finest), the layouts, `cam_T_cam` (the pose
    of the frame against the one before) and `global_pose`, the product of
    the inverted poses from the identity on."""
    model.eval()
    outs = {k: [] for k in keys}
    g = torch.eye(4, device=clip.device)
    for start in range(1, clip.shape[0], chunk):
        seg = clip[start:start + chunk]
        prev = clip[start - 1:start - 1 + seg.shape[0]]
        y = model(seg[:, None], with_pose=False)
        t = transformation_from_parameters(*model.pose(prev, seg))
        for k in keys:
            if k == "disp":
                outs[k].append(y["disp/0"])
            elif k in y:
                outs[k].append(y[k])
        outs["cam_T_cam"].append(t)
        for ti in t:
            g = g @ rigid_inverse(ti[None])[0]
            outs["global_pose"].append(g[None])
    return {k: torch.cat(v) for k, v in outs.items() if v}
