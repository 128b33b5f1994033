"""Checkpoints of a training run, and weights from PyTorch files
(counterpart of `jperceiver_tpu/engine/checkpoint.py`).

A checkpoint is one `torch.save` file, `<work_dir>/checkpoints/epoch_<N>.pth`
for the run after N epochs, holding what a `TrainStep` needs to go on as if
it had not stopped: `state_dict` (the model's, under the reference
`Baseline` keys, so the file also loads into the reference's `Baseline`),
`optimizer` (its state dict), `iteration` (the steps the LR schedule has
counted), `generator` (the state of dropout's and the automask noise's
generator) and `epoch`. It is written to a temporary file and moved into
place, so a crash never leaves a half-written checkpoint under the name.

The reference's three load modes, as `tools/train.py` offers them:
  resume   -- `restore_checkpoint`: the whole state, into the live step;
  load     -- `load_weights(strict=True)`: the model's weights only;
  finetune -- `load_weights(strict=False)`: the weights whose name and shape
              match, the rest kept as initialised.

`import_torch_resnet` / `apply_pretrained_encoders` initialise the three
ResNet trunks from local torchvision-style `.pth` files (the pose trunk's
`conv1` tiled over its two frames and halved), and
`load_torch_baseline_file` loads a reference `Baseline` checkpoint. The
port's module names are the reference keys, so the JAX package's
`import_torch_baseline` / `export_torch_baseline` are the identity here.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Any

import torch

_CKPT_DIR = "checkpoints"
_NAME = re.compile(r"^epoch_(\d+)\.pth$")
_log = logging.getLogger("jperceiver_tpu_torch")


def checkpoint_path(work_dir: str, epoch: int) -> str:
    return os.path.join(work_dir, _CKPT_DIR, f"epoch_{epoch}.pth")


def _epochs(work_dir: str) -> list[int]:
    d = os.path.join(work_dir, _CKPT_DIR)
    if not os.path.isdir(d):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(d) if (m := _NAME.match(f)))


def latest_epoch(work_dir: str) -> int | None:
    """The epoch of the newest checkpoint under `work_dir`, or None."""
    epochs = _epochs(work_dir)
    return epochs[-1] if epochs else None


def save_checkpoint(work_dir: str, step, epoch: int, max_to_keep: int = 5) -> str:
    """Write the state of `step` (a `TrainStep`) after `epoch` epochs, and
    delete all but the newest `max_to_keep` checkpoints. Returns the path.

    Under a process group every rank calls it: a ZeRO-1 optimizer first
    gathers its shards to rank 0 (a collective), rank 0 alone writes, and
    a barrier holds every rank until the file is in place. The model is
    saved as the module, under the `Baseline` keys (no DDP `module.`)."""
    from ..parallel import barrier, rank

    path = checkpoint_path(work_dir, epoch)
    opt = step.optimizer
    if hasattr(opt, "consolidate_state_dict"):  # ZeroRedundancyOptimizer
        opt.consolidate_state_dict(to=0)
    if rank() == 0:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        payload = {
            "state_dict": step.model.state_dict(),
            "optimizer": opt.state_dict(),
            "iteration": step.iteration,
            "generator": step.generator.get_state(),
            "epoch": epoch,
        }
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in _epochs(work_dir)[:-max_to_keep] if max_to_keep > 0 else []:
            os.remove(checkpoint_path(work_dir, old))
    barrier()
    return path


def _load(path: str, device) -> dict:
    return torch.load(path, map_location=device, weights_only=True)


def restore_checkpoint(work_dir: str, step, epoch: int | None = None) -> int:
    """Restore the model, optimizer, iteration and generator of `step` in
    place from the checkpoint of `epoch` (default: the newest) under
    `work_dir`; returns its epoch. Raises FileNotFoundError when there is
    none. Under a process group every rank restores from the same file (a
    ZeRO-1 optimizer keeps its own share of the state). The step's CUDA
    graphs are dropped: the optimizer's restored state lives in new
    tensors, so the next step at each shape runs eagerly and captures
    again."""
    epoch = latest_epoch(work_dir) if epoch is None else epoch
    if epoch is None or not os.path.isfile(checkpoint_path(work_dir, epoch)):
        raise FileNotFoundError(f"no checkpoint under {work_dir}"
                                + ("" if epoch is None else f" for epoch {epoch}"))
    ck = _load(checkpoint_path(work_dir, epoch), step.device)
    step.model.load_state_dict(ck["state_dict"])
    step.optimizer.load_state_dict(ck["optimizer"])
    step.iteration = int(ck["iteration"])
    step.generator.set_state(ck["generator"].cpu())
    if hasattr(step, "graphs"):
        step.graphs.clear()
    return int(ck["epoch"])


def _model(target) -> torch.nn.Module:
    """A `TrainStep`'s model, or the module itself."""
    return getattr(target, "model", target)


def merge_matching(model: torch.nn.Module, loaded: dict) -> tuple[int, list[str]]:
    """Load the entries of `loaded` whose name and shape match an entry of
    the model's state dict; the rest of the model keeps its values. Returns
    (entries loaded, names skipped), the semantics of torch
    `load_state_dict(strict=False)` that `_merge_matching` of the JAX
    package gives its trees. (`load_state_dict(strict=False)` itself still
    raises on a shape mismatch, so the entries are filtered first.)"""
    current = model.state_dict()
    keep, skipped = {}, []
    for name, value in loaded.items():
        tgt = current.get(name)
        if tgt is not None and tuple(tgt.shape) == tuple(value.shape):
            keep[name] = value
        else:
            skipped.append(name)
    model.load_state_dict(keep, strict=False)
    return len(keep), skipped


def _weights_file(work_dir_or_path: str, epoch: int | None) -> str:
    if os.path.isfile(work_dir_or_path):
        return work_dir_or_path
    epoch = latest_epoch(work_dir_or_path) if epoch is None else epoch
    if epoch is None:
        raise FileNotFoundError(f"no checkpoint under {work_dir_or_path}")
    return checkpoint_path(work_dir_or_path, epoch)


def load_weights(work_dir_or_path: str, target, epoch: int | None = None,
                 strict: bool = True) -> list[str]:
    """Weights-only load into `target` (a `TrainStep` or a model) from a
    checkpoint file, or the checkpoint of `epoch` (default: the newest) of a
    work dir. The optimizer, iteration and generator are left as they are.

    strict=True  -- `load_from`: the names and shapes must match exactly.
    strict=False -- `finetune`: the entries whose name and shape match are
                    loaded, the rest keep their initialisation; the skipped
                    names are logged and returned.
    """
    model = _model(target)
    sd = _load(_weights_file(work_dir_or_path, epoch), "cpu")
    sd = sd.get("state_dict", sd)
    if strict:
        model.load_state_dict(sd)
        return []
    n, skipped = merge_matching(model, sd)
    if skipped:
        _log.info("finetune load: %d entries loaded, %d skipped", n, len(skipped))
    return skipped


# ---------------------------------------------------------------------------
# Weights from PyTorch files
# ---------------------------------------------------------------------------

_RESNET_KEY = re.compile(
    r"^(conv1\.weight|bn1\.(weight|bias|running_mean|running_var)|"
    r"layer\d\.\d+\.(conv\d\.weight|bn\d\.(weight|bias|running_mean|running_var)|"
    r"downsample\.0\.weight|downsample\.1\.(weight|bias|running_mean|running_var)))$")
# The trunks `apply_pretrained_encoders` fills: config key, frames a trunk
# reads, the trunk's prefix in the model's state dict.
_TRUNKS = (("depth_pretrained_path", 1, "DepthEncoder.encoder."),
           ("pose_pretrained_path", 2, "PoseEncoder.encoder."),
           ("layout_pretrained_path", 1, "LayoutEncoder.resnet_encoder.encoder."))


def import_torch_resnet(state_dict: dict, num_input_images: int = 1) -> dict[str, torch.Tensor]:
    """A torchvision ResNet state dict -> the entries of the port's ResNet
    trunk (the same names, whatever the depth; `fc` and the BatchNorm
    counters dropped). For the pose trunk (`num_input_images=2`) `conv1`'s
    weight is tiled over the frames and divided by their count, as the
    reference does (`pose_encoder.py:47`)."""
    out = {k: torch.as_tensor(v).detach().cpu() for k, v in state_dict.items()
           if _RESNET_KEY.match(k)}
    if num_input_images > 1:
        out["conv1.weight"] = torch.cat([out["conv1.weight"]] * num_input_images,
                                        1) / num_input_images
    return out


def load_torch_resnet_file(path: str, num_input_images: int = 1) -> dict[str, torch.Tensor]:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return import_torch_resnet(sd, num_input_images)


def apply_pretrained_encoders(target, model_cfg) -> Any:
    """Initialise the ResNet trunks from local `.pth` files, as the config's
    `depth_pretrained_path` / `pose_pretrained_path` /
    `layout_pretrained_path` say (the layout trunk defaults to the depth
    file: the reference's layout trunk is ImageNet-pretrained). Raises if a
    file's entries do not all match the trunk. Returns `target`."""
    model = _model(target)
    paths = {"depth_pretrained_path": model_cfg.get("depth_pretrained_path"),
             "pose_pretrained_path": model_cfg.get("pose_pretrained_path")}
    paths["layout_pretrained_path"] = model_cfg.get("layout_pretrained_path",
                                                    paths["depth_pretrained_path"])
    if not paths["layout_pretrained_path"] and any(paths.values()):
        _log.warning("pretrained init: layout_pretrained_path resolves to None while "
                     "other pretrained paths are set -- layout trunk stays random "
                     "(reference uses ImageNet weights there)")
    for key, n_images, prefix in _TRUNKS:
        path = paths[key]
        if not path:
            continue
        sd = load_torch_resnet_file(path, n_images)
        _, skipped = merge_matching(model, {prefix + k: v for k, v in sd.items()})
        if skipped:
            raise ValueError(f"pretrained init from {path}: {len(skipped)} mismatched "
                             f"entries, e.g. {skipped[:3]}")
    return target


def load_torch_baseline_file(path: str, target) -> list[str]:
    """Load a reference-format `Baseline` `.pth` into `target` (a
    `TrainStep` or a model): a raw state dict or an mmcv-style
    `{'state_dict': ...}` wrapper, with or without DDP's `module.` prefix.
    Entries whose name and shape match are loaded; the skipped names (the
    reference's dead `res_conv`, a branch the model does not have) are
    logged and returned."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    n, skipped = merge_matching(_model(target), sd)
    if skipped:
        _log.warning("torch baseline load: %d entries loaded, %d skipped", n, len(skipped))
    return skipped
