"""Weight bridge: the JAX package's flax trees -> this port's state_dict.

The port's own copy of the mapping of
`jperceiver_tpu/engine/checkpoint.py::export_torch_baseline`. Its keys are
those of the reference `Baseline`, which the port's module names follow, so
the result loads with `JPerceiver.load_state_dict` -- strictly for a
both-branch tree, with `strict=False` for a single-branch one, whose
inactive branch has no subtree -- and reference `.pth` files load the same
way.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_ROOTS = {
    "depth_encoder": "DepthEncoder",
    "depth_decoder": "DepthDecoder",
    "pose_encoder": "PoseEncoder",
    "pose_decoder": "PoseDecoder",
    "layout_encoder": "LayoutEncoder",
    "cvp": "CycledViewProjection",
    "cct": "CrossViewTransformer",
    "layout_decoder": "LayoutDecoder",
    "layout_transform_decoder": "LayoutTransformDecoder",
    "cvp_b": "CycledViewProjectionB",
    "cct_b": "CrossViewTransformerB",
    "layout_decoder_b": "LayoutDecoderB",
    "layout_transform_decoder_b": "LayoutTransformDecoderB",
}

# Layout decoders: flax name -> index in the reference's ModuleList.
_DECODER_INDEX = {"topview": 25}
for _level in range(5):
    _base = (4 - _level) * 5
    _DECODER_INDEX.update({
        f"upconv_{_level}_0": _base, f"norm_{_level}_0": _base + 1,
        f"upconv_{_level}_1": _base + 3, f"norm_{_level}_1": _base + 4})

_RENAMES = (
    (re.compile(r"layer(\d)_(\d+)$"), r"layer\1.\2"),
    (re.compile(r"downsample_conv$"), "downsample.0"),
    (re.compile(r"downsample_bn$"), "downsample.1"),
    (re.compile(r"pointwise(\d)$"), r"0.\1_pointwise.conv"),
    (re.compile(r"disp(\d)$"), r"disp\1.0"),
    (re.compile(r"fc1$"), "fc_transform.0"),
    (re.compile(r"fc2$"), "fc_transform.2"),
    (re.compile(r"resnet_encoder$"), "resnet_encoder.encoder"),
)


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _module_key(path: tuple) -> str:
    """Flax module path -> reference module key."""
    root, *rest = path
    names = [_ROOTS[root]]
    if _ROOTS[root].startswith("Layout") and "Decoder" in _ROOTS[root]:
        names.append(f"decoder.{_DECODER_INDEX[rest[0]]}")
        rest = rest[1:]
    for name in rest:
        for pattern, repl in _RENAMES:
            if pattern.match(name):
                name = pattern.sub(repl, name)
                break
        names.append(name)
    return ".".join(names)


def state_dict_from_jax(params: dict, batch_stats: dict) -> dict[str, torch.Tensor]:
    """Flax (params, batch_stats) of `jperceiver_tpu`'s JPerceiver -> the
    port's state_dict (fp32 tensors; BatchNorm counters are 0)."""
    out: dict[str, np.ndarray] = {}
    for path, v in _flatten(params).items():
        key, leaf = _module_key(path[:-1]), path[-1]
        if leaf == "kernel":  # HWIO -> OIHW; Dense (in, out) -> (out, in)
            out[f"{key}.weight"] = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
        elif leaf == "scale":
            out[f"{key}.weight"] = v
        elif leaf == "bias":
            out[f"{key}.bias"] = v
        else:
            raise KeyError(f"state_dict_from_jax: unknown leaf {'/'.join(path)}")
    for path, v in _flatten(batch_stats).items():
        key, leaf = _module_key(path[:-1]), path[-1]
        if leaf not in ("mean", "var"):
            raise KeyError(f"state_dict_from_jax: unknown stat {'/'.join(path)}")
        out[f"{key}.running_{leaf}"] = v
        out[f"{key}.num_batches_tracked"] = np.zeros((), np.int64)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}
