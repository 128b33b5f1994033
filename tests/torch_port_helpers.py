"""Shared helpers of the parity tests between `jperceiver_tpu` (JAX, the
reference) and its PyTorch port `jperceiver_tpu_torch`.

Inputs and weights are made with numpy from a seed and handed to both
packages; flax trees reach the port through the port's weight bridge.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from jperceiver_tpu_torch.convert import state_dict_from_jax


def random_variables(module, *args, seed: int = 0, **kwargs) -> dict:
    """Random {"params", "batch_stats"} for a flax module, as numpy.

    Shapes come from `jax.eval_shape` of its init (no compile). Kernels are
    N(0, 1/fan_in), biases N(0, 0.1^2), BN scales U(0.5, 1.5); running means
    N(0, 0.1^2) and variances U(0.5, 1.5), so eval BN is far from the
    identity a fresh init gives.
    """
    shapes = jax.eval_shape(
        lambda: module.init({"params": jax.random.key(0),
                             "dropout": jax.random.key(1)}, *args, **kwargs))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("bias", "mean"):
            v = 0.1 * rng.standard_normal(shape)
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, shape)
        else:
            raise KeyError(name)
        return v.astype(np.float32)

    out = jax.tree_util.tree_map_with_path(fill, shapes)
    return {"params": out["params"], "batch_stats": out.get("batch_stats", {})}


def load_port(module: torch.nn.Module, variables: dict, root: tuple,
              prefix: str) -> torch.nn.Module:
    """Load a sub-tree of flax variables into a port module through the
    bridge: the tree is hung at `root` of the JPerceiver tree, and the keys
    under `prefix` of the bridged state_dict are loaded strictly."""
    def hang(tree):
        for name in reversed(root):
            tree = {name: tree}
        return tree

    sd = state_dict_from_jax(hang(variables["params"]),
                             hang(variables["batch_stats"]))
    sub = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    module.load_state_dict(sub, strict=True)
    return module.eval()


def nchw(a) -> torch.Tensor:
    """NHWC numpy/JAX array -> NCHW torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    """NCHW torch tensor -> NHWC numpy array."""
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def assert_close(got, want, rel: float, what: str = "") -> None:
    """max |got - want| <= rel * max(1, max |want|)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    assert err <= rel * scale, f"{what}: max abs err {err} > {rel} * {scale}"
