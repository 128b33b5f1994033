"""Weights and inputs made from the run's seed, on the device, in a few
large calls. The same seed gives the same tensors; the program and the
reference are handed the same ones.

Inputs follow the layout of the training batch (`color`, `color_aug`
(B, F, 3, H, W) in [0, 1]; `K`, `inv_K`, `odometry_K`, `Tr_cam2_velo`
(B, 4, 4); `bev_static`, `bev_dynamic` (B, S, S) labels; `bev_both`
(B, S, S); `bev_static_sdf`, `bev_dynamic_sdf` (B, 1, S, S)). Every row
differs: its images, its road and its vehicles.
"""

from __future__ import annotations

import numpy as np
import torch

_MIX = 0x9E3779B97F4A7C15


def stream_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one named stream of draws under the run's seed."""
    h = int(seed) & (2 ** 64 - 1)
    for p in path:
        h = ((h ^ (int(p) + _MIX)) * 0xBF58476D1CE4E5B9) & (2 ** 64 - 1)
        h ^= h >> 31
    return h & (2 ** 63 - 1)


def generator(device, seed: int, *path: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, *path))


def make_weights(shapes: dict, seed: int, device) -> dict:
    """A state dict for `shapes` ({name: shape} of the parameters and
    buffers): conv and linear weights N(0, 1 / fan_in) from one draw,
    biases 0, BatchNorm scales 1 and shifts 0, running statistics 0 and 1."""
    weights = [k for k, s in shapes.items() if k.endswith(".weight") and len(s) >= 2]
    total = sum(int(np.prod(shapes[k])) for k in weights)
    flat = torch.randn(total, generator=generator(device, seed, 1), device=device)
    out, at = {}, 0
    for k, shape in shapes.items():
        if k in weights:
            n = int(np.prod(shape))
            fan_in = n // shape[0]
            out[k] = flat[at:at + n].view(shape).mul_(fan_in ** -0.5)
            at += n
        elif k.endswith("num_batches_tracked"):
            out[k] = torch.zeros(shape, dtype=torch.long, device=device)
        elif k.endswith(".weight") or k.endswith("running_var"):
            out[k] = torch.ones(shape, device=device)
        else:
            out[k] = torch.zeros(shape, device=device)
    return out


def model_weights(model_cfg: dict, seed: int, device) -> dict:
    """The state dict both sides get: `make_weights` calibrated on a seeded
    batch of two frame triples (`reference/train.py::calibrated_weights`)."""
    from portbench.reference import train as ref

    m = model_cfg
    color_aug = frames((2, len(m["frame_ids"]), 3, m["height"], m["width"]), seed, 90,
                       device)[1]
    return ref.calibrated_weights(m, make_weights(ref.shapes(m), seed, device), color_aug,
                                  stream_seed(seed, 91))


def _sdf(labels: np.ndarray) -> np.ndarray:
    """Signed distance of class 1 of each (S, S) map: negative inside,
    positive outside, 0 on its inner boundary; (B, 1, S, S)."""
    from scipy.ndimage import binary_erosion, distance_transform_edt

    out = np.zeros((labels.shape[0], 1) + labels.shape[1:], np.float32)
    for i, lab in enumerate(labels):
        pos = lab == 1
        if pos.any():
            sdf = distance_transform_edt(~pos) - distance_transform_edt(pos)
            inner = pos & ~binary_erosion(pos, np.ones((3, 3), bool), border_value=0)
            sdf[inner] = 0.0
            out[i, 0] = sdf
    return out


def bev_layouts(batch: int, size: int, seed: int, index: int):
    """Road and vehicle maps (B, S, S) int64: a road band of random width
    and start ahead of the car, and 1 to 4 vehicles, per row."""
    rng = np.random.default_rng(stream_seed(seed, 2, index))
    road = np.zeros((batch, size, size), np.int64)
    cars = np.zeros((batch, size, size), np.int64)
    for b in range(batch):
        top = rng.integers(0, size // 3)
        half = rng.integers(size // 10, size // 4)
        centre = size // 2 + rng.integers(-size // 10, size // 10 + 1)
        road[b, top:, max(centre - half, 0):centre + half] = 1
        for _ in range(rng.integers(1, 5)):
            y, x = rng.integers(0, size - size // 16, 2)
            cars[b, y:y + rng.integers(size // 64, size // 16) + 1,
                 x:x + rng.integers(size // 64, size // 32) + 1] = 1
    return road, cars


def frames(shape, seed: int, index: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """`color` uniform in [0, 1) and `color_aug` = clip(color + N(0, 0.02))."""
    g = generator(device, seed, 3, index)
    color = torch.rand(shape, generator=g, device=device)
    aug = (color + 0.02 * torch.randn(shape, generator=g, device=device)).clamp_(0, 1)
    return color, aug


def intrinsics(batch: int, height: int, width: int, device) -> dict:
    """The normalised-K convention of the KITTI loaders at the input size,
    and KITTI odometry's calibration for the CGT label."""
    K = torch.tensor([[0.58 * width, 0, 0.5 * width, 0], [0, 1.92 * height, 0.5 * height, 0],
                      [0, 0, 1, 0], [0, 0, 0, 1]], dtype=torch.float64)
    odo = torch.tensor([[707.09, 0.0, 601.89, 0.0], [0.0, 707.09, 183.11, 0.0],
                        [0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]])
    tr = torch.tensor([[0.0, -1.0, 0.0, -0.01], [0.0, 0.0, -1.0, -0.075],
                       [1.0, 0.0, 0.0, -0.27], [0.0, 0.0, 0.0, 1.0]])

    def rows(m):
        return m.float()[None].expand(batch, 4, 4).contiguous().to(device)

    return {"K": rows(K), "inv_K": rows(torch.linalg.inv(K)), "odometry_K": rows(odo),
            "Tr_cam2_velo": rows(tr)}


def train_batch(model_cfg: dict, batch: int, seed: int, index: int, device) -> dict:
    """Training batch `index` of the run."""
    h, w, s = model_cfg["height"], model_cfg["width"], model_cfg["occ_map_size"]
    n_f = len(model_cfg["frame_ids"])
    color, aug = frames((batch, n_f, 3, h, w), seed, index, device)
    road, cars = bev_layouts(batch, s, seed, index)
    out = {"color": color, "color_aug": aug, **intrinsics(batch, h, w, device),
           "bev_static": torch.from_numpy(road).to(device),
           "bev_dynamic": torch.from_numpy(cars).to(device),
           "bev_both": torch.from_numpy(road).float().to(device),
           "bev_static_sdf": torch.from_numpy(_sdf(road)).to(device),
           "bev_dynamic_sdf": torch.from_numpy(_sdf(cars)).to(device)}
    return out
