"""Ordered frames from a flat image directory, for inference (the port's
own copy of `jperceiver_tpu/data/folder.py`): item i pairs frame i with
frame i - 1 under one of the known datasets' intrinsics (or given ones).
Frames are in the port's layout, (F, 3, H, W)."""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from .kitti import pil_open_rgb
from .transforms import chw_frames, resize_image, to_array

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp")

# Normalized intrinsics (fx/W, fy/H, cx/W, cy/H) of the known datasets.
DATASET_INTRINSICS = {
    "kitti": (0.58, 1.92, 0.5, 0.5),
    "cityscape": (1.105, 2.212, 0.5, 0.5),
    "nuscenes": (0.787, 1.400, 0.5, 0.5),
    "euroc": (0.608, 0.966, 0.497, 0.531),
    "eth3d": (0.75, 1.0, 0.5, 0.5),
}


class FolderDataset:
    """Ordered frames from a directory; item i pairs frame i with i - 1
    (frames [cur, prev, cur], so the (0, -1, 1) layout of a batch)."""

    def __init__(self, image_dir: str, height: int, width: int,
                 intrinsics: str | Sequence[float] = "kitti", stride: int = 1):
        self.image_dir = image_dir
        self.height = height
        self.width = width
        self.stride = stride
        self.files = sorted(f for f in os.listdir(image_dir) if f.lower().endswith(IMAGE_EXTS))
        fx, fy, cx, cy = (DATASET_INTRINSICS[intrinsics] if isinstance(intrinsics, str)
                          else intrinsics)
        K = np.eye(4, dtype=np.float32)
        K[0, 0], K[1, 1] = fx * width, fy * height
        K[0, 2], K[1, 2] = cx * width, cy * height
        self.K = K
        self.inv_K = np.linalg.pinv(K).astype(np.float32)

    def __len__(self):
        return max(0, (len(self.files) - 1) // self.stride)

    def _load(self, idx: int) -> np.ndarray:
        img = pil_open_rgb(os.path.join(self.image_dir, self.files[idx]))
        return to_array(resize_image(img, self.height, self.width))

    def __getitem__(self, index: int) -> dict:
        cur = (index + 1) * self.stride
        cur_img, prev_img = self._load(cur), self._load(cur - self.stride)
        frames = chw_frames([cur_img, prev_img, cur_img])
        return {"color": frames, "color_aug": frames, "K": self.K, "inv_K": self.inv_K,
                "filename": self.files[cur]}
