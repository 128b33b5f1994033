"""Aux datasets: EuRoC, ETH3D, Cityscapes, nuScenes (the port's own copy of
`jperceiver_tpu/data/aux_datasets.py`).

The three sequence datasets share `SequenceFrameDataset` (ordered frames,
an optional stereo folder, normalized intrinsics) and differ in directory
layout and calibration; nuScenes is a `KittiBase` whose labels are found by
path substitution. They feed depth/pose generalisation runs and the video
demo; datasets without BEV ground truth emit zero labels, so the pose and
depth losses still run. Samples are in the port's layout: frames
(F, 3, H, W).
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
from PIL import Image

from .kitti import KittiBase, pil_open_rgb
from .transforms import (apply_color_jitter, chw_frames, process_topview, process_topview_both,
                         resize_image, to_array)

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp")


def _listdir_images(path: str) -> list[str]:
    return sorted(f for f in os.listdir(path) if f.lower().endswith(IMAGE_EXTS))


class SequenceFrameDataset:
    """Ordered mono/stereo frames with monodepth2-style augmentation.

    Subclasses give the directory layout (`_list_files`, `frame_path`,
    `stereo_path`) and the normalized intrinsics (fx/W, fy/H, cx/W, cy/H).
    """

    normalized_K = (0.58, 1.92, 0.5, 0.5)
    stereo_baseline = 0.1  # the monodepth2 convention
    index_offset = 0  # first usable frame
    tail_margin = 1  # frames kept back at the end for +1 neighbours

    def __init__(self, data_path: str, height: int, width: int,
                 frame_ids: Sequence = (0, -1, 1), is_train: bool = False, seed: int = 0):
        self.data_path = data_path
        self.height = height
        self.width = width
        self.frame_ids = tuple(frame_ids)
        self.is_train = is_train
        self.occ_map_size = height // 4
        self._base_seed = seed
        self.files = self._list_files()
        lo = self.index_offset + max((-f for f in self.frame_ids if f != "s"), default=0)
        hi = len(self.files) - self.tail_margin
        self._valid = list(range(lo, max(hi, lo)))

    def _list_files(self) -> list[str]:
        raise NotImplementedError

    def frame_path(self, index: int, offset: int = 0) -> str:
        """Path of the frame `offset` steps from anchor `index`."""
        raise NotImplementedError

    def stereo_path(self, index: int) -> str:
        raise NotImplementedError(f"{type(self).__name__} has no stereo pair")

    def __len__(self):
        return len(self._valid)

    def _K(self) -> np.ndarray:
        fx, fy, cx, cy = self.normalized_K
        K = np.eye(4, dtype=np.float32)
        K[0, 0], K[1, 1] = fx * self.width, fy * self.height
        K[0, 2], K[1, 2] = cx * self.width, cy * self.height
        return K

    def __getitem__(self, index: int) -> dict:
        idx = self._valid[index]
        rng = np.random.default_rng(
            None if self.is_train else (self._base_seed * 1_000_003 + index) & 0x7FFFFFFF)
        do_flip = self.is_train and rng.random() > 0.5
        do_aug = self.is_train and rng.random() > 0.5
        jitter = None
        if do_aug:
            jitter = (rng.uniform(0.8, 1.2), rng.uniform(0.8, 1.2), rng.uniform(0.8, 1.2),
                      rng.uniform(-0.1, 0.1), rng.permutation(4))

        color, color_aug = [], []
        for f in self.frame_ids:
            path = self.stereo_path(idx) if f == "s" else self.frame_path(idx, f)
            try:
                img = pil_open_rgb(path)
            except (FileNotFoundError, OSError):
                img = pil_open_rgb(self.frame_path(idx, 0))
            if do_flip:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
            work = resize_image(img, self.height, self.width)
            color.append(to_array(work))
            if jitter is not None:
                work = apply_color_jitter(work, *jitter)
            color_aug.append(to_array(work))

        K = self._K()
        s = self.occ_map_size
        zeros = np.zeros((s, s), np.float32)
        sample = {
            "color": chw_frames(color),
            "color_aug": chw_frames(color_aug),
            "K": K,
            "inv_K": np.linalg.pinv(K).astype(np.float32),
            "odometry_K": K.copy(),
            "Tr_cam2_velo": np.eye(4, dtype=np.float32),
            "bev_static": zeros,
            "bev_dynamic": zeros,
            "bev_both": zeros,
        }
        if "s" in self.frame_ids:
            stereo_T = np.eye(4, dtype=np.float32)
            # side sign x baseline sign x 0.1, the sign flipped under a flip
            stereo_T[0, 3] = -1.0 * (-1.0 if do_flip else 1.0) * self.stereo_baseline
            sample["stereo_T"] = stereo_T
        return sample


class EurocDataset(SequenceFrameDataset):
    """EuRoC MAV: `<root>/cam0/data/*.png`, stereo in `cam1/data`;
    fx = fy = 435.2047 on 752x480 sensors."""

    normalized_K = (435.2047 / 752, 435.2047 / 480, 0.5, 0.5)

    def _list_files(self):
        return _listdir_images(os.path.join(self.data_path, "cam0", "data"))

    def frame_path(self, index, offset=0):
        return os.path.join(self.data_path, "cam0", "data", self.files[index + offset])

    def stereo_path(self, index):
        return os.path.join(self.data_path, "cam1", "data", self.files[index])


class Eth3dDataset(SequenceFrameDataset):
    """ETH3D SLAM: `<root>/rgb/*`, stereo in `rgb2/`; K = (0.9832,
    1.58578), the first frame skipped."""

    normalized_K = (0.9832, 1.58578, 0.5, 0.5)
    index_offset = 1
    tail_margin = 2

    def _list_files(self):
        return _listdir_images(os.path.join(self.data_path, "rgb"))

    def frame_path(self, index, offset=0):
        return os.path.join(self.data_path, "rgb", self.files[index + offset])

    def stereo_path(self, index):
        return os.path.join(self.data_path, "rgb2", self.files[index])


class CityscapesDataset(SequenceFrameDataset):
    """Cityscapes video: split lines name `city/city_seq_frame_leftImg8bit`;
    a temporal neighbour shifts the 6-digit frame number and falls back to
    the anchor frame when it is not in the split. Reads plain files."""

    normalized_K = (0.58, 1.92, 0.5, 0.5)

    def __init__(self, data_path, filenames, height, width, frame_ids=(0, -1, 1),
                 is_train=False, img_ext=".png", seed: int = 0):
        self.filenames = list(filenames)
        self._name_set = set(self.filenames)
        self.img_ext = img_ext
        super().__init__(data_path, height, width, frame_ids, is_train, seed)
        self._valid = list(range(len(self.filenames)))

    def _list_files(self):
        return self.filenames

    def _shift_name(self, name: str, offset: int) -> str:
        d, base = os.path.split(name)
        parts = base.split("_")
        frame = int(parts[-2])
        cand = os.path.join(d, "_".join(parts[:-2] + [str(frame + offset).zfill(6), parts[-1]]))
        return cand if cand in self._name_set else name

    def frame_path(self, index, offset=0):
        return os.path.join(self.data_path,
                            self._shift_name(self.filenames[index], offset) + self.img_ext)


class NuscenesDataset(KittiBase):
    """nuScenes front camera with BEV labels found by path substitution:
    split lines are `road_gt` label paths; images live under `trainval` as
    .jpg, the combined labels under `both_gt_label`, the vehicle labels
    under `<seg_class>_bev_gt`."""

    # CAM_FRONT: fx = fy = 1266.417 on 1600x900
    NUSC_K = (1266.417 / 1600, 1266.417 / 900, 0.5, 0.5)

    def __init__(self, *args, seg_class: str = "vehicle", **kwargs):
        self.seg_class = seg_class
        super().__init__(*args, **kwargs)

    def label_kind(self):
        return "static"

    def image_path(self, line, offset):
        return os.path.join(self.data_path,
                            line.replace("road_gt", "trainval").replace(".png", ".jpg"))

    def label_path(self, line, offset):
        return os.path.join(self.data_path, line)

    def both_label_path(self, line):
        return os.path.join(self.data_path, line.replace("road_gt", "both_gt_label"))

    def dynamic_label_path(self, line):
        return os.path.join(self.data_path, line.replace(
            "road_gt", f"{self.seg_class}_bev_gt").replace(".png", ".jpg"))

    def calib(self, line):
        fx, fy, cx, cy = self.NUSC_K
        K = np.eye(4, dtype=np.float32)
        K[0, 0], K[1, 1] = fx * 1600, fy * 900
        K[0, 2], K[1, 2] = cx * 1600, cy * 900
        return K, np.eye(4, dtype=np.float32)

    def extra_labels(self, line, flip):
        """The combined and vehicle labels, flipped with the sample."""
        extras = {}
        try:
            both = pil_open_rgb(self.both_label_path(line)).convert("L")
            extras["bev_both"] = process_topview_both(both, self.occ_map_size, flip)
        except (FileNotFoundError, OSError):
            pass
        try:
            dyn = pil_open_rgb(self.dynamic_label_path(line)).convert("L")
            extras["bev_dynamic"] = process_topview(dyn, self.occ_map_size, flip)
        except (FileNotFoundError, OSError):
            pass
        return extras
