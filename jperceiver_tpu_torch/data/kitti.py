"""KITTI datasets: odometry (road), RAW (road), 3D-object (vehicle) and
the improved-depth RAW variant (the port's own copy of
`jperceiver_tpu/data/kitti.py`). Host-side, numpy and PIL only. Each
sample has the training-batch keys of `data/synthetic.py` in the port's
layout: frames (F, 3, H, W), SDF maps (C-1, S, S).

Path layouts (standard KITTI trees):
  odometry: <root>/<seq>/{image_2,road_dense128,velodyne}/<frame>.png|bin,
            <root>/<seq>/calib.txt
  raw:      <root>/<date>/<drive>_sync/image_02/data/<frame>.png,
            labels in .../road_256/road_256/<frame>.png,
            calib in <root>/<date>/calib_*.txt
  object:   <root>/training/{image_2,vehicle_256}/<frame>.png; calib in
            <root>/training/calib/<frame>.txt.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
from PIL import Image

from ..ops.sdf import signed_distance_field
from .calib import load_odometry_calib, load_raw_calib, read_calib_file, _pad44, _baseline_shift
from .transforms import (
    ANTIALIAS,
    apply_color_jitter,
    chw_frames,
    process_topview,
    resize_image,
    to_array,
)
from .velodyne import generate_depth_map

FULL_RES_KITTI = (1242, 375)  # (W, H), `mono_dataset.py:89`

# Normalized intrinsics all KITTI photometric paths use
# (`mono_dataset.py:84-88`): scaled by the working resolution in process_K.
NORMALIZED_K = np.array(
    [[0.58, 0, 0.5, 0], [0, 1.92, 0.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
    np.float32,
)

ODOM_TO_RAW = {
    "00": "2011_10_03/2011_10_03_drive_0027",
    "01": "2011_10_03/2011_10_03_drive_0042",
    "02": "2011_10_03/2011_10_03_drive_0034",
    "03": "2011_09_26/2011_09_26_drive_0067",
    "04": "2011_09_30/2011_09_30_drive_0016",
    "05": "2011_09_30/2011_09_30_drive_0018",
    "06": "2011_09_30/2011_09_30_drive_0020",
    "07": "2011_09_30/2011_09_30_drive_0027",
    "08": "2011_09_30/2011_09_30_drive_0028",
    "09": "2011_09_30/2011_09_30_drive_0033",
    "10": "2011_09_30/2011_09_30_drive_0034",
}


def pil_open_rgb(path: str) -> Image.Image:
    with open(path, "rb") as f:
        return Image.open(f).convert("RGB")


class KittiBase:
    """Shared sample assembly for the three KITTI variants."""

    def __init__(
        self,
        data_path: str,
        filenames: Sequence[str],
        height: int,
        width: int,
        frame_ids: Sequence[int] = (0, -1, 1),
        is_train: bool = True,
        with_sdf: bool = False,
        num_class: int = 2,
        img_ext: str = ".png",
        raw_calib_root: str | None = None,
        seed: int = 0,
    ):
        self.data_path = data_path
        self.filenames = list(filenames)
        self.height = height
        self.width = width
        self.frame_ids = tuple(frame_ids)
        self.is_train = is_train
        self.occ_map_size = height // 4  # `mono_dataset.py:168`
        self.with_sdf = with_sdf
        self.num_class = num_class
        self.img_ext = img_ext
        self.raw_calib_root = raw_calib_root
        self._base_seed = seed
        self._calib_cache: dict[str, tuple[np.ndarray, np.ndarray]] = {}

    def __len__(self):
        return len(self.filenames)

    # -- per-variant hooks -------------------------------------------------
    def image_path(self, line: str, offset: int) -> str:
        raise NotImplementedError

    def label_path(self, line: str, offset: int) -> str:
        raise NotImplementedError

    def calib(self, line: str) -> tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def label_kind(self) -> str:  # "static" or "dynamic"
        raise NotImplementedError

    def gt_depth(self, line: str, flip: bool) -> np.ndarray | None:
        return None

    def stereo_image_path(self, line: str) -> str:
        raise NotImplementedError(
            f"{type(self).__name__} has no stereo pair"
        )

    # -- assembly ------------------------------------------------------------
    def _load_frame(self, line: str, offset, flip: bool):
        if offset == "s":
            img = pil_open_rgb(self.stereo_image_path(line))
            if flip:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
            lbl = pil_open_rgb(self.label_path(line, 0)).convert("L")
            return img, lbl
        img = pil_open_rgb(self.image_path(line, offset))
        if flip:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        lbl = pil_open_rgb(self.label_path(line, offset)).convert("L")
        return img, lbl

    def __getitem__(self, index: int) -> dict:
        line = self.filenames[index]
        rng = np.random.default_rng(
            (self._base_seed * 1_000_003 + index) & 0x7FFFFFFF
            if not self.is_train
            else None
        )
        do_flip = self.is_train and rng.random() > 0.5
        do_aug = self.is_train and rng.random() > 0.5

        frames = {}
        label0 = None
        for f in self.frame_ids:
            try:
                img, lbl = self._load_frame(line, f, do_flip)
            except (FileNotFoundError, OSError):
                img, lbl = self._load_frame(line, 0, do_flip)
            frames[f] = img
            if f == 0:
                label0 = lbl

        # Full-res resize, then working-res; shared jitter params per sample
        # (`mono_dataset.py:130-171`).
        jitter = None
        if do_aug:
            jitter = (
                rng.uniform(0.8, 1.2),
                rng.uniform(0.8, 1.2),
                rng.uniform(0.8, 1.2),
                rng.uniform(-0.1, 0.1),
                rng.permutation(4),
            )
        color = []
        color_aug = []
        for f in self.frame_ids:
            full = frames[f].resize(FULL_RES_KITTI, ANTIALIAS)
            work = resize_image(full, self.height, self.width)
            color.append(to_array(work))
            if jitter is not None:
                work = apply_color_jitter(work, *jitter)
            color_aug.append(to_array(work))

        K = NORMALIZED_K.copy()
        K[0, :] *= self.width
        K[1, :] *= self.height
        inv_K = np.linalg.pinv(K)

        # NOTE: under do_flip the reference flips images/labels but not the
        # calibration (`mono_dataset.py:202-203`); kept for parity.
        odometry_K, Tr = self.calib(line)
        s = self.occ_map_size
        bev = process_topview(label0, s, do_flip)
        zeros = np.zeros((s, s), np.float32)
        static = bev if self.label_kind() == "static" else zeros
        dynamic = bev if self.label_kind() == "dynamic" else zeros

        sample = {
            "color": chw_frames(color),
            "color_aug": chw_frames(color_aug),
            "K": K,
            "inv_K": inv_K.astype(np.float32),
            "odometry_K": odometry_K.astype(np.float32),
            "Tr_cam2_velo": Tr.astype(np.float32),
            "bev_static": static,
            "bev_dynamic": dynamic,
            "bev_both": static,
        }
        if "s" in self.frame_ids:
            # monodepth2 stereo convention: fixed 0.1-baseline translation;
            # sign follows the viewed side and flips under do_flip.
            stereo_T = np.eye(4, dtype=np.float32)
            sign = -1.0 if not do_flip else 1.0
            stereo_T[0, 3] = sign * 0.1
            sample["stereo_T"] = stereo_T
        if self.with_sdf:
            sample["bev_static_sdf"] = signed_distance_field(
                static.astype(np.int32), self.num_class
            )
            sample["bev_dynamic_sdf"] = signed_distance_field(
                dynamic.astype(np.int32), self.num_class
            )
        if not self.is_train:
            gt = self.gt_depth(line, do_flip)
            if gt is not None:
                sample["gt_depth"] = gt.astype(np.float32)
        # Subclass hook receiving THIS sample's flip decision, so extra
        # labels stay aligned with the (possibly flipped) images.
        sample.update(self.extra_labels(line, do_flip))
        return sample

    def extra_labels(self, line: str, flip: bool) -> dict:
        """Dataset-specific additional labels; default none."""
        return {}


class KittiOdometry(KittiBase):
    """KITTI odometry + `road_dense128` BEV road labels (type='static')."""

    def label_kind(self):
        return "static"

    def _parse(self, line: str):
        seq = line.split("/")[0]
        frame = int(os.path.splitext(os.path.basename(line))[0])
        return seq, frame

    def image_path(self, line, offset):
        seq, frame = self._parse(line)
        return os.path.join(
            self.data_path, seq, "image_2", f"{frame + offset:06d}{self.img_ext}"
        )

    def label_path(self, line, offset):
        seq, frame = self._parse(line)
        return os.path.join(
            self.data_path, seq, "road_dense128", f"{frame + offset:06d}.png"
        )

    def calib(self, line):
        seq, _ = self._parse(line)
        if seq not in self._calib_cache:
            self._calib_cache[seq] = load_odometry_calib(
                os.path.join(self.data_path, seq)
            )
        return self._calib_cache[seq]

    def gt_depth(self, line, flip):
        """Velodyne depth via the odom->raw calib map (`kitti_dataset.py:328-360`)."""
        if self.raw_calib_root is None:
            return None
        seq, frame = self._parse(line)
        date = ODOM_TO_RAW[seq].split("/")[0]
        calib_dir = os.path.join(self.raw_calib_root, date)
        velo = os.path.join(self.data_path, seq, "velodyne", f"{frame:06d}.bin")
        if not (os.path.isdir(calib_dir) and os.path.isfile(velo)):
            return None
        depth = generate_depth_map(calib_dir, velo, 2)
        im = Image.fromarray(depth)
        depth = np.asarray(
            im.resize(FULL_RES_KITTI, Image.NEAREST), np.float64
        )
        return np.fliplr(depth).copy() if flip else depth


class KittiRaw(KittiBase):
    """KITTI RAW + `road_256` labels (type='static_raw')."""

    def label_kind(self):
        return "static"

    def _parse(self, line: str):
        # `<date>/<drive>_sync/image_02/data/<frame>.png`
        drive_dir = line.split("/image_02/")[0]
        frame = int(os.path.splitext(os.path.basename(line))[0])
        return drive_dir, frame

    def image_path(self, line, offset):
        drive_dir, frame = self._parse(line)
        return os.path.join(
            self.data_path, drive_dir, "image_02/data",
            f"{frame + offset:010d}{self.img_ext}",
        )

    def label_path(self, line, offset):
        drive_dir, frame = self._parse(line)
        return os.path.join(
            self.data_path, drive_dir, "road_256/road_256",
            f"{frame + offset:010d}.png",
        )

    def stereo_image_path(self, line):
        drive_dir, frame = self._parse(line)
        return os.path.join(
            self.data_path, drive_dir, "image_03/data",
            f"{frame:010d}{self.img_ext}",
        )

    def calib(self, line):
        date = line.split("/")[0]
        if date not in self._calib_cache:
            self._calib_cache[date] = load_raw_calib(
                os.path.join(self.data_path, date)
            )
        return self._calib_cache[date]

    def gt_depth(self, line, flip):
        drive_dir, frame = self._parse(line)
        calib_dir = os.path.join(self.data_path, line.split("/")[0])
        velo = os.path.join(
            self.data_path, drive_dir, "velodyne_points/data", f"{frame:010d}.bin"
        )
        if not os.path.isfile(velo):
            return None
        depth = generate_depth_map(calib_dir, velo, 2)
        im = Image.fromarray(depth)
        depth = np.asarray(im.resize(FULL_RES_KITTI, Image.NEAREST), np.float64)
        return np.fliplr(depth).copy() if flip else depth


class KittiObject(KittiBase):
    """KITTI 3D-object + `vehicle_256` labels (type='dynamic').

    Object frames are single images; adjacent "frames" fall back to frame 0
    like the reference's try/except (`mono_dataset.py:266-282`).
    """

    def label_kind(self):
        return "dynamic"

    def image_path(self, line, offset):
        frame = int(line)
        return os.path.join(
            self.data_path, "training/image_2", f"{frame + offset:06d}{self.img_ext}"
        )

    def label_path(self, line, offset):
        frame = int(line)
        return os.path.join(
            self.data_path, "training/vehicle_256", f"{frame + offset:06d}.png"
        )

    def calib(self, line):
        frame = int(line)
        path = os.path.join(self.data_path, "training/calib", f"{frame:06d}.txt")
        if path not in self._calib_cache:
            data = read_calib_file(path)
            P2 = data["P2"].reshape(3, 4)
            Tr = _pad44(data["Tr_velo_to_cam"].reshape(3, 4))
            T_cam2_velo = _baseline_shift(P2) @ Tr
            K = np.eye(4, dtype=np.float32)
            K[:3, :3] = P2[:3, :3]
            self._calib_cache[path] = (K, T_cam2_velo.astype(np.float32))
        return self._calib_cache[path]


class KittiDepth(KittiRaw):
    """KITTI with improved `proj_depth/groundtruth` depth maps.

    Parity with `KITTIDepthDataset` (`kitti_dataset.py:363-391`): GT depth
    comes from 16-bit PNGs (value/256 metres) instead of raw velodyne.
    """

    def gt_depth(self, line, flip):
        drive_dir, frame = self._parse(line)
        path = os.path.join(
            self.data_path, drive_dir, "proj_depth/groundtruth/image_02",
            f"{frame:010d}.png",
        )
        if not os.path.isfile(path):
            return None
        with open(path, "rb") as f:
            img = Image.open(f)
            img = img.resize(FULL_RES_KITTI, Image.NEAREST)
            depth = np.asarray(img).astype(np.float32) / 256.0
        return np.fliplr(depth).copy() if flip else depth
