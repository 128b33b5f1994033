"""Argoverse tracking dataset, road / vehicle / both BEV layouts (the
port's own copy of `jperceiver_tpu/data/argoverse.py`, in the port's
layout: frames (F, 3, H, W), SDF maps (C-1, S, S)). Each log's
`vehicle_calibration_info.json` is parsed directly.

Split lines hold a 3-frame triplet of road-label paths:
  `argoverse-tracking/<split>/<log>/road_gt_new/stereo_front_left_<ts>.png` x3
(cur, prev, next — `mono_dataset.py:286-291`). Images substitute
`road_gt_new -> stereo_front_left` + `.jpg`; vehicle labels
`car_bev_gt_new`; both-labels `both_bev_gt_new`.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np
from PIL import Image

from ..ops.sdf import signed_distance_field
from .kitti import pil_open_rgb
from .transforms import (
    ANTIALIAS,
    apply_color_jitter,
    chw_frames,
    process_topview,
    process_topview_both,
    resize_image,
    to_array,
)

FULL_RES_ARGO = (2464, 2056)  # (W, H), `argoverse_dataset.py:40`


def _quat_to_rot(w, x, y, z):
    n = w * w + x * x + y * y + z * z
    s = 2.0 / n if n > 0 else 0.0
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array(
        [
            [1 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1 - (xx + yy)],
        ]
    )


def load_argo_calibration(log_dir: str, camera: str = "stereo_front_left"):
    """(K (4,4), camera_SE3_egovehicle (4,4)) from the log's calibration json."""
    with open(os.path.join(log_dir, "vehicle_calibration_info.json")) as f:
        calib = json.load(f)
    cam = None
    for entry in calib["camera_data_"]:
        if camera in entry["key"]:
            cam = entry["value"]
            break
    if cam is None:
        raise KeyError(f"camera {camera} not in calibration")
    K = np.eye(4)
    K[0, 0] = cam["focal_length_x_px_"]
    K[1, 1] = cam["focal_length_y_px_"]
    K[0, 1] = cam.get("skew_", 0.0)
    K[0, 2] = cam["focal_center_x_px_"]
    K[1, 2] = cam["focal_center_y_px_"]
    se3 = cam["vehicle_SE3_camera_"]
    q = se3["rotation"]["coefficients"]  # [w, x, y, z]
    R = _quat_to_rot(*q)
    t = np.asarray(se3["translation"])
    # camera_SE3_egovehicle = inverse(vehicle_SE3_camera)
    ext = np.eye(4)
    ext[:3, :3] = R.T
    ext[:3, 3] = -R.T @ t
    return K.astype(np.float32), ext.astype(np.float32)


class Argoverse:
    """type in {'Argo_static', 'Argo_dynamic', 'Argo_both'}."""

    def __init__(
        self,
        data_path: str,
        filenames: Sequence[str],
        height: int,
        width: int,
        frame_ids: Sequence[int] = (0, -1, 1),
        type: str = "Argo_both",
        is_train: bool = True,
        with_sdf: bool = False,
        num_class: int = 2,
        seed: int = 0,
    ):
        self.data_path = data_path
        self.filenames = list(filenames)
        self.height = height
        self.width = width
        self.frame_ids = tuple(frame_ids)
        self.type = type
        self.is_train = is_train
        self.occ_map_size = height // 4
        self.with_sdf = with_sdf
        self.num_class = num_class
        self._calib_cache: dict[str, tuple[np.ndarray, np.ndarray]] = {}

    def __len__(self):
        return len(self.filenames)

    # -- paths ---------------------------------------------------------------
    def _image_path(self, rel_label: str) -> str:
        return os.path.join(
            self.data_path,
            rel_label.replace("road_gt_new", "stereo_front_left").replace(
                ".png", ".jpg"
            ),
        )

    def _label_path(self, rel_label: str, kind: str) -> str:
        sub = {"static": "road_gt_new", "dynamic": "car_bev_gt_new",
               "both": "both_bev_gt_new"}[kind]
        return os.path.join(self.data_path, rel_label.replace("road_gt_new", sub))

    def _calib(self, rel_label: str):
        parts = rel_label.split("/")
        log_dir = os.path.join(self.data_path, parts[0], parts[1], parts[2])
        if log_dir not in self._calib_cache:
            self._calib_cache[log_dir] = load_argo_calibration(log_dir)
        return self._calib_cache[log_dir]

    # -- assembly ------------------------------------------------------------
    def __getitem__(self, index: int) -> dict:
        line = self.filenames[index]
        triplet = line.split()
        if len(triplet) == 1:
            triplet = [triplet[0]] * 3
        by_frame = {0: triplet[0], -1: triplet[1], 1: triplet[2]}

        rng = np.random.default_rng(None if self.is_train else index)
        do_flip = self.is_train and rng.random() > 0.5
        do_aug = self.is_train and rng.random() > 0.5

        jitter = None
        if do_aug:
            jitter = (
                rng.uniform(0.8, 1.2), rng.uniform(0.8, 1.2),
                rng.uniform(0.8, 1.2), rng.uniform(-0.1, 0.1),
                rng.permutation(4),
            )

        color, color_aug = [], []
        for f in self.frame_ids:
            rel = by_frame.get(f, triplet[0])
            try:
                img = pil_open_rgb(self._image_path(rel))
            except (FileNotFoundError, OSError):
                img = pil_open_rgb(self._image_path(triplet[0]))
            if do_flip:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
            full = img.resize(FULL_RES_ARGO, ANTIALIAS)
            work = resize_image(full, self.height, self.width)
            color.append(to_array(work))
            if jitter is not None:
                work = apply_color_jitter(work, *jitter)
            color_aug.append(to_array(work))

        odometry_K, Tr = self._calib(triplet[0])
        # Argo photometric K: calibration K rescaled to the working res
        # (`mono_dataset.py:117-125`).
        K = odometry_K.copy()
        K[0, :] *= self.width / FULL_RES_ARGO[0]
        K[1, :] *= self.height / FULL_RES_ARGO[1]
        inv_K = np.linalg.pinv(K)

        s = self.occ_map_size
        zeros = np.zeros((s, s), np.float32)

        def load_label(kind, proc=process_topview):
            try:
                img = pil_open_rgb(self._label_path(triplet[0], kind)).convert("L")
            except (FileNotFoundError, OSError):
                return zeros
            return proc(img, s, do_flip)

        static = load_label("static") if self.type in ("Argo_static", "Argo_both") else zeros
        dynamic = load_label("dynamic") if self.type in ("Argo_dynamic", "Argo_both") else zeros
        both = load_label("both", process_topview_both) if self.type == "Argo_both" else static

        sample = {
            "color": chw_frames(color),
            "color_aug": chw_frames(color_aug),
            "K": K.astype(np.float32),
            "inv_K": inv_K.astype(np.float32),
            "odometry_K": odometry_K.astype(np.float32),
            "Tr_cam2_velo": Tr.astype(np.float32),
            "bev_static": static,
            "bev_dynamic": dynamic,
            "bev_both": both,
        }
        if self.with_sdf:
            sample["bev_static_sdf"] = signed_distance_field(
                static.astype(np.int32), self.num_class)
            sample["bev_dynamic_sdf"] = signed_distance_field(
                dynamic.astype(np.int32), self.num_class)
        return sample
