"""Split files and the dataset factory (the port's own copy of
`jperceiver_tpu/data/splits.py::get_dataset`): `cfg.data` selects the
dataset class, and the file datasets read the split list
`<split_dir>/<split>/{train,val}_files.txt`.

The port ships the standard split lists of every split family and KITTI's
odometry ground-truth poses in `data/artifacts/artifacts.tar.xz`
(`artifacts/README.md`), unpacked beside it on first use:
`default_split_dir()` is the split directory when `data.split_dir` is
unset, and `default_gt_pose_dir()` the poses `tools/draw_odometry` scores
against without `--gt_dir`. `scan_odometry_split` / `scan_object_split`
(`tools/make_splits`) write lists in that layout from a dataset tree. The
simulated dataset needs no files; the EuRoC, ETH3D and folder datasets scan
their directory.
"""

from __future__ import annotations

import os
from typing import Sequence

ARTIFACTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "artifacts")
ARTIFACTS_ARCHIVE = os.path.join(ARTIFACTS_DIR, "artifacts.tar.xz")
_ARTIFACT_DIRS = ("splits", "gt_pose")


def unpack_artifacts(archive: str = ARTIFACTS_ARCHIVE, dest: str = ARTIFACTS_DIR) -> None:
    """Unpacks `archive`'s `splits/` and `gt_pose/` into `dest`, unless both
    are there. Each directory appears whole or not at all (unpacked into a
    temporary directory in `dest`, then renamed), so processes that unpack
    at once all find complete lists; a directory already there is kept, with
    any edits made to it."""
    import shutil
    import tarfile
    import tempfile

    if all(os.path.isdir(os.path.join(dest, d)) for d in _ARTIFACT_DIRS):
        return
    tmp = tempfile.mkdtemp(prefix=".unpack-", dir=dest)
    try:
        with tarfile.open(archive, "r:xz") as tar:
            tar.extractall(tmp, filter="data")
        for d in _ARTIFACT_DIRS:
            try:
                os.rename(os.path.join(tmp, d), os.path.join(dest, d))
            except OSError:
                if not os.path.isdir(os.path.join(dest, d)):
                    raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _packaged(name: str) -> str | None:
    d = os.path.join(ARTIFACTS_DIR, name)
    if not os.path.isdir(d) and os.path.isfile(ARTIFACTS_ARCHIVE):
        unpack_artifacts()
    return d if os.path.isdir(d) else None


def default_split_dir() -> str | None:
    """The packaged split lists, `data/artifacts/splits` (unpacked from the
    archive on first use); None if the package has neither."""
    return _packaged("splits")


def default_gt_pose_dir() -> str | None:
    """The packaged KITTI odometry ground-truth poses (`<seq>.txt`, 3x4
    rows), `data/artifacts/gt_pose` (unpacked from the archive on first
    use); None if the package has neither."""
    return _packaged("gt_pose")


def readlines(path: str) -> list[str]:
    with open(path) as f:
        return [l.strip() for l in f if l.strip()]


def split_file(split_dir: str, split: str, training: bool) -> str:
    """The train list, or for evaluation the val list, else the test list
    of benchmark-style splits that ship only `test_files.txt`."""
    if training:
        return os.path.join(split_dir, split, "train_files.txt")
    val = os.path.join(split_dir, split, "val_files.txt")
    if os.path.isfile(val):
        return val
    test = os.path.join(split_dir, split, "test_files.txt")
    return test if os.path.isfile(test) else val


def scan_odometry_split(data_path: str, sequences: Sequence[str]) -> list[str]:
    """Odometry split lines (`<seq>/road_dense128/<frame>.png`) from a
    KITTI odometry tree, for the sequences that have road labels."""
    out = []
    for seq in sequences:
        d = os.path.join(data_path, seq, "road_dense128")
        if not os.path.isdir(d):
            continue
        out.extend(f"{seq}/road_dense128/{f}" for f in sorted(os.listdir(d)) if f.endswith(".png"))
    return out


def scan_object_split(data_path: str) -> list[str]:
    """3D-object split lines (frame ids) from a KITTI object tree's
    `training/vehicle_256` labels."""
    d = os.path.join(data_path, "training", "vehicle_256")
    if not os.path.isdir(d):
        return []
    return [os.path.splitext(f)[0] for f in sorted(os.listdir(d)) if f.endswith(".png")]


def get_dataset(data_cfg, training: bool = True, with_sdf: bool = False,
                num_class: int = 2):
    """cfg.data -> dataset instance, as the JAX package's `get_dataset`
    picks it: `name` "simulated" renders scenes; "euroc", "eth3d" and
    "folder" scan the directory `in_path`; "cityscape" and "nuscenes" read
    split lists; otherwise `type` "static" is KITTI odometry, "static_raw"
    KITTI raw (or the improved depth of `name` "kitti_depth"), "dynamic"
    KITTI 3D-object and "Argo_*" Argoverse."""
    from .argoverse import Argoverse
    from .kitti import KittiDepth, KittiObject, KittiOdometry, KittiRaw

    dtype = data_cfg.get("type", "static")
    name = data_cfg.get("name", "")
    if name == "simulated":
        from .simulated import SimulatedDataset

        return SimulatedDataset(
            n_scenes=data_cfg.get("n_scenes", 64),
            height=data_cfg["height"], width=data_cfg["width"],
            seed=data_cfg.get("seed", 0 if training else 7),
            with_gt=data_cfg.get("with_gt", not training),
            model_type=dtype,
            split=data_cfg.get("split", "odometry"),
        )
    if name in ("euroc", "eth3d"):
        from .aux_datasets import Eth3dDataset, EurocDataset

        cls = EurocDataset if name == "euroc" else Eth3dDataset
        return cls(data_cfg["in_path"], data_cfg["height"], data_cfg["width"],
                   frame_ids=tuple(data_cfg.get("frame_ids", (0, -1, 1))), is_train=training)
    if name == "folder":
        from .folder import FolderDataset

        return FolderDataset(data_cfg["in_path"], data_cfg["height"], data_cfg["width"],
                             intrinsics=data_cfg.get("intrinsics", "kitti"))

    split_dir = data_cfg.get("split_dir") or default_split_dir()
    if split_dir is None:
        raise ValueError(
            "data.split_dir must point at a splits directory "
            "(the packaged data/artifacts/artifacts.tar.xz is missing)")
    sfile = split_file(split_dir, data_cfg["split"], training)
    if not os.path.isfile(sfile):
        have = sorted(
            d for d in os.listdir(split_dir)
            if os.path.isdir(os.path.join(split_dir, d))
        ) if os.path.isdir(split_dir) else []
        raise FileNotFoundError(
            f"split '{data_cfg['split']}' has no "
            f"{'train' if training else 'val'} list at {sfile}; "
            f"available splits under {split_dir}: {have}")
    filenames = readlines(sfile)
    if name == "cityscape":
        from .aux_datasets import CityscapesDataset

        return CityscapesDataset(data_cfg["in_path"], filenames, data_cfg["height"],
                                 data_cfg["width"],
                                 frame_ids=tuple(data_cfg.get("frame_ids", (0, -1, 1))),
                                 is_train=training,
                                 img_ext=".png" if data_cfg.get("png", True) else ".jpg")
    common = dict(
        data_path=data_cfg["in_path"],
        filenames=filenames,
        height=data_cfg["height"],
        width=data_cfg["width"],
        frame_ids=tuple(data_cfg.get("frame_ids", (0, -1, 1))),
        is_train=training,
        with_sdf=with_sdf,
        num_class=num_class,
    )
    if name == "nuscenes":
        from .aux_datasets import NuscenesDataset

        return NuscenesDataset(seg_class=data_cfg.get("seg_class", "vehicle"), **common)
    if dtype == "static":
        return KittiOdometry(raw_calib_root=data_cfg.get("raw_calib_root"), **common)
    if dtype == "static_raw":
        cls = KittiDepth if name == "kitti_depth" else KittiRaw
        return cls(**common)
    if dtype == "dynamic":
        return KittiObject(**common)
    if dtype.startswith("Argo"):
        return Argoverse(type=dtype, **common)
    raise ValueError(f"unknown data type {dtype}")
