"""Split files and the dataset factory (the port's own copy of
`jperceiver_tpu/data/splits.py::get_dataset`): `cfg.data` selects the
dataset class, and the file datasets read the split list
`<split_dir>/<split>/{train,val}_files.txt`.

The port ships no split lists: a file dataset needs `data.split_dir`. The
JAX package's lists (`jperceiver_tpu/data/artifacts/splits`) are in that
layout. The simulated dataset needs no files.
"""

from __future__ import annotations

import os

# Datasets of the JAX package's `get_dataset` that the port has not ported.
_NOT_PORTED = ("euroc", "eth3d", "folder", "cityscape", "nuscenes")


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


def get_dataset(data_cfg, training: bool = True, with_sdf: bool = False,
                num_class: int = 2):
    """cfg.data -> dataset instance, as the JAX package's `get_dataset`
    picks it: `name` "simulated" renders scenes; otherwise `type` "static"
    is KITTI odometry, "static_raw" KITTI raw (or the improved depth of
    `name` "kitti_depth"), "dynamic" KITTI 3D-object and "Argo_*"
    Argoverse."""
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
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"dataset '{name}' is not ported to jperceiver_tpu_torch yet "
            "(ROADMAP.md queue 1: the aux datasets)")

    split_dir = data_cfg.get("split_dir")
    if split_dir is None:
        raise ValueError(
            "data.split_dir must point at a directory of split lists "
            "(<split>/train_files.txt, <split>/val_files.txt)")
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
    common = dict(
        data_path=data_cfg["in_path"],
        filenames=readlines(sfile),
        height=data_cfg["height"],
        width=data_cfg["width"],
        frame_ids=tuple(data_cfg.get("frame_ids", (0, -1, 1))),
        is_train=training,
        with_sdf=with_sdf,
        num_class=num_class,
    )
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
