"""Generate split file lists + ground-truth pose files from dataset trees
(counterpart of `jperceiver_tpu/tools/make_splits.py`).

The reference SHIPS its split lists (`mono/datasets/splits/<split>/
{train,val}_files.txt`) and KITTI GT poses (`mono/datasets/gt_pose/
00..12.txt`) inside the repo; those are derivatives of the public datasets,
so they are regenerated from the dataset tree instead (the port's file
datasets read them through `data.split_dir`):

  # KITTI odometry road split (reference `splits/odometry`)
  python -m jperceiver_tpu_torch.tools.make_splits odometry \
      --data /data/kitti/odometry/dataset/sequences \
      --train_seqs 00 01 02 ... --val_seqs 09 10 --out splits/

  # KITTI 3D-object vehicle split (reference `splits/3Dobject`)
  python -m jperceiver_tpu_torch.tools.make_splits object \
      --data /data/kitti/object --out splits/ --val_fraction 0.1

  # GT poses for the odometry toolkit (reference `gt_pose/*.txt`): the
  # KITTI odometry devkit's poses/ dir is ALREADY the expected format.
  python -m jperceiver_tpu_torch.tools.make_splits gt_pose \
      --data /data/kitti/odometry/dataset/poses --out gt_pose/

  # Cityscapes train/val/test lists (reference
  # `splits/cityscape/gen_cityscape_split.py` — scans the
  # leftImg8bit_sequence zip; a directory tree works too):
  python -m jperceiver_tpu_torch.tools.make_splits cityscape \
      --data leftImg8bit_sequence_trainvaltest.zip --out splits/

  # 108-frame single-drive demo list (reference
  # `splits/kitti_shot_sequence/gen_split.py`):
  python -m jperceiver_tpu_torch.tools.make_splits shot_sequence \
      --data unused --out splits/
"""

from __future__ import annotations

import argparse
import os
import shutil

from ..data.splits import scan_object_split, scan_odometry_split


def _write(path: str, lines: list[str]) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))
    print(f"{path}: {len(lines)} lines")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("kind", choices=["odometry", "object", "gt_pose",
                                    "cityscape", "shot_sequence"])
    p.add_argument("--data", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--train_seqs", nargs="*",
                   default=[f"{i:02d}" for i in range(9)])
    p.add_argument("--val_seqs", nargs="*", default=["09", "10"])
    p.add_argument("--val_fraction", type=float, default=0.1)
    args = p.parse_args(argv)

    if args.kind == "odometry":
        train = scan_odometry_split(args.data, args.train_seqs)
        val = scan_odometry_split(args.data, args.val_seqs)
        _write(os.path.join(args.out, "odometry", "train_files.txt"), train)
        _write(os.path.join(args.out, "odometry", "val_files.txt"), val)
    elif args.kind == "object":
        lines = scan_object_split(args.data)
        n_val = max(1, int(len(lines) * args.val_fraction)) if lines else 0
        _write(os.path.join(args.out, "3Dobject", "train_files.txt"),
               lines[:-n_val] if n_val else lines)
        _write(os.path.join(args.out, "3Dobject", "val_files.txt"),
               lines[-n_val:] if n_val else [])
    elif args.kind == "cityscape":
        # reference: splits/cityscape/gen_cityscape_split.py — every png in
        # the leftImg8bit_sequence archive, bucketed by train/val/test.
        if args.data.endswith(".zip"):
            import zipfile

            names = sorted(zipfile.ZipFile(args.data).namelist())
        else:
            names = sorted(
                os.path.join(r, f)[len(args.data):].lstrip("/")
                for r, _, fs in os.walk(args.data) for f in fs)
        buckets = {"train": [], "val": [], "test": []}
        for n in names:
            if "png" in n:
                for k in buckets:
                    if k in n:
                        buckets[k].append(n)
                        break
        for k, lines in buckets.items():
            _write(os.path.join(args.out, "cityscape", f"{k}.txt"), lines)
    elif args.kind == "shot_sequence":
        # reference: splits/kitti_shot_sequence/gen_split.py — a fixed
        # 108-frame val list over raw drive 2011_09_26_0001.
        _write(os.path.join(args.out, "kitti_shot_sequence", "val_files.txt"),
               [f"2011_09_26/2011_09_26_drive_0001_sync {i:010d} l"
                for i in range(108)])
    else:  # gt_pose: KITTI odometry poses/NN.txt are already the format
        os.makedirs(args.out, exist_ok=True)
        n = 0
        for f in sorted(os.listdir(args.data)):
            if f.endswith(".txt"):
                shutil.copyfile(os.path.join(args.data, f),
                                os.path.join(args.out, f))
                n += 1
        print(f"{args.out}: copied {n} pose files")


if __name__ == "__main__":
    main()
