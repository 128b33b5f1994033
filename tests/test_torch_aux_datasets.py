"""The port's aux datasets (`jperceiver_tpu_torch/data/aux_datasets.py`,
`folder.py`) and their dispatch in `get_dataset` against the JAX package's,
on the directory trees of `tests/test_aux_datasets.py`: every key of every
sample, frames and SDF maps transposed to the port's (F, 3, H, W) and
(C-1, S, S), in evaluation and in
training (the augmentation's generator seeded alike on both sides)."""

import os

import numpy as np
import pytest

import jperceiver_tpu.data as jdata
import jperceiver_tpu_torch.data as pdata
from test_aux_datasets import _img, _label

H = W = 64


def _same(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k in ("color", "color_aug"):
            v = v.transpose(0, 3, 1, 2)
        elif k.endswith("_sdf"):
            v = v.transpose(2, 0, 1)
        if isinstance(v, str):
            assert got[k] == v, k
        else:
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def _samples(ds_p, ds_j, training: bool, monkeypatch) -> None:
    """Every sample of both datasets; in training both draw flips and
    jitter from a generator seeded with the index."""
    assert len(ds_p) == len(ds_j) > 0
    orig = np.random.default_rng
    for i in range(len(ds_j)):
        if training:
            monkeypatch.setattr(np.random, "default_rng",
                                lambda seed=None, i=i: orig(100 + i if seed is None else seed))
        want = ds_j[i]
        got = ds_p[i]
        _same(got, want)
    monkeypatch.setattr(np.random, "default_rng", orig)


@pytest.fixture
def euroc_tree(tmp_path):
    root = tmp_path / "mav0"
    for i in range(6):
        _img(str(root / "cam0" / "data" / f"{i:019d}.png"), (i * 30, 7 * i, 0))
        _img(str(root / "cam1" / "data" / f"{i:019d}.png"), (0, i * 30, 9 * i))
    return str(root)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("frame_ids", [(0, -1, 1), (0, 1, "s")])
def test_euroc(euroc_tree, frame_ids, training, monkeypatch):
    _samples(pdata.EurocDataset(euroc_tree, H, W, frame_ids=frame_ids, is_train=training),
             jdata.EurocDataset(euroc_tree, H, W, frame_ids=frame_ids, is_train=training),
             training, monkeypatch)


@pytest.mark.parametrize("training", [False, True])
def test_eth3d(tmp_path, training, monkeypatch):
    root = tmp_path / "seq"
    for i in range(7):
        _img(str(root / "rgb" / f"{i:06d}.png"), (i * 20, 3 * i, 0))
        _img(str(root / "rgb2" / f"{i:06d}.png"), (0, i * 20, 5))
    for fids in ((0, -1, 1), (0, "s")):
        _samples(pdata.Eth3dDataset(str(root), H, W, frame_ids=fids, is_train=training),
                 jdata.Eth3dDataset(str(root), H, W, frame_ids=fids, is_train=training),
                 training, monkeypatch)


CITY = ["aachen/aachen_000000_000019_leftImg8bit", "aachen/aachen_000000_000020_leftImg8bit",
        "aachen/aachen_000000_000021_leftImg8bit"]


@pytest.mark.parametrize("training", [False, True])
def test_cityscapes(tmp_path, training, monkeypatch):
    root = tmp_path / "cs"
    for i, n in enumerate(CITY):
        _img(str(root / (n + ".png")), (i * 40, 10, 10 * i), size=(256, 128))
    _samples(pdata.CityscapesDataset(str(root), CITY, H, W, is_train=training),
             jdata.CityscapesDataset(str(root), CITY, H, W, is_train=training),
             training, monkeypatch)


@pytest.fixture
def nuscenes_tree(tmp_path):
    root = tmp_path / "nusc"
    lines = []
    for i in range(2):
        rel = f"road_gt/sample_{i}.png"
        _label(str(root / rel))
        _img(str(root / f"trainval/sample_{i}.jpg"), (80, 80 + 20 * i, 200), size=(640, 360))
        _label(str(root / f"both_gt_label/sample_{i}.png"))
        _img(str(root / f"vehicle_bev_gt/sample_{i}.jpg"), (0, 0, 0), size=(128, 128))
        lines.append(rel)
    return str(root), lines


@pytest.mark.parametrize("training", [False, True])
def test_nuscenes(nuscenes_tree, training, monkeypatch):
    root, lines = nuscenes_tree
    kw = dict(data_path=root, filenames=lines, height=H, width=W, frame_ids=(0,),
              is_train=training, with_sdf=True)
    _samples(pdata.NuscenesDataset(**kw), jdata.NuscenesDataset(**kw), training, monkeypatch)


@pytest.mark.parametrize("intrinsics", ["kitti", "euroc", (0.5, 0.9, 0.45, 0.55)])
def test_folder(euroc_tree, intrinsics, monkeypatch):
    d = os.path.join(euroc_tree, "cam0", "data")
    for stride in (1, 2):
        _samples(pdata.FolderDataset(d, H, W, intrinsics=intrinsics, stride=stride),
                 jdata.FolderDataset(d, H, W, intrinsics=intrinsics, stride=stride),
                 False, monkeypatch)


def test_factory_dispatch(euroc_tree, nuscenes_tree, tmp_path, monkeypatch):
    """`get_dataset` picks the same class with the same arguments."""
    base = dict(in_path=euroc_tree, height=H, width=W, frame_ids=[0, -1, 1], type="static",
                split="unused")
    for name in ("euroc", "folder"):
        cfg = dict(base, name=name, in_path=(euroc_tree if name == "euroc" else
                                             os.path.join(euroc_tree, "cam0", "data")))
        for training in (False, True):
            got = pdata.get_dataset(cfg, training=training)
            want = jdata.get_dataset(cfg, training=training)
            assert type(got).__name__ == type(want).__name__
            _samples(got, want, training, monkeypatch)
    root = tmp_path / "cs"
    for i, n in enumerate(CITY):
        _img(str(root / (n + ".png")), (i * 40, 10, 10), size=(256, 128))
    nroot, nlines = nuscenes_tree
    splits = tmp_path / "splits"
    for split, names in (("cs_split", CITY), ("nusc_split", nlines)):
        os.makedirs(splits / split)
        (splits / split / "val_files.txt").write_text("\n".join(names) + "\n")
    for name, in_path, split in (("cityscape", str(root), "cs_split"),
                                 ("nuscenes", nroot, "nusc_split")):
        cfg = dict(base, name=name, in_path=in_path, split=split, split_dir=str(splits),
                   frame_ids=[0])
        got = pdata.get_dataset(cfg, training=False)
        want = jdata.get_dataset(cfg, training=False)
        assert type(got).__name__ == type(want).__name__
        _samples(got, want, False, monkeypatch)
    eth = tmp_path / "eth"
    for i in range(5):
        _img(str(eth / "rgb" / f"{i:06d}.png"), (i * 20, 0, 0))
    cfg = dict(base, name="eth3d", in_path=str(eth))
    assert type(pdata.get_dataset(cfg, training=False)).__name__ == "Eth3dDataset"
