"""The port's data pipeline against the JAX package's: each dataset gives
the JAX dataset's samples, the loader the JAX loader's order, shards and
pad mask, and `get_dataset` the same dataset for the same config.

The datasets run on the fake trees the JAX tests build (`fake_odom` of
`test_data.py`, `fake_argo` of `test_argoverse.py`) and on small KITTI raw
and 3D-object trees built here, and `SimulatedDataset` at 64^2. A JAX
sample is compared in the port's layout: frames (F, H, W, 3) -> (F, 3, H, W)
and SDF maps (S, S, 1) -> (1, S, S). Training samples draw their flip and
jitter from an unseeded generator in both packages; the tests seed it, the
same for both, so the augmentation is compared too.

Tolerance: exact, but for the SDF (1e-5: the JAX package may compute it in
its native library) and the velodyne depth (1e-4 m, as `test_data.py` holds
the JAX version to the reference algorithm).
"""

import os

import numpy as np
import pytest
from PIL import Image

import jperceiver_tpu.data as jdata
import jperceiver_tpu_torch.data as pdata
from test_argoverse import fake_argo  # noqa: F401  (fixture)
from test_data import fake_odom  # noqa: F401  (fixture)

# Seeds of the training draw: flip and jitter, neither, jitter only.
SEEDS = (1, 2, 8)


def _port_layout(sample: dict) -> dict:
    out = {}
    for k, v in sample.items():
        if k in ("color", "color_aug"):
            v = v.transpose(0, 3, 1, 2)
        elif k.endswith("_sdf"):
            v = v.transpose(2, 0, 1)
        out[k] = v
    return out


def _assert_same(got: dict, want: dict, what=""):
    want = _port_layout(want)
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, (what, k, g.shape, w.shape)
        if k.endswith("_sdf"):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=f"{what} {k}")
        elif k == "gt_depth":
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=0, err_msg=f"{what} {k}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")


def _seeded(monkeypatch, seed, fn):
    """fn() with `np.random.default_rng(None)` seeded by `seed`."""
    real = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda s=None: real(seed if s is None else s))
    try:
        return fn()
    finally:
        monkeypatch.setattr(np.random, "default_rng", real)


def _compare(monkeypatch, make, n, train, what, seeds=SEEDS):
    """Samples 0..n-1 of `make(package)` in both packages; in training
    under each of `seeds`. Returns how many training samples were
    flipped or jittered."""
    jds, pds = make(jdata), make(pdata)
    assert len(jds) == len(pds) == n
    augmented = 0
    for i in range(n):
        for seed in (seeds if train else [None]):
            if seed is None:
                want, got = jds[i], pds[i]
            else:
                want = _seeded(monkeypatch, seed, lambda: jds[i])
                got = _seeded(monkeypatch, seed, lambda: pds[i])
                augmented += bool((want["color"] != want["color_aug"]).any()
                                  or "stereo_T" in want and want["stereo_T"][0, 3] > 0)
            _assert_same(got, want, f"{what}[{i}] seed {seed}")
    return augmented


@pytest.mark.parametrize("train", [True, False])
def test_kitti_odometry_matches_jax(fake_odom, monkeypatch, train):  # noqa: F811
    names = [f"00/road_dense128/{i:06d}.png" for i in range(4)]
    aug = _compare(monkeypatch, lambda pkg: pkg.KittiOdometry(
        fake_odom, names, 128, 128, is_train=train, with_sdf=True), 4, train, "odometry")
    assert aug > 0 or not train


@pytest.fixture(scope="module")
def fake_raw(tmp_path_factory):
    """A KITTI raw drive with its stereo frame, road labels, velodyne scans
    and improved-depth maps, and its date's calibration."""
    root = tmp_path_factory.mktemp("kitti_raw")
    drive = root / "2011_09_26" / "2011_09_26_drive_0001_sync"
    subs = ("image_02/data", "image_03/data", "road_256/road_256", "velodyne_points/data",
            "proj_depth/groundtruth/image_02")
    for sub in subs:
        (drive / sub).mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(3):
        img = rng.uniform(0, 255, (40, 120, 3)).astype(np.uint8)
        Image.fromarray(img).save(drive / "image_02/data" / f"{i:010d}.png")
        Image.fromarray(img[:, ::-1]).save(drive / "image_03/data" / f"{i:010d}.png")
        lbl = np.zeros((128, 128), np.uint8)
        lbl[60:, 40:90] = 255
        Image.fromarray(lbl).save(drive / "road_256/road_256" / f"{i:010d}.png")
        pts = np.zeros((2000, 4), np.float32)
        pts[:, 0] = rng.uniform(2, 50, 2000)
        pts[:, 1] = rng.uniform(-10, 10, 2000)
        pts[:, 2] = rng.uniform(-2, 1, 2000)
        pts.tofile(drive / "velodyne_points/data" / f"{i:010d}.bin")
        depth = (rng.uniform(0, 80, (60, 120)) * 256).astype(np.uint16)
        Image.fromarray(depth).save(drive / "proj_depth/groundtruth/image_02" / f"{i:010d}.png")
    with open(root / "2011_09_26" / "calib_cam_to_cam.txt", "w") as f:
        f.write("R_rect_00: 1 0 0 0 1 0 0 0 1\n")
        f.write("P_rect_02: 700 0 600 45 0 700 180 0 0 0 1 0\n")
        f.write("S_rect_02: 1242 375\n")
    with open(root / "2011_09_26" / "calib_velo_to_cam.txt", "w") as f:
        f.write("R: 0 -1 0 0 0 -1 1 0 0\nT: 0 0 0\n")
    return str(root), [f"2011_09_26/2011_09_26_drive_0001_sync/image_02/data/{i:010d}.png"
                       for i in range(3)]


@pytest.mark.parametrize("cls,train", [("KittiRaw", True), ("KittiRaw", False),
                                       ("KittiDepth", False)])
def test_kitti_raw_and_depth_match_jax_with_stereo(fake_raw, monkeypatch, cls, train):
    """KittiDepth is KittiRaw with another ground-truth depth, which only
    evaluation samples carry."""
    root, names = fake_raw
    aug = _compare(monkeypatch, lambda pkg: getattr(pkg, cls)(
        root, names, 128, 128, frame_ids=(0, -1, "s"), is_train=train, with_sdf=True),
        3, train, cls)
    assert aug > 0 or not train
    if not train:
        s = getattr(pdata, cls)(root, names, 128, 128, frame_ids=(0, -1, "s"), is_train=False)[1]
        assert s["gt_depth"].shape == (375, 1242) and (s["gt_depth"] > 0).any()
        assert s["stereo_T"][0, 3] == -0.1


@pytest.fixture(scope="module")
def fake_object(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_object")
    for sub in ("training/image_2", "training/vehicle_256", "training/calib"):
        (root / sub).mkdir(parents=True)
    rng = np.random.default_rng(2)
    for i in range(3):
        img = rng.uniform(0, 255, (50, 150, 3)).astype(np.uint8)
        Image.fromarray(img).save(root / "training/image_2" / f"{i:06d}.png")
        lbl = np.zeros((256, 256), np.uint8)
        lbl[100:140, 90 + 10 * i:130 + 10 * i] = 255
        Image.fromarray(lbl).save(root / "training/vehicle_256" / f"{i:06d}.png")
        with open(root / "training/calib" / f"{i:06d}.txt", "w") as f:
            f.write("P2: 721.5 0 609.6 44.9 0 721.5 172.9 0.2 0 0 1 0.003\n")
            f.write("Tr_velo_to_cam: 0.0075 -1 -0.0006 -0.004 0.015 0.0007 -1 -0.076 "
                    "1 0.0075 0.015 -0.27\n")
    return str(root)


@pytest.mark.parametrize("train", [True, False])
def test_kitti_object_matches_jax(fake_object, monkeypatch, train):
    aug = _compare(monkeypatch, lambda pkg: pkg.KittiObject(
        fake_object, ["0", "1", "2"], 128, 128, is_train=train, with_sdf=True),
        3, train, "object")
    assert aug > 0 or not train


@pytest.mark.parametrize("typ,train", [("Argo_static", False), ("Argo_dynamic", False),
                                       ("Argo_both", False), ("Argo_both", True)])
def test_argoverse_matches_jax(fake_argo, monkeypatch, typ, train):  # noqa: F811
    """Frames are resized through Argoverse's full 2464x2056, so each type
    takes one sample, and training one type (the types differ in their
    labels only) under two seeds; a line of one path stands for all three
    frames in evaluation."""
    root, stamps = fake_argo
    rel = f"argoverse-tracking/train1/log01/road_gt_new/stereo_front_left_{stamps[0]}.png"
    line = (" ".join([rel, rel.replace(str(stamps[0]), str(stamps[1])),
                      rel.replace(str(stamps[0]), str(stamps[2]))]) if train else rel)
    aug = _compare(monkeypatch, lambda pkg: pkg.Argoverse(
        str(root), [line], height=128, width=128, type=typ, is_train=train,
        with_sdf=True), 1, train, typ, seeds=(1, 8))
    assert aug > 0 or not train


@pytest.mark.parametrize("model_type,split", [("static", "odometry"), ("Argo_both", "argo"),
                                              ("dynamic", "odometry")])
def test_simulated_matches_jax(monkeypatch, model_type, split):
    from jperceiver_tpu.data import simulated as jsim

    for with_gt in (False, True):
        _compare(monkeypatch, lambda pkg: (jsim if pkg is jdata else pdata).SimulatedDataset(
            n_scenes=2, height=64, width=64, seed=3, with_gt=with_gt,
            model_type=model_type, split=split), 2, False, f"simulated {model_type}")


def test_generate_depth_map_matches_jax(fake_raw, monkeypatch):
    """The port's numpy projection against the JAX package's default path
    (its native library where it is built) and its numpy path."""
    import jperceiver_tpu.native as jnative

    root, _ = fake_raw
    calib = os.path.join(root, "2011_09_26")
    velo = os.path.join(root, "2011_09_26/2011_09_26_drive_0001_sync/velodyne_points/data",
                        "0000000002.bin")
    got = pdata.generate_depth_map(calib, velo, 2)
    assert got.shape == (375, 1242) and (got > 0).sum() > 100
    np.testing.assert_allclose(got, jdata.generate_depth_map(calib, velo, 2), atol=1e-4, rtol=0)
    monkeypatch.setattr(jnative, "HAVE_NATIVE", False)
    np.testing.assert_array_equal(got, jdata.generate_depth_map(calib, velo, 2))


class _Indices:
    """A dataset whose sample i is its index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"idx": np.array([i])}


@pytest.mark.parametrize("n,batch,shuffle,drop_last,ranks", [
    (7, 2, True, True, 1), (7, 2, True, False, 2), (5, 2, False, False, 3),
    (9, 3, True, True, 2), (3, 2, True, False, 1)])
def test_loader_matches_jax(n, batch, shuffle, drop_last, ranks):
    """Index order, rank shards and the `_valid` pad mask, epoch by epoch,
    whether the epoch is set or advanced by iterating."""
    for rank in range(ranks):
        kw = dict(batch_size=batch, shuffle=shuffle, num_workers=2, seed=11,
                  process_index=rank, process_count=ranks, drop_last=drop_last)
        jl, pl = jdata.DataLoader(_Indices(n), **kw), pdata.DataLoader(_Indices(n), **kw)
        assert len(pl) == len(jl)
        orders = []
        for epoch in (0, None, 3, None, 1):
            if epoch is not None:
                jl.set_epoch(epoch)
                pl.set_epoch(epoch)
            idx, valid = pl._epoch_indices()
            jidx, jvalid = jl._epoch_indices()
            np.testing.assert_array_equal(idx, jidx)
            np.testing.assert_array_equal(valid, jvalid)
            got, want = list(pl), list(jl)
            assert len(got) == len(want) == len(pl)
            for g, w in zip(got, want):
                assert sorted(g) == sorted(w)
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k])
            orders.append(np.concatenate([b["idx"][:, 0] for b in got]) if got else None)
        if shuffle and n // (batch * ranks) > 1:
            assert not np.array_equal(orders[0], orders[2])


def test_loader_worker_error_raised_in_caller():
    class Broken(_Indices):
        def __getitem__(self, i):
            if i == 2:
                raise OSError("corrupt sample")
            return super().__getitem__(i)

    with pytest.raises(RuntimeError, match="worker failed") as exc:
        list(pdata.DataLoader(Broken(4), batch_size=1, shuffle=False, num_workers=2))
    assert isinstance(exc.value.__cause__, OSError)


def test_collate_stacks_samples():
    out = pdata.collate([{"a": np.zeros((2, 3))}, {"a": np.ones((2, 3))}])
    assert out["a"].shape == (2, 2, 3) and out["a"][1].sum() == 6


def test_get_dataset_matches_jax(fake_odom, tmp_path):  # noqa: F811
    """The factory's dispatch: the simulated scenes, a file dataset read
    from a split list, and the datasets the port does not have yet."""
    from jperceiver_tpu.config import Config as JaxConfig
    from jperceiver_tpu_torch.config import Config

    sim = dict(name="simulated", type="Argo_both", split="argo", height=64, width=64,
               n_scenes=3)
    for training in (True, False):
        want = jdata.get_dataset(JaxConfig.fromdict(sim).to_dict(), training=training)
        got = pdata.get_dataset(Config.fromdict(sim).to_dict(), training=training)
        assert type(got).__name__ == type(want).__name__ == "SimulatedDataset"
        assert {k: v for k, v in vars(got).items() if k != "_cache"} == \
            {k: v for k, v in vars(want).items() if k != "_cache"}
    (tmp_path / "odometry").mkdir()
    (tmp_path / "odometry" / "train_files.txt").write_text(
        "00/road_dense128/000001.png\n00/road_dense128/000002.png\n")
    odo = dict(name="kitti_odom", type="static", split="odometry", split_dir=str(tmp_path),
               in_path=fake_odom, height=128, width=128)
    want = jdata.get_dataset(odo, training=True, with_sdf=True)
    got = pdata.get_dataset(odo, training=True, with_sdf=True)
    assert isinstance(got, pdata.KittiOdometry)
    assert got.filenames == want.filenames and got.with_sdf and got.is_train
    with pytest.raises(FileNotFoundError, match="no val list"):
        pdata.get_dataset(odo, training=False)
    with pytest.raises(ValueError, match="split_dir"):
        pdata.get_dataset(dict(odo, split_dir=None))
    for name in ("euroc", "eth3d", "folder", "cityscape", "nuscenes"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            pdata.get_dataset(dict(odo, name=name))
