"""The port's evaluation path against the JAX package at 128^2, occ 32,
fp32, road branch, with the same random weights (`state_dict_from_jax`):

- `depth_metrics_single` within 1e-6 relative, `eigen_crop_mask` equal;
- `EvalHook` over the simulated validation scenes (3 scenes in batches of
  2, the tail padded and masked): depth metrics within 1e-4 relative, the
  layout metrics within 1e-3 absolute, the keys and `n_eval_samples` equal;
- a reference-format `Baseline` `.pth` (raw, `{'state_dict': ...}`, with
  DDP's `module.` prefix; the other branch's and the dead `res_conv`
  entries included) and torchvision-style ResNet `.pth` files for the
  trunks, written from a seeded random state: the eval outputs after each
  package loads the same file within `test_torch_port_model.py`'s 2e-4 of
  their scale;
- `tools/draw_odometry` on a rendered 12-frame sequence: the chained poses
  within 1e-4 of the JAX `pose_between` chained the same way.

The JAX eval step is compiled once (B = 2) and serves every comparison.

And the repair of the eval mode: an eval step or a streaming function built
before a training step, and called after it, runs in eval mode (running
statistics unchanged, outputs those of a fresh `model.eval()` copy).
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import struct

from jperceiver_tpu.config import Config as JaxConfig
from jperceiver_tpu.data import DataLoader as JaxDataLoader
from jperceiver_tpu.data import get_dataset as jax_get_dataset
from jperceiver_tpu.data import synthetic_batch as jax_synthetic_batch
from jperceiver_tpu.data.kitti import pil_open_rgb as jax_pil_open_rgb
from jperceiver_tpu.data.transforms import resize_image as jax_resize_image
from jperceiver_tpu.data.transforms import to_array as jax_to_array
from jperceiver_tpu.engine import checkpoint as jax_ckpt
from jperceiver_tpu.engine import eval_hook as jax_hook
from jperceiver_tpu.engine.trainer import make_eval_step as jax_make_eval_step
from jperceiver_tpu.models import JPerceiver as JaxJPerceiver
from jperceiver_tpu_torch.config import Config
from jperceiver_tpu_torch.convert import state_dict_from_jax
from jperceiver_tpu_torch.data import DataLoader, get_dataset, synthetic_batch
from jperceiver_tpu_torch.engine import checkpoint as ckpt
from jperceiver_tpu_torch.engine import eval_hook as hook
from jperceiver_tpu_torch.engine import make_eval_step, make_streaming_fn, make_train_step
from jperceiver_tpu_torch.models import JPerceiver, build_model
from jperceiver_tpu_torch.tools import draw_odometry
from jperceiver_tpu_torch.tools.acceptance import render_odometry_sequence

from torch_port_helpers import assert_close, nhwc, random_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = 128
OCC = H // 4
TOL = 2e-4
CFG = {"type": "static", "split": "odometry"}
DATA = {"name": "simulated", "type": "static", "split": "odometry", "height": H, "width": H,
        "n_scenes": 3}


@struct.dataclass
class _State:
    """What the JAX eval step and loaders read of a train state."""
    params: dict
    batch_stats: dict


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: a pool per process oversubscribes a CPU that
    other test processes share (this file's PyTorch work took 10-26 times
    its time alone in a parallel test run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    """The JAX model, its random variables, its jitted eval step and the
    port model holding the same weights."""
    jm = JaxJPerceiver(height=H, width=H, occ_map_size=OCC, branches="road")
    batch = {k: jnp.asarray(v) for k, v in jax_synthetic_batch(2, H, H, OCC).items()}
    v = random_variables(jm, batch, train=False, with_pose=True)
    port = JPerceiver(height=H, width=H, occ_map_size=OCC, branches="road")
    port.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"]))
    return jm, _State(v["params"], v["batch_stats"]), jax_make_eval_step(jm, CFG), port


def test_eigen_crop_and_depth_metrics_match():
    rng = np.random.default_rng(0)
    gt = np.where(rng.uniform(size=(60, 200)) < 0.3, rng.uniform(0.5, 90, (60, 200)), 0.0)
    gt = gt.astype(np.float32)
    np.testing.assert_array_equal(hook.eigen_crop_mask(gt), jax_hook.eigen_crop_mask(gt))
    disp = rng.uniform(0.01, 0.3, (32, 96)).astype(np.float32)
    for stereo in (False, True):
        got = hook.depth_metrics_single(disp, gt, stereo)
        want = jax_hook.depth_metrics_single(disp, gt, stereo)
        assert sorted(got) == sorted(want) == sorted(hook.DEPTH_KEYS)
        for k, w in want.items():
            assert abs(got[k] - w) <= 1e-6 * abs(w), (k, got[k], w)
    assert hook.depth_metrics_single(disp, np.zeros_like(gt)) is None
    assert jax_hook.depth_metrics_single(disp, np.zeros_like(gt)) is None


def test_eval_hook_matches_jax(ref):
    jm, state, jstep, port = ref
    jhook = jax_hook.EvalHook(jm, JaxDataLoader(
        jax_get_dataset(JaxConfig.fromdict({"data": DATA}).data, training=False),
        batch_size=2, shuffle=False, num_workers=1, drop_last=False), CFG)
    # The step compiled once, on the one key the model reads.
    jhook.eval_step = lambda st, b: jstep(st, {"color_aug": b["color_aug"]})
    want = jhook(state, 1)
    got = hook.EvalHook(port, DataLoader(
        get_dataset(Config.fromdict({"data": DATA}).data, training=False),
        batch_size=2, shuffle=False, num_workers=1, drop_last=False), CFG, device="cpu")(None, 1)
    assert sorted(got) == sorted(want)
    assert got["n_eval_samples"] == want["n_eval_samples"] == 3
    assert got["fps"] > 0
    for k in hook.DEPTH_KEYS:
        assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), (k, got[k], want[k])
    for k in ("road_iou", "road_map"):
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])


def _outputs_match(jstep, state, port, what):
    batch = jax_synthetic_batch(2, H, H, OCC, seed=3)
    want = jstep(state, {"color_aug": jnp.asarray(batch["color_aug"])})
    got = make_eval_step(port, device="cpu")(synthetic_batch(2, H, H, OCC, seed=3))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert_close(nhwc(g) if g.dim() == 4 else g.numpy(), w, TOL, f"{what}: {k}")


def _baseline_file(path, port, kind):
    """A reference-format Baseline `.pth` from a seeded random state: the
    road branch's entries, the vehicle branch's (copies under the B names)
    and the dead `res_conv`."""
    rng = np.random.default_rng(11)
    sd = {}
    for k, v in port.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = v
        elif k.endswith("running_var"):
            sd[k] = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
        else:
            scale = 1 / np.sqrt(max(1, v[0].numel())) if v.dim() > 1 else 0.1
            sd[k] = torch.from_numpy((scale * rng.standard_normal(v.shape)).astype(np.float32))
    for root in ("CycledViewProjection", "CrossViewTransformer", "LayoutDecoder",
                 "LayoutTransformDecoder"):
        sd.update({root + "B" + k[len(root):]: v for k, v in list(sd.items())
                   if k.startswith(root + ".")})
    sd["CrossViewTransformer.res_conv.weight"] = torch.zeros(128, 128, 1, 1)
    if kind == "module":
        sd = {"module." + k: v for k, v in sd.items()}
    torch.save({"state_dict": sd} if kind == "wrapped" else sd, path)


@pytest.mark.parametrize("kind", ["raw", "wrapped", "module"])
def test_load_torch_baseline_file_matches_jax(ref, kind, tmp_path):
    _, state, jstep, port = ref
    port = copy.deepcopy(port)
    path = str(tmp_path / "baseline.pth")
    _baseline_file(path, port, kind)
    jstate = jax_ckpt.load_torch_baseline_file(path, state)
    skipped = ckpt.load_torch_baseline_file(path, port)
    assert "CrossViewTransformer.res_conv.weight" in {k.removeprefix("module.") for k in skipped}
    _outputs_match(jstep, jstate, port, kind)


def _resnet_file(path, seed):
    """A torchvision-style ResNet-18 `.pth` (with `fc`) of random weights."""
    rng = np.random.default_rng(seed)
    trunk = JPerceiver(height=H, width=H, occ_map_size=OCC).DepthEncoder.encoder
    sd = {}
    for k, v in trunk.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = v
        elif k.endswith("running_var") or (k.endswith(".weight") and v.dim() == 1):
            sd[k] = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
        elif v.dim() == 4:
            sd[k] = torch.from_numpy((rng.standard_normal(v.shape)
                                      / np.sqrt(v[0].numel())).astype(np.float32))
        else:
            sd[k] = torch.from_numpy((0.1 * rng.standard_normal(v.shape)).astype(np.float32))
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, 512), torch.zeros(1000)
    torch.save(sd, path)


def test_apply_pretrained_encoders_matches_jax(ref, tmp_path):
    """Depth and pose files; the layout trunk takes the depth file."""
    _, state, jstep, port = ref
    port = copy.deepcopy(port)
    _resnet_file(tmp_path / "depth.pth", 1)
    _resnet_file(tmp_path / "pose.pth", 2)
    cfg = {"depth_pretrained_path": str(tmp_path / "depth.pth"),
           "pose_pretrained_path": str(tmp_path / "pose.pth")}
    jstate = jax_ckpt.apply_pretrained_encoders(state, cfg)
    ckpt.apply_pretrained_encoders(port, cfg)
    w = torch.load(tmp_path / "pose.pth")["conv1.weight"]
    assert torch.equal(port.PoseEncoder.encoder.conv1.weight, torch.cat([w, w], 1) / 2)
    _outputs_match(jstep, jstate, port, "pretrained")


def test_draw_odometry_matches_jax(ref, tmp_path):
    jm, state, _, port = ref
    seq_root, gt_dir = tmp_path / "seq", tmp_path / "gt"
    render_odometry_sequence(str(seq_root), "00", str(gt_dir), H, 12)
    torch.save({"state_dict": port.state_dict()}, tmp_path / "weights.pth")
    cfg = tmp_path / "cfg.py"
    cfg.write_text(f"model = {dict(name='JPerceiver', height=H, width=H, occ_map_size=OCC)!r}\n"
                   f"data = {dict(in_path=str(seq_root))!r}\n")
    res = draw_odometry.main(["--config", str(cfg), "--checkpoint", str(tmp_path / "weights.pth"),
                              "--sequence", "00", "--gt_dir", str(gt_dir),
                              "--out", str(tmp_path / "odom"), "--device", "cpu"])
    assert res["n_frames"] == 12 and (tmp_path / "odom" / "00.png").is_file()

    pose = jax.jit(lambda a, b: jm.apply({"params": state.params, "batch_stats": state.batch_stats},
                                         a, b, method=jm.pose_between))
    frames = sorted(os.listdir(seq_root / "00" / "image_2"))
    imgs = [jax_to_array(jax_resize_image(jax_pil_open_rgb(str(seq_root / "00" / "image_2" / f)),
                                          H, H))[None] for f in frames]
    rows = [np.eye(4)]
    for a, b in zip(imgs[:-1], imgs[1:]):
        rows.append(rows[-1] @ np.linalg.inv(np.asarray(pose(a, b), np.float64)[0]))
    assert_close(res["poses"], np.asarray(rows), 1e-4, "poses")
    rot = res["poses"][:, :3, :3]
    np.testing.assert_allclose(rot @ rot.transpose(0, 2, 1), np.broadcast_to(np.eye(3), rot.shape),
                               atol=1e-5)


# -- the eval mode after a training step ---------------------------------------

@pytest.fixture(scope="module")
def trained_once():
    """A road-only 128^2 model of the kitti_odom preset, with an eval step
    and a streaming function built on it before a training step is taken;
    returns (model, batch, eval step, streaming function)."""
    cfg = Config.fromfile(os.path.join(ROOT, "jperceiver_tpu_torch", "config", "presets",
                                       "kitti_odom_1024.py"))
    cfg.merge_from_dict({"model.height": H, "model.width": H, "model.occ_map_size": OCC,
                         "model.remat": False})
    torch.manual_seed(0)
    model = build_model(cfg.model)
    eval_step = make_eval_step(model, cfg.model, device="cpu")
    stream = make_streaming_fn(model, chunk=2, device="cpu")
    batch = synthetic_batch(1, H, H, OCC)
    make_train_step(model, cfg.model, "cpu", steps_per_epoch=1, optim_cfg=cfg)(batch)
    assert model.training
    return model, batch, eval_step, stream


def _stats(model):
    return {k: v.clone() for k, v in model.state_dict().items() if "running" in k}


def test_eval_step_after_a_training_step_runs_in_eval_mode(trained_once):
    model, batch, eval_step, _ = trained_once
    model.train()  # as the training step leaves it
    fresh = copy.deepcopy(model).eval()
    before = _stats(model)
    got = eval_step(batch)
    assert all(torch.equal(v, before[k]) for k, v in _stats(model).items())
    with torch.inference_mode():
        want = fresh({"color_aug": torch.as_tensor(batch["color_aug"])}, with_pose=True)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_streaming_after_a_training_step_runs_in_eval_mode(trained_once):
    model, batch, _, stream = trained_once
    model.train()  # as the training step leaves it
    fresh = copy.deepcopy(model).eval()
    frames = np.concatenate([batch["color_aug"][0], batch["color_aug"][0][:1]])  # 4 frames
    before = _stats(model)
    got = stream(frames)
    assert all(torch.equal(v, before[k]) for k, v in _stats(model).items())
    want = make_streaming_fn(fresh, chunk=2, device="cpu")(frames)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
