"""The port's checkpoints, resume and `fit_resilient` on the CPU.

Runs go through the train CLI (`tools/train.py`) at 128^2 on the kitti_odom
preset (simulated scenes, one step an epoch, remat off, no validation, Adam
with its first moment in bf16: `optimizer.mu_dtype`), on one intra-op
thread, where PyTorch's CPU step is deterministic. A run resumed after
epoch 1 (`--resume_from`), and one that a `RuntimeError` from its loader in
epoch 2 sends through `fit_resilient`'s restart, each end with the
uninterrupted two-epoch run's checkpoint: the model, the optimizer state
(the bf16 moment, which `Optimizer.load_state_dict` would cast to fp32,
included), the iteration and the generator, bit for bit. Both start from
the uninterrupted run's epoch-1 checkpoint, the state a run stopped there
leaves. `TypeError`, `ValueError` and `KeyError` are not retried; an
`OSError` is, three times. On a small model, fp32 Adam and the bf16-moment
Adam go on after a restore as the saved run does.

The JAX package's `_merge_matching` fixes which entries a non-strict load
skips; `load_weights(strict=False)` skips the same ones, by the weight
bridge's names.
"""

import glob
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from jperceiver_tpu.engine.checkpoint import _merge_matching
from jperceiver_tpu.models import JPerceiver as JaxJPerceiver
from jperceiver_tpu_torch.config import Config
from jperceiver_tpu_torch.convert import _module_key, state_dict_from_jax
from jperceiver_tpu_torch.data import loader as loader_mod
from jperceiver_tpu_torch.engine.checkpoint import (checkpoint_path, latest_epoch, load_weights,
                                                    restore_checkpoint, save_checkpoint)
from jperceiver_tpu_torch.engine.optim import AdamLowPrecisionMu
from jperceiver_tpu_torch.models import JPerceiver
from jperceiver_tpu_torch.tools import train as train_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = 128
MU = "bfloat16"


def write_config(path, epochs, mu_dtype=None):
    cfg = Config.fromfile(os.path.join(ROOT, "jperceiver_tpu_torch", "config", "presets",
                                       "kitti_odom_1024.py"))
    cfg.merge_from_dict({"data.name": "simulated", "data.n_scenes": 2, "data.height": H,
                         "data.width": H, "model.height": H, "model.width": H,
                         "model.occ_map_size": H // 4, "model.remat": False,
                         "imgs_per_gpu": 1, "workers_per_gpu": 1, "total_epochs": epochs,
                         "validate": False})
    if mu_dtype:
        cfg.merge_from_dict({"optimizer.mu_dtype": mu_dtype})
    with open(path, "w") as f:
        f.write("".join(f"{k} = {v!r}\n" for k, v in cfg.to_dict().items()))
    return str(path)


def train(cfg_path, work_dir, *extra):
    return train_cli.main(["--config", cfg_path, "--work_dir", str(work_dir), "--seed", "0",
                           "--max_steps_per_epoch", "1", "--device", "cpu", *extra])


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def whole(one_thread, tmp_path_factory):
    """The uninterrupted two-epoch run's work dir (Adam's first moment in
    bf16, as the resumed runs)."""
    wd = tmp_path_factory.mktemp("whole")
    train(write_config(wd / "cfg.py", 2, MU), wd)
    return wd


def _ckpt(work_dir, epoch=2):
    return torch.load(checkpoint_path(str(work_dir), epoch), weights_only=True)


def assert_same_checkpoint(a, b):
    assert a.keys() == b.keys() and a["epoch"] == b["epoch"]
    assert a["iteration"] == b["iteration"]
    assert torch.equal(a["generator"], b["generator"])
    assert a["state_dict"].keys() == b["state_dict"].keys()
    for k, v in a["state_dict"].items():
        assert v.dtype == b["state_dict"][k].dtype and torch.equal(v, b["state_dict"][k]), k
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        assert sa[i].keys() == sb[i].keys()
        for k, v in sa[i].items():
            w = sb[i][k]
            if isinstance(v, torch.Tensor):
                assert v.dtype == w.dtype and torch.equal(v, w), (i, k)
            else:
                assert v == w, (i, k)
    assert a["optimizer"]["param_groups"] == b["optimizer"]["param_groups"]


def after_epoch_1(whole, work_dir):
    """`work_dir` holding the epoch-1 checkpoint of the uninterrupted run:
    the state a run stopped after its first epoch leaves."""
    os.makedirs(work_dir / "checkpoints")
    shutil.copy(checkpoint_path(str(whole), 1), checkpoint_path(str(work_dir), 1))
    return str(work_dir)


def test_resumed_run_equals_uninterrupted(whole, tmp_path):
    resume = after_epoch_1(whole, tmp_path / "first")
    trainer = train(write_config(tmp_path / "cfg.py", 2, MU), tmp_path, "--resume_from", resume)
    assert trainer.train_step.iteration == 2
    assert isinstance(trainer.train_step.optimizer, AdamLowPrecisionMu)
    ck = _ckpt(tmp_path)
    mus = [st["mu"] for st in ck["optimizer"]["state"].values()]
    assert mus and all(m.dtype == torch.bfloat16 for m in mus)
    assert_same_checkpoint(ck, _ckpt(whole))


def _failing_iter(exc, calls, epoch):
    """DataLoader.__iter__ that raises `exc` once, when epoch index `epoch`
    starts; `calls` records the epochs begun."""
    orig = loader_mod.DataLoader.__iter__

    def it(self):
        calls.append(self.epoch)
        if self.epoch == epoch and calls.count(epoch) == 1:
            raise exc
        return orig(self)

    return it


def test_fit_resilient_restart_equals_uninterrupted(whole, tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(loader_mod.DataLoader, "__iter__",
                        _failing_iter(RuntimeError("simulated loader failure"), calls, 1))
    trainer = train(write_config(tmp_path / "cfg.py", 2, MU), tmp_path,
                    "--resume_from", after_epoch_1(whole, tmp_path))
    assert calls == [1, 1]  # epoch 2 begun twice: once failed, once after the restore
    assert trainer.train_step.iteration == 2
    logs = [json.loads(line) for f in glob.glob(str(tmp_path / "*.log.json"))
            for line in open(f)]
    restarts = [p for p in logs if p["mode"] == "restart"]
    assert restarts == [{"mode": "restart", "error": "simulated loader failure", "attempt": 1}]
    assert_same_checkpoint(_ckpt(tmp_path), _ckpt(whole))


def test_fit_resilient_restart_before_any_checkpoint(whole, tmp_path, monkeypatch):
    """A failure in epoch 1, before any epoch's checkpoint: the restart
    restores the starting state's checkpoint (epoch 0), which
    `fit_resilient` saved first, and the run ends as the uninterrupted one."""
    calls = []
    monkeypatch.setattr(loader_mod.DataLoader, "__iter__",
                        _failing_iter(RuntimeError("simulated loader failure"), calls, 0))
    trainer = train(write_config(tmp_path / "cfg.py", 2, MU), tmp_path)
    assert calls == [0, 0, 1]
    assert trainer.train_step.iteration == 2
    assert_same_checkpoint(_ckpt(tmp_path), _ckpt(whole))


@pytest.mark.parametrize("exc", [TypeError, ValueError, KeyError])
def test_fit_resilient_does_not_retry_programming_errors(exc, tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(loader_mod.DataLoader, "__iter__",
                        _failing_iter(exc("a bug"), calls, 0))
    with pytest.raises(exc, match="a bug"):
        train(write_config(tmp_path / "cfg.py", 2), tmp_path)
    assert calls == [0]


def test_fit_resilient_gives_up_after_max_restarts(tmp_path, monkeypatch):
    """An OSError every time: three restarts from the checkpoint of the
    starting state, which `fit_resilient` saves first, then raised."""
    calls = []

    def it(self):
        calls.append(self.epoch)
        raise OSError("disk gone")

    monkeypatch.setattr(loader_mod.DataLoader, "__iter__", it)
    with pytest.raises(OSError, match="disk gone"):
        train(write_config(tmp_path / "cfg.py", 2), tmp_path)
    assert calls == [0, 0, 0, 0]
    assert os.listdir(tmp_path / "checkpoints") == ["epoch_0.pth"]


class _Step:
    """What a checkpoint reads of a `TrainStep`: a small model and its
    optimizer, fp32 Adam or Adam with a bf16 first moment."""

    def __init__(self, seed, mu_dtype):
        torch.manual_seed(seed)
        self.model = torch.nn.Linear(3, 2)
        self.optimizer = (torch.optim.Adam(self.model.parameters(), 1e-2) if mu_dtype is None
                          else AdamLowPrecisionMu(self.model.parameters(), 1e-2, mu_dtype))
        self.device = torch.device("cpu")
        self.iteration = seed
        self.generator = torch.Generator().manual_seed(seed)

    def __call__(self):
        self.optimizer.zero_grad()
        x = torch.rand(4, 3, generator=self.generator)
        (self.model(x) ** 2).sum().backward()
        self.optimizer.step()
        self.iteration += 1


@pytest.mark.parametrize("mu_dtype", [None, torch.bfloat16], ids=["adam", "mu_bf16"])
def test_save_keeps_the_newest_and_restores_in_place(mu_dtype, tmp_path):
    """Restored into another step, the run goes on as the saved one does."""
    step = _Step(1, mu_dtype)
    for epoch in range(1, 5):
        step()
        save_checkpoint(str(tmp_path), step, epoch, max_to_keep=2)
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["epoch_3.pth", "epoch_4.pth"]
    assert latest_epoch(str(tmp_path)) == 4
    other = _Step(2, mu_dtype)
    assert restore_checkpoint(str(tmp_path), other) == 4
    for _ in range(3):
        step()
        other()
    assert other.iteration == step.iteration == 8
    for a, b in zip(step.model.parameters(), other.model.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(other.generator.get_state(), step.generator.get_state())
    st = other.optimizer.state[other.model.weight]
    if mu_dtype is not None:
        assert st["mu"].dtype == mu_dtype
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), other)


def test_non_strict_load_skips_what_merge_matching_skips(tmp_path):
    """A both-branch checkpoint with three classes into a road-only model of
    two: the vehicle branch is absent and the road topview convs' shapes
    differ. The JAX tree comes from `jax.eval_shape` (no compile); the
    checkpoint's tree is made from it."""
    jm = JaxJPerceiver(height=H, width=H, occ_map_size=H // 4, branches="road")
    v = jax.eval_shape(lambda: jm.init({"params": jax.random.key(0), "dropout": jax.random.key(1)},
                                       {"color_aug": jax.numpy.zeros((1, 3, H, H, 3))},
                                       train=False, with_pose=True))
    rng = np.random.default_rng(0)
    cur = jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                                 {"params": dict(v["params"]),
                                  "batch_stats": dict(v["batch_stats"])})
    new = jax.tree_util.tree_map(lambda a: a + 1.0, cur)
    for col in new.values():
        for root in ("cvp", "cct", "layout_decoder", "layout_transform_decoder"):
            if root in col:
                col[root + "_b"] = col[root]
    for dec in ("layout_decoder", "layout_transform_decoder"):
        conv = dict(new["params"][dec]["topview"]["conv"])
        conv["kernel"] = np.concatenate([conv["kernel"], conv["kernel"][..., :1]], -1)
        conv["bias"] = np.concatenate([conv["bias"], conv["bias"][:1]])
        new["params"][dec] = dict(new["params"][dec], topview={"conv": conv})

    want = set()
    for col in ("params", "batch_stats"):
        _, _, skipped = _merge_matching(cur[col], new[col])
        for path in skipped:
            parts = path.split("/")
            name = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
                    "var": "running_var"}[parts[-1]] if parts[-1] != "bias" else "bias"
            want.add(f"{_module_key(tuple(parts[:-1]))}.{name}")
    loaded = state_dict_from_jax(new["params"], new["batch_stats"])
    torch.save({"state_dict": loaded}, tmp_path / "both.pth")
    model = JPerceiver(height=H, width=H, occ_map_size=H // 4, branches="road")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    skipped = load_weights(str(tmp_path / "both.pth"), model, strict=False)
    assert len(want) > 100
    assert {k for k in skipped if not k.endswith("num_batches_tracked")} == want
    for k, val in model.state_dict().items():
        want_val = loaded[k] if k in loaded and k not in skipped else before[k]
        assert torch.equal(val, want_val), k
    with pytest.raises(RuntimeError):
        load_weights(str(tmp_path / "both.pth"), model, strict=True)


def test_a_failed_step_stops_the_prefetch_thread(tmp_path):
    """A step that fails mid-epoch (as before a `fit_resilient` restart)
    leaves no prefetch thread behind, blocked on a full queue."""
    import threading
    import time

    from jperceiver_tpu_torch.engine.trainer import Trainer
    from jperceiver_tpu_torch.models import build_model

    cfg = Config.fromfile(write_config(tmp_path / "cfg.py", 1))
    batches = [{"x": np.zeros(2, np.float32)} for _ in range(8)]
    trainer = Trainer(build_model(cfg.model), cfg, batches, len(batches), device="cpu")
    calls = []

    def failing_step(batch):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("step failed")
        return {}

    before = threading.active_count()
    trainer.train_step = failing_step
    with pytest.raises(RuntimeError, match="step failed"):
        trainer.fit(1)
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before
