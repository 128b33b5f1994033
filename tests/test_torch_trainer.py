"""The port's `Trainer` (the epoch loop) against `make_train_step` and the
JAX package's `Trainer`.

Two epochs of `Trainer.fit` on the CPU, over the port's `DataLoader` of
`SimulatedDataset` scenes at 128^2 (the smallest input the model takes),
with the flagship preset's model built by `build_model` (remat off, which
`test_torch_remat.py` holds to remat on), give
the parameters, BatchNorm statistics and generator state of the same
number of `make_train_step` calls on the batches the loader gives for
`set_epoch(0)` and `set_epoch(1)`: exactly, as the two run the same
operations on one intra-op thread (with more, PyTorch's CPU step is not
deterministic: two runs of it differ by ~1e-6). Their log payloads carry the keys of the JAX `Trainer`'s, whose
loop runs here with its step replaced by one that returns the JAX loss
dict's keys (read with `jax.eval_shape`, no compile).
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jperceiver_tpu.engine.trainer as jax_trainer
from jperceiver_tpu.engine.optim import build_optimizer as jax_build_optimizer
from jperceiver_tpu.config import Config as JaxConfig
from jperceiver_tpu.data import DataLoader as JaxDataLoader
from jperceiver_tpu.losses import compute_losses as jax_compute_losses
from jperceiver_tpu_torch.config import Config
from jperceiver_tpu_torch.data import DataLoader, get_dataset
from jperceiver_tpu_torch.engine import (JsonLogger, Trainer, device_summary,
                                         get_root_logger, make_train_step, set_random_seed)
from jperceiver_tpu_torch.engine.optim import Adam
from jperceiver_tpu_torch.models import build_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = 128


def _cfg():
    cfg = Config.fromfile(os.path.join(ROOT, "jperceiver_tpu_torch", "config", "presets",
                                       "kitti_odom_1024.py"))
    cfg.merge_from_dict({"data.name": "simulated", "data.n_scenes": 3, "data.height": H,
                         "data.width": H, "model.height": H, "model.width": H,
                         "model.occ_map_size": H // 4, "model.remat": False})
    return cfg


def _loader(cfg):
    ds = get_dataset(cfg.data, training=True, with_sdf=True)
    return DataLoader(ds, batch_size=1, num_workers=2)


def _model(cfg):
    torch.manual_seed(0)
    return build_model(cfg.model)


@pytest.fixture(scope="module")
def idle_model():
    """One model for the tests whose Trainer takes no step."""
    return _model(_cfg())


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fitted(one_thread):
    """Two epochs of one step each (`steps_per_epoch` 1: the first batch
    of each epoch's permutation), with every callback."""
    cfg = _cfg()
    loader = _loader(cfg)
    logs, ckpt = [], []
    trainer = Trainer(_model(cfg), cfg, loader, steps_per_epoch=1, device="cpu",
                      eval_hook=lambda step, epoch: {"abs_rel": 0.5 / epoch},
                      checkpoint_fn=lambda step, epoch: ckpt.append(
                          (epoch, step.iteration, type(step.optimizer).__name__,
                           step.generator.get_state().clone())),
                      log_fn=logs.append, log_interval=1)
    step = trainer.fit(2)
    return cfg, trainer, step, logs, ckpt


def test_fit_equals_train_step_calls(fitted):
    cfg, trainer, step, logs, ckpt = fitted
    ref_loader = _loader(cfg)
    ref = make_train_step(_model(cfg), cfg.model, "cpu", steps_per_epoch=1, optim_cfg=cfg)
    firsts = []
    for epoch in range(2):
        ref_loader.set_epoch(epoch)
        batch = next(iter(ref_loader))
        firsts.append(batch["color"].sum())
        ref(batch)
    assert firsts[0] != firsts[1]  # the epochs' permutations differ
    assert step.iteration == ref.iteration == 2
    for (n, p), (_, q) in zip(step.model.named_parameters(), ref.model.named_parameters()):
        assert torch.equal(p, q), n
    for (n, b), (_, c) in zip(step.model.named_buffers(), ref.model.named_buffers()):
        assert torch.equal(b, c), n
    assert torch.equal(step.generator.get_state(), ref.generator.get_state())
    assert [c[:3] for c in ckpt] == [(1, 1, "Adam"), (2, 2, "Adam")]
    assert [len(w) for w in trainer.data_wait_s] == [2, 2]  # a batch, then the end
    train = [p for p in logs if p["mode"] == "train"]
    assert all(np.isfinite(p["loss"]) for p in train)


def _jax_metric_keys(cfg):
    """The JAX step's metric keys: its loss dict's, from `jax.eval_shape`
    of `compute_losses` at the model's output shapes, and the two keys
    `make_train_step` adds."""
    s, occ = H, H // 4
    f = len(cfg["frame_ids"])
    out = {f"disp/{k}": jax.ShapeDtypeStruct((1, s >> (k + 1), s >> (k + 1), 1), jnp.float32)
           for k in cfg["scales"]}
    for key in ("topview", "transform_topview"):
        out[key] = jax.ShapeDtypeStruct((1, occ, occ, 2), jnp.float32)
    for key in ("features", "retransform_features"):
        out[key] = jax.ShapeDtypeStruct((1, 1, 1, 128), jnp.float32)
    for fid in cfg["frame_ids"][1:]:
        out[f"cam_T_cam/{fid}"] = jax.ShapeDtypeStruct((1, 4, 4), jnp.float32)
    batch = {"color": jax.ShapeDtypeStruct((1, f, s, s, 3), jnp.float32),
             "K": jax.ShapeDtypeStruct((1, 4, 4), jnp.float32),
             "inv_K": jax.ShapeDtypeStruct((1, 4, 4), jnp.float32),
             "odometry_K": jax.ShapeDtypeStruct((1, 4, 4), jnp.float32),
             "Tr_cam2_velo": jax.ShapeDtypeStruct((1, 4, 4), jnp.float32),
             "bev_static": jax.ShapeDtypeStruct((1, occ, occ), jnp.float32),
             "bev_static_sdf": jax.ShapeDtypeStruct((1, occ, occ, 1), jnp.float32)}
    jcfg = JaxConfig.fromdict(dict(cfg, warp_tap_dtype="float32", use_pallas_reproj=False))
    loss = jax.eval_shape(lambda o, b: jax_compute_losses(o, b, jcfg, jax.random.key(0)),
                          out, batch)
    return list(loss) + ["loss", "grad_norm"]


def test_payload_keys_match_jax_trainer(fitted, monkeypatch):
    cfg, _, _, logs, _ = fitted
    keys = _jax_metric_keys(cfg.model)
    monkeypatch.setattr(jax_trainer, "make_train_step", lambda model, cfg: (
        lambda state, batch, rng: (state, {k: jnp.zeros(()) for k in keys})))
    from jperceiver_tpu.data.simulated import SimulatedDataset

    loader = JaxDataLoader(SimulatedDataset(n_scenes=2, height=64, width=64), batch_size=1,
                           num_workers=1)
    jlogs = []
    jt = jax_trainer.Trainer(None, None, loader, steps_per_epoch=1, mesh=object(),
                             eval_hook=lambda state, epoch: {"abs_rel": 0.5 / epoch},
                             checkpoint_fn=lambda state, epoch: None, log_fn=jlogs.append,
                             log_interval=1)
    monkeypatch.setattr(jt, "_shard", lambda batch: batch)
    jt.fit(None, 2)
    assert [(p["mode"], p["epoch"]) for p in logs] == [(p["mode"], p["epoch"]) for p in jlogs]
    for got, want in zip(logs, jlogs):
        assert sorted(got) == sorted(want), (got["mode"], sorted(set(got) ^ set(want)))
        if got["mode"] in ("train", "val"):
            assert {k: v for k, v in got.items() if not isinstance(v, float)} == \
                {k: v for k, v in want.items() if not isinstance(v, float)}


def test_trainer_builds_the_presets_optimizer(idle_model):
    """The optimizer comes from the run's top-level config, where the
    preset keeps it: Adam at 1e-4, the global-norm clip at 35 and the step
    milestone at epoch 50, the JAX schedule's at every iteration read."""
    cfg = _cfg()
    jcfg = JaxConfig.fromfile(os.path.join(ROOT, "jperceiver_tpu", "config", "presets",
                                           "kitti_odom_1024.py"))
    spe = 4
    step = Trainer(idle_model, cfg, [], steps_per_epoch=spe, device="cpu").train_step
    _, jsched = jax_build_optimizer(jcfg, spe)
    assert type(step.optimizer) is Adam and step.clip == 35.0
    for it in (0, 50 * spe - 1, 50 * spe, 180 * spe):
        assert step.schedule(it) == pytest.approx(float(jsched(it)), rel=1e-6), it
    assert step.schedule(50 * spe) == pytest.approx(1e-5)
    with pytest.raises(ValueError, match="run's config"):
        Trainer(idle_model, cfg.model, [], steps_per_epoch=spe, device="cpu")


def test_fit_raises_loader_errors(idle_model):
    class Broken:
        def __iter__(self):
            yield from ()
            raise OSError("corrupt sample")

    cfg = _cfg()
    trainer = Trainer(idle_model, cfg, Broken(), steps_per_epoch=2, device="cpu")
    with pytest.raises(OSError, match="corrupt sample"):
        trainer.fit(1)


def test_fit_traces_steps_10_to_14(idle_model, tmp_path):
    cfg = _cfg()
    loader = [{"color": np.zeros((1,))}] * 16
    trainer = Trainer(idle_model, cfg, loader, steps_per_epoch=16, device="cpu",
                      profile_dir=str(tmp_path))
    ran = []
    trainer.train_step = lambda batch: ran.append(len(ran)) or {"loss": torch.zeros(())}
    trainer.fit(2)
    assert len(ran) == 32
    trace = tmp_path / "steps_10_14.trace.json"
    assert trace.is_file() and json.loads(trace.read_text())["traceEvents"]


def test_fit_traces_replays_only_after_a_ddp_capture(idle_model, tmp_path):
    """A step captured under DDP warms up `DDP_WARMUP` times and captures
    at the next step: the five traced steps are the replays after it."""
    from jperceiver_tpu_torch.engine.graphs import DDP_WARMUP

    loader = [{"color": np.zeros((1,))}] * 20
    trainer = Trainer(idle_model, _cfg(), loader, steps_per_epoch=20, device="cpu",
                      profile_dir=str(tmp_path))
    ran = []

    class _CapturedUnderDDP:
        graphed = True
        graphs = types.SimpleNamespace(warmup=DDP_WARMUP)

        def __call__(self, batch):
            ran.append(len(ran))
            return {"loss": torch.zeros(())}

    trainer.train_step = _CapturedUnderDDP()
    trainer.fit(1)
    assert len(ran) == 20
    assert [p.name for p in tmp_path.iterdir()] == ["steps_12_16.trace.json"]


def test_trainer_refuses_without_cuda(idle_model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(idle_model, cfg, [], steps_per_epoch=1)


def test_logger_and_env(tmp_path):
    log = JsonLogger(str(tmp_path), stamp="run")
    log({"mode": "train", "epoch": 1, "iter": 2, "loss": 1.5})
    log({"mode": "epoch_time", "epoch": 1, "seconds": 3.0})
    lines = (tmp_path / "run.log.json").read_text().splitlines()
    assert [json.loads(line)["mode"] for line in lines] == ["train", "epoch_time"]
    assert get_root_logger().name == "jperceiver_tpu_torch"
    set_random_seed(5)
    a = (np.random.rand(), torch.rand(1))
    set_random_seed(5)
    assert a == (np.random.rand(), torch.rand(1))
    assert "CUDA device(s)" in device_summary()
