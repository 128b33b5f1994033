"""The port's data parallelism (`jperceiver_tpu_torch/parallel/`, DDP in
`engine/trainer.py`, ZeRO-1 in `engine/optim.py`, the eval hook's
all-reduce, `tools/train.py --launcher pytorch`) on the CPU over gloo.

Two ranks at B = 1 against one process at B = 2 (rank 0 runs that
reference itself once its process group is gone), each process on one
intra-op thread (`tests/torch_ddp_worker.py`), started as
`tests/test_multihost.py` starts its processes: a free port, a time limit
a child. The 128^2 float64 step (type static, so the CGT scale loss is on;
`loss_sum` 3, so the weighted cross-entropy is on) is run with `bn_groups`
1 (dropout on, the automask noise drawn) and 2 (dropout off, JAX's noise),
and the second is also held to the JAX step on a two-device mesh.

That JAX step is compiled without XLA's instruction fusion pass
(`xla_disable_hlo_passes="fusion"`). With it, the CPU backend recomputes
the pose stem's pool input inside the backward's equality compare with
other rounding than the forward's, and the mask misroutes: at B = 2 the
pose encoder's conv1 gradient comes out tens of percent of its scale away
from the same JAX step run op by op, with `xla_cpu_prefer_vector_width=128`
too (the flag `tests/test_torch_train_step.py` uses at B = 1). Without the
pass the jitted step agrees with the op-by-op one, and with the port, to
rounding.

Tolerances. Two ranks against one process: every loss to 1e-10 relative;
each gradient to 1e-10 of its own scale (a gradient below 1e-12 of the
step's largest G is zero in exact arithmetic -- a conv bias before a
train-mode BatchNorm -- and must be below 1e-12 G on both sides); every
running statistic to 1e-10 of its scale; every updated parameter to 1e-10
of its scale plus, element by element, lr * |dg| / eps (the worker applies
this bound, `torch_ddp_worker._compare`), the most by which
Adam's first step u = lr g / (|g| + eps) can move for a gradient that moved
by dg (the ranks sum BatchNorm's statistics and DDP its gradients in
another order than one process, so a gradient near eps moves its update by
up to 1e-9 of a parameter's scale). Against JAX: as
`tests/test_torch_train_step.py` holds the one-process step.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import jperceiver_tpu.models.common as jax_common_module
import jperceiver_tpu.models.jperceiver as jax_jperceiver_module
import jperceiver_tpu.ops.sampling as jax_sampling_module
from jperceiver_tpu.config import Config
from jperceiver_tpu.data import synthetic_batch as jax_synthetic_batch
from jperceiver_tpu.engine.train_state import TrainState
from jperceiver_tpu.engine.trainer import make_train_step as jax_make_train_step
from jperceiver_tpu.models import JPerceiver as JaxJPerceiver
from jperceiver_tpu.parallel import make_mesh, replicate, shard_batch
from jperceiver_tpu_torch import parallel
from jperceiver_tpu_torch.convert import state_dict_from_jax
from jperceiver_tpu_torch.data import synthetic_batch
from jperceiver_tpu_torch.engine.optim import build_optimizer
from jperceiver_tpu_torch.models.common import BatchNorm2d, set_bn_groups

from torch_ddp_worker import FLAGSHIP, GLOBAL_B, H, OCC, W
from torch_port_helpers import random_variables

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_ddp_worker.py")
CHILD_TIMEOUT_S = 600


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(role: str, d: str, port: int | None = None, rank: int = 0, world: int = 2):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    if port is not None:
        env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    return subprocess.Popen([sys.executable, WORKER, role, d], env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _wait(procs) -> None:
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a data-parallel worker timed out")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]


class _Float64Casts(types.ModuleType):
    """`jax.numpy` with `float32` read as `float64`."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def _keep_grads():
    """An optax transformation that leaves the parameters and stores the
    gradients as its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, u), u))


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64) if np.issubdtype(np.asarray(a).dtype,
                                                               np.floating) else jnp.asarray(a),
        tree)


def _jax_mesh_step(v, rng):
    """The JAX step at B = 2 on a two-device mesh with `bn_groups` 2, in
    float64 with dropout off; returns (metrics, bridged gradients and
    running statistics)."""
    batch = jax_synthetic_batch(GLOBAL_B, H, W, OCC, seed=3)
    cfg = Config.fromdict(dict(FLAGSHIP, warp_tap_dtype="float32", use_pallas_reproj=False,
                               bn_groups=2))
    mesh = make_mesh(jax.devices()[:2])
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        # The grouped BatchNorm computes its moments in jnp.float32 too.
        for module in (jax_jperceiver_module, jax_sampling_module, jax_common_module):
            mp.setattr(module, "jnp", _Float64Casts("jnp_float64_casts"))
        jm = JaxJPerceiver(height=H, width=W, occ_map_size=OCC, branches="road",
                           dtype=jnp.float64)
        params, stats = _f64(v["params"]), _f64(v["batch_stats"])
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                           opt_state=_keep_grads().init(params), tx=_keep_grads())
        state = jax.device_put(state, replicate(mesh))
        sharded = shard_batch(mesh, _f64(batch), process_local=False)
        step = jax_make_train_step(jm, cfg, donate=False).lower(state, sharded, rng).compile(
            compiler_options={"xla_disable_hlo_passes": "fusion"})
        new_state, metrics = step(state, sharded, rng)
        metrics = {k: float(a) for k, a in metrics.items()}
        as_np = (lambda t: jax.tree_util.tree_map(np.asarray, t))
        ref = state_dict_from_jax(as_np(new_state.opt_state), as_np(new_state.batch_stats))
    return metrics, ref


@pytest.fixture(scope="module")
def ddp(tmp_path_factory):
    """Two gloo ranks run the worker's steps, ZeRO-1 and eval, then rank 0
    the one-process reference; the JAX mesh step runs here meanwhile."""
    d = str(tmp_path_factory.mktemp("ddp"))
    batch = jax_synthetic_batch(GLOBAL_B, H, W, OCC, seed=3)
    v = random_variables(JaxJPerceiver(height=H, width=W, occ_map_size=OCC, branches="road"),
                         {k: jnp.asarray(a) for k, a in batch.items()}, train=True, seed=4)
    rng = jax.random.key(5)
    with jax.enable_x64(True):
        # The JAX step's automask draw: compute_losses splits the step's loss key.
        _, loss_rng = jax.random.split(jax.random.fold_in(rng, 0))
        noise = np.asarray(jax.random.normal(jax.random.split(loss_rng)[1],
                                             (4, 2, GLOBAL_B, H, W), jnp.float64) * 1e-5)
    torch.save({"weights": state_dict_from_jax(v["params"], v["batch_stats"]),
                "batch": synthetic_batch(GLOBAL_B, H, W, OCC, seed=3), "noise": noise},
               os.path.join(d, "inputs.pt"))
    port = _free_port()
    procs = [_spawn("rank", d, port, r) for r in range(2)]
    try:
        want, ref = _jax_mesh_step(v, rng)
    finally:
        _wait(procs)
    out = {name: torch.load(os.path.join(d, f"{name}.pt"), weights_only=False)
           for name in ("rank0", "rank1")}
    for f in ("inputs.pt", "rank0.pt", "rank1.pt"):  # ~0.4 GB: not kept on disk
        os.remove(os.path.join(d, f))
    out["jax"] = {"metrics": want, "ref": ref}
    return out


@pytest.mark.parametrize("name", ["bn1", "bn2"])
def test_two_ranks_equal_one_process_at_the_global_batch(ddp, name):
    cmp = ddp["rank0"]["cmp"][name]
    got, want = cmp["metrics"], cmp["metrics_one"]
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert abs(got[k] - w) <= 1e-10 * max(1.0, abs(w)), (k, got[k], w)
    big = max(scale for _, scale, _ in cmp["grads"].values())
    for n, (err, scale, ddp_max) in cmp["grads"].items():
        if scale <= 1e-12 * big:
            assert ddp_max <= 1e-12 * big, n
        else:
            assert err <= 1e-10 * scale, (n, err / scale)
    for k, (ok, rel) in cmp["state"].items():
        assert ok, (k, rel)
    # Every rank holds the same model after the step.
    assert ddp["rank0"]["digest"][name] == ddp["rank1"]["digest"][name]


def test_two_ranks_match_the_jax_step_on_a_two_device_mesh(ddp):
    want, ref = ddp["jax"]["metrics"], ddp["jax"]["ref"]
    got = ddp["rank0"]["bn2"]
    assert sorted(got["metrics"]) == sorted(want)
    for k, w in want.items():
        assert abs(got["metrics"][k] - w) <= 1e-4 * max(1.0, abs(w)), (k, got["metrics"][k], w)
    clip = min(1.0, 35.0 / want["grad_norm"])
    refs = {n: ref[n] * clip for n in got["grads"]}
    big = max(float(r.abs().max()) for r in refs.values())
    for n, g in got["grads"].items():
        scale = float(refs[n].abs().max())
        if scale <= 1e-12 * big:
            assert float(g.abs().max()) <= 1e-12 * big, n
        else:
            err = float((g.double() - refs[n]).abs().max())
            assert err <= 1e-3 * scale, (n, err / scale)
    for k, buf in got["running"].items():
        torch.testing.assert_close(buf, ref[k], rtol=1e-5, atol=1e-5, msg=k)


def test_zero1_on_and_off_agree_bit_for_bit(ddp):
    for r in ("rank0", "rank1"):
        z = ddp[r]["zero1"]
        assert z["off_equals_on"], r
    assert ddp["rank0"]["zero1"]["checksum"] == ddp["rank1"]["zero1"]["checksum"]


def test_zero1_shards_the_moments(ddp):
    z0, z1 = ddp["rank0"]["zero1"], ddp["rank1"]["zero1"]
    total = z0["param_elements"]
    assert z0["local_moment_elements"] + z1["local_moment_elements"] == total
    for z in (z0, z1):
        assert 0.45 * total <= z["local_moment_elements"] <= 0.55 * total, z


def test_zero1_save_and_restore_resume_bit_for_bit(ddp):
    for r in ("rank0", "rank1"):
        z = ddp[r]["zero1"]
        assert z["resumed_equals_on"] and z["resumed_epoch"] == 2 and z["iteration"] == 3, z


def test_bn_groups_other_than_one_or_the_world_size_is_refused(ddp):
    assert ddp["rank0"]["bn_groups_3_refused"] and ddp["rank1"]["bn_groups_3_refused"]


def test_eval_hook_two_ranks_count_every_sample_once(ddp):
    want = ddp["rank0"]["eval_one"]
    assert want["n_eval_samples"] == 5
    for r in ("rank0", "rank1"):
        got = ddp[r]["eval"]
        assert sorted(got) == sorted(want)
        assert got["n_eval_samples"] == 5
        for k, w in want.items():
            assert abs(got[k] - w) <= 1e-9 * max(1.0, abs(w)), (k, got[k], w)


def test_grouped_batchnorm_matches_jax_per_replica_bn():
    """One process, two groups: forward, running statistics and the
    gradients of x, scale and bias against the JAX `BatchNorm` under
    `per_replica_bn(2)`, float64."""
    from jperceiver_tpu.models.common import BatchNorm, per_replica_bn

    rng = np.random.default_rng(3)
    c = 6
    x = np.concatenate([rng.standard_normal((2, 5, 7, c)),
                        4.0 + 3.0 * rng.standard_normal((2, 5, 7, c))])
    cot = rng.standard_normal(x.shape)
    scale, bias = rng.uniform(0.5, 1.5, c), 0.1 * rng.standard_normal(c)
    mean0, var0 = 0.1 * rng.standard_normal(c), rng.uniform(0.5, 1.5, c)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        # The grouped path writes its moments' dtype as jnp.float32.
        mp.setattr(jax_common_module, "jnp", _Float64Casts("jnp_float64_casts"))
        bn = BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                       dtype=jnp.float64, param_dtype=jnp.float64)
        stats = {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}

        def f(xx, s, b):
            with per_replica_bn(2):
                return bn.apply({"params": {"scale": s, "bias": b}, "batch_stats": stats}, xx,
                                mutable=["batch_stats"])

        y, new = f(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
        _, pull = jax.vjp(lambda *a: f(*a)[0], jnp.asarray(x), jnp.asarray(scale),
                          jnp.asarray(bias))
        gx, gs, gb = (np.asarray(g) for g in pull(jnp.asarray(cot)))
        y, new = np.asarray(y), {k: np.asarray(v) for k, v in new["batch_stats"].items()}

    m = BatchNorm2d(c).double().train()
    set_bn_groups(m, 2)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
        m.running_mean.copy_(torch.from_numpy(mean0))
        m.running_var.copy_(torch.from_numpy(var0))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    yt = m(xt)
    yt.backward(torch.from_numpy(cot.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(yt.detach().numpy().transpose(0, 2, 3, 1), y, rtol=0, atol=1e-12)
    np.testing.assert_allclose(m.running_mean.numpy(), new["mean"], rtol=0, atol=1e-14)
    np.testing.assert_allclose(m.running_var.numpy(), new["var"], rtol=0, atol=1e-14)
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 1), gx, rtol=0,
                               atol=1e-12 * np.abs(gx).max())
    np.testing.assert_allclose(m.weight.grad.numpy(), gs, rtol=0, atol=1e-12 * np.abs(gs).max())
    np.testing.assert_allclose(m.bias.grad.numpy(), gb, rtol=0, atol=1e-12 * np.abs(gb).max())
    # Each group is normalized by its own moments.
    yn = (yt.detach().numpy() - bias[None, :, None, None]) / scale[None, :, None, None]
    for half in (yn[:2], yn[2:]):
        np.testing.assert_allclose(half.mean((0, 2, 3)), 0.0, atol=1e-10)


def test_single_process_helpers_are_the_identity():
    x = torch.arange(6.0).reshape(2, 3)
    assert not parallel.is_distributed()
    assert (parallel.rank(), parallel.world_size()) == (0, 1)
    assert parallel.all_reduce_sum(x) is x
    assert torch.equal(parallel.rank_rows(lambda s: torch.ones(s), (2, 3), dim=1),
                       torch.ones(2, 3))
    assert parallel.rank0_value("a") == "a"


def test_bn_groups_and_zero1_refuse_what_they_cannot_do(monkeypatch):
    model = BatchNorm2d(4)
    with pytest.raises(ValueError, match="bn_groups 0"):
        set_bn_groups(model, 0)
    with pytest.raises(ValueError, match="not divisible"):
        set_bn_groups(model, 3)
        model.train()(torch.zeros(4, 4, 2, 2))
    with pytest.raises(ValueError, match="process group"):
        build_optimizer({}, [torch.nn.Parameter(torch.zeros(2))], 10, zero1=True)
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        parallel.init_distributed("gloo", device="cpu")


def _cli_config(path: str, epochs: int) -> str:
    """The kitti_odom_1024 preset at 128^2 on 3 simulated scenes, one
    sample a rank: one step an epoch, 3 validation samples (one rank's
    shard padded)."""
    from jperceiver_tpu_torch.config import Config

    cfg = Config.fromfile(os.path.join(os.path.dirname(HERE), "jperceiver_tpu_torch", "config",
                                       "presets", "kitti_odom_1024.py"))
    cfg.merge_from_dict({"data.name": "simulated", "data.n_scenes": 3, "data.height": H,
                         "data.width": W, "model.height": H, "model.width": W,
                         "model.occ_map_size": OCC, "model.remat": False, "imgs_per_gpu": 1,
                         "workers_per_gpu": 1, "total_epochs": epochs, "validate": True,
                         "log_config.interval": 1})
    with open(path, "w") as f:
        f.write("".join(f"{k} = {v!r}\n" for k, v in cfg.to_dict().items()))
    return path


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """`tools.train --launcher pytorch --dist_backend gloo` on two ranks: one
    epoch, then `--resume_from` to a second (in the same two processes, a
    new process group), each rank recording what it wrote."""
    d = tmp_path_factory.mktemp("cli")
    work = str(d / "run")
    runs = []
    for epochs, extra in ((1, []), (2, ["--resume_from", work])):
        argv = ["--config", _cli_config(str(d / f"cfg{epochs}.py"), epochs), "--work_dir", work,
                "--seed", "0", "--device", "cpu", "--launcher", "pytorch",
                "--dist_backend", "gloo", *extra]
        runs.append({"argv": argv, "work_dir": work, "port": _free_port()})
    torch.save({"runs": runs}, str(d / "inputs.pt"))
    _wait([_spawn("cli", str(d), runs[0]["port"], r) for r in range(2)])
    out = [torch.load(str(d / f"cli{r}.pt"), weights_only=False) for r in range(2)]
    runs = {name: [out[0][i], out[1][i]] for i, name in enumerate(("train", "resume"))}
    logs = [os.path.join(work, f) for f in os.listdir(work) if f.endswith(".log.json")]
    payloads = [json.loads(line) for f in sorted(logs) for line in open(f)]
    saved = sorted(os.listdir(os.path.join(work, "checkpoints")))
    shutil.rmtree(work)  # three 0.58 GB checkpoints
    return runs, payloads, saved


def test_train_cli_two_ranks_rank0_alone_writes(cli_runs):
    runs, payloads, saved = cli_runs
    for name, ckpts in (("train", ["epoch_0.pth", "epoch_1.pth"]), ("resume", ["epoch_2.pth"])):
        r0, r1 = runs[name]
        assert r1["wrote"] == [], (name, r1["wrote"])
        assert [w for w in r0["wrote"] if w.startswith("checkpoints")] == [
            os.path.join("checkpoints", c + ".tmp") for c in ckpts], r0["wrote"]
        assert sum(w.endswith(".log.json") for w in r0["wrote"]) == 1, r0["wrote"]
    assert saved == [f"epoch_{e}.pth" for e in range(3)]
    vals = [p for p in payloads if p["mode"] == "val"]
    assert [p["epoch"] for p in vals] == [1, 2]
    assert all(p["n_eval_samples"] == 3 for p in vals), vals
    assert all(np.isfinite(p["loss"]) for p in payloads if p["mode"] == "train")


def test_train_cli_resume_from_on_both_ranks(cli_runs):
    runs, _, _ = cli_runs
    for name, it in (("train", 1), ("resume", 2)):
        r0, r1 = runs[name]
        assert r0["iteration"] == r1["iteration"] == it, (name, r0, r1)
        assert r0["checksum"] == r1["checksum"], name
    assert runs["resume"][0]["checksum"] != runs["train"][0]["checksum"]
