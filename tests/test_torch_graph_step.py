"""The port's entry points as CUDA graphs (`engine/graphs.py`), on the CPU.

A capture records the device work of one call and every replay repeats it,
so the body of a captured call must do all its work on the device: no read
back to the host, no output whose shape depends on the data, no tensor made
from Python data (a copy from host memory). A `TorchDispatchMode` audit
runs each body after its warm-up call, as a capture would, and fails on
`aten._local_scalar_dense` (`.item()`, `bool(t)`), the ops whose output
shape depends on the data, and `aten.lift_fresh` (`torch.tensor(data)`):
the training step's body of the flagship configuration at 128^2 (B = 1
and 2, remat on and off), the eval step's forward and a streaming chunk.

The step's learning rate and Adam's counts live on the device (filled
before a step, advanced by it): six steps across a linear warmup and an LR
milestone against optax through the JAX package's `build_optimizer`, in
float64, to 1e-6 as `test_torch_train_optim.py` holds the optimizer. The
remat trunks keep no RNG state (`preserve_rng_state=False`), which changes
no bit of the remat step. A restore in the middle of a run goes on bit for
bit as the run that was not interrupted. A capture and its replays keep the
kernel launch counters true (a stand-in for the graph object). Every test
runs on one intra-op thread: the multi-threaded CPU step is not
bit-reproducible.
"""

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jperceiver_tpu_torch.models.jperceiver as port_jperceiver
from jperceiver_tpu.engine import optim as jax_optim
from jperceiver_tpu_torch.data import synthetic_batch
from jperceiver_tpu_torch.engine import (make_eval_step, make_streaming_fn, make_train_step,
                                         restore_checkpoint, save_checkpoint)
from jperceiver_tpu_torch.engine import graphs
from jperceiver_tpu_torch.engine.optim import (Adam, AdamLowPrecisionMu, build_optimizer,
                                               clip_by_global_norm_, global_norm, param_labels,
                                               set_lr)
from jperceiver_tpu_torch.engine.trainer import batch_to
from jperceiver_tpu_torch.models import JPerceiver
from jperceiver_tpu_torch.models.common import BatchNorm2d
from jperceiver_tpu_torch.ops import cuda as kernels
from jperceiver_tpu_torch.ops.cuda import conv3x3, maxpool

H = W = 128
OCC = 32
FLAGSHIP = dict(
    type="static", split="odometry", frame_ids=[0, -1, 1], scales=[0, 1, 2, 3],
    height=H, width=W, occ_map_size=OCC, num_class=2, min_depth=0.1, max_depth=100.0,
    automask=True, disp_norm=True, smoothness_weight=1e-3, scale_weight=0.1,
    static_weight=5.0, dynamic_weight=15.0, loss_type="iou", loss_sum=3, loss_weight=20,
    loss2_weight=20, loss_weightS=20, loss2_weightS=20, cgt_label_hw=(375, 1242),
    optimizer=dict(type="Adam", lr=1e-4, weight_decay=0),
    optimizer_config=dict(grad_clip=dict(max_norm=35, norm_type=2)),
    lr_config=dict(policy="step", warmup=None, step=[50]))
# Ops that a captured body must not reach: a read back to the host, an
# output shape that depends on the data, a tensor made from Python data.
REFUSED = {"_local_scalar_dense", "nonzero", "masked_select", "unique", "_unique",
           "_unique2", "unique_dim", "unique_consecutive", "lift_fresh", "lift_fresh_copy"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Audit(TorchDispatchMode):
    """Records the refused ops a block dispatches, with where they came from."""

    def __init__(self):
        super().__init__()
        self.refused: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in REFUSED:
            import traceback

            frames = [f for f in traceback.extract_stack() if "jperceiver_tpu_torch" in f.filename]
            where = f"{frames[-1].filename}:{frames[-1].lineno}" if frames else "?"
            self.refused.append(f"{name} at {where}")
        return func(*args, **(kwargs or {}))


def _audit(fn) -> list[str]:
    audit = _Audit()
    with audit:
        fn()
    return audit.refused


def _model(**kw):
    torch.manual_seed(0)
    return JPerceiver(height=H, width=W, occ_map_size=OCC, branches="road", **kw)


@pytest.mark.parametrize("b,remat", [(1, False), (1, True), (2, False), (2, True)])
def test_train_step_body_is_capture_safe(b, remat):
    step = make_train_step(_model(remat=remat), FLAGSHIP, device="cpu", steps_per_epoch=1000)
    batch = batch_to(synthetic_batch(b, H, W, OCC, seed=1), "cpu")
    step(batch)  # the warm-up call, eager as on the card
    inputs = dict(batch, noise=None)
    assert _audit(lambda: step.graphs.body(**inputs)) == []
    assert step.iteration == 1 and not step.graphed


def test_eval_and_streaming_bodies_are_capture_safe():
    model = _model()
    ev = make_eval_step(model, device="cpu")
    x = torch.rand(2, 3, 3, H, W, generator=torch.Generator().manual_seed(0))
    ev({"color_aug": x})
    assert _audit(lambda: ev.graphs.body(color_aug=x)) == []
    run = make_streaming_fn(model, chunk=2, device="cpu")
    frames = torch.rand(4, 3, H, W, generator=torch.Generator().manual_seed(1))
    run(frames)
    with torch.inference_mode():
        carry = {"prev": frames[:1].clone(), "gpose": torch.eye(4)}
        assert _audit(lambda: run.graphs.body(seg=frames[1:3], **carry)) == []


def test_streaming_chunks_and_carry_match_one_chunk():
    """The carry between chunks (in place, as the graphs hold it) gives
    what one chunk over every frame gives, a shorter last chunk included."""
    model = _model()
    frames = torch.rand(6, 3, H, W, generator=torch.Generator().manual_seed(2))
    pose = torch.eye(4)
    pose[0, 3] = 2.0
    whole = make_streaming_fn(model, chunk=5, device="cpu")(frames, init_pose=pose)
    parts = make_streaming_fn(model, chunk=2, device="cpu")(frames, init_pose=pose)
    assert sorted(whole) == sorted(parts)
    for k, v in whole.items():
        assert v.shape[0] == 5
        torch.testing.assert_close(parts[k], v, rtol=1e-5, atol=1e-5, msg=k)


class _Tiny(torch.nn.Module):
    """conv (weight, bias) and a BatchNorm (weight, bias): the three labels."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 4, 3)
        self.bn1 = BatchNorm2d(4)


def _flax_tree(p):
    return {"conv": {"kernel": p["conv.weight"], "bias": p["conv.bias"]},
            "bn1": {"scale": p["bn1.weight"], "bias": p["bn1.bias"]}}


@pytest.mark.parametrize("opt_cfg", [
    {"type": "Adam", "lr": 1e-2, "weight_decay": 0.0},
    {"type": "Adam", "lr": 1e-2, "weight_decay": 1e-2},
    {"type": "Adam", "lr": 1e-2, "weight_decay": 0.0, "mu_dtype": "bfloat16"},
    {"type": "SGD", "lr": 1e-2, "momentum": 0.9},
], ids=["adam", "adamw", "adam_mu_bf16", "sgd"])
def test_device_lr_and_counts_match_optax_across_warmup_and_milestone(opt_cfg):
    """Six steps, the warmup over the first three and the milestone at
    iteration 4 (epoch 1 of 4 steps): each step's parameters to 1e-6 of
    optax's in float64; the lr and the counts are device tensors that the
    steps advance, not host values."""
    cfg = {"optimizer": dict(opt_cfg, paramwise_options={"bias_lr_mult": 2.0}),
           "optimizer_config": {"grad_clip": {"max_norm": 35.0}},
           "lr_config": {"policy": "step", "step": [1], "warmup": "linear",
                         "warmup_iters": 3, "warmup_ratio": 0.25}}
    model = _Tiny().double()
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape)))
    names = [n for n, _ in model.named_parameters()]
    labels = param_labels(model)
    params = list(model.parameters())
    opt, sched, clip = build_optimizer(cfg, params, steps_per_epoch=4,
                                       labels=[labels[n] for n in names])
    assert all(isinstance(g["lr"], torch.Tensor) and g["lr"].dtype == torch.float64
               for g in opt.param_groups)
    lrs = [g["lr"] for g in opt.param_groups]
    with jax.enable_x64(True):
        jp = _flax_tree({n: jnp.asarray(p.detach().numpy()) for n, p in model.named_parameters()})
        tx, jsched = jax_optim.build_optimizer(cfg, steps_per_epoch=4, params=jp)
        state = tx.init(jp)
        for i in range(6):
            grads = {n: rng.standard_normal(p.shape) * (40.0 if i % 2 else 1.0)
                     for n, p in model.named_parameters()}
            upd, state = tx.update(_flax_tree({n: jnp.asarray(g) for n, g in grads.items()}),
                                   state, jp)
            jp = optax.apply_updates(jp, upd)
            for n, p in model.named_parameters():
                p.grad = torch.from_numpy(grads[n].copy())
            gl = [p.grad for p in params]
            clip_by_global_norm_(gl, global_norm(gl), clip)
            set_lr(opt, sched, i)
            assert [g["lr"] for g in opt.param_groups] == lrs  # filled in place
            assert float(opt.param_groups[0]["lr"]) == pytest.approx(float(jsched(i)),
                                                                     rel=1e-6)
            opt.step()
            got = _flax_tree(dict(model.named_parameters()))
            for mod, leaves in got.items():
                for leaf, t in leaves.items():
                    np.testing.assert_allclose(t.detach().numpy(), np.asarray(jp[mod][leaf]),
                                               rtol=1e-6, atol=1e-6,
                                               err_msg=f"step {i} {mod}/{leaf}")
    if opt_cfg["type"] == "Adam":
        for st in opt.state.values():
            assert isinstance(st["step"], torch.Tensor) and float(st["step"]) == 6
        if "mu_dtype" in opt_cfg:
            assert isinstance(opt, AdamLowPrecisionMu)
            assert all(st["mu"].dtype == torch.bfloat16 for st in opt.state.values())


def test_adam_loads_the_earlier_optimizer_state():
    """A `torch.optim.Adam` state dict, what the port's checkpoints held
    before its optimizer kept its counts on the device: the moments and the
    count land in `Adam`'s state, the live lr tensors stay."""
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 2)
    old = torch.optim.Adam(model.parameters(), 1e-2)
    for _ in range(3):
        old.zero_grad()
        (model(torch.rand(4, 3)) ** 2).sum().backward()
        old.step()
    saved = copy.deepcopy(old.state_dict())
    new = Adam(model.parameters(), 1e-3)
    lr = new.param_groups[0]["lr"]
    new.load_state_dict(saved)
    assert new.param_groups[0]["lr"] is lr and float(lr) == pytest.approx(1e-2)
    for p in model.parameters():
        st, ref = new.state[p], old.state[p]
        assert sorted(st) == ["mu", "nu", "step"] and float(st["step"]) == 3
        assert torch.equal(st["mu"], ref["exp_avg"]) and torch.equal(st["nu"], ref["exp_avg_sq"])
    new.zero_grad()
    (model(torch.rand(4, 3)) ** 2).sum().backward()
    new.step()
    assert all(float(st["step"]) == 4 for st in new.state.values())


def test_remat_keeps_no_rng_state_and_changes_no_bit(monkeypatch):
    """The remat step with `preserve_rng_state=False` against the same step
    with the RNG state kept (the checkpoint call before this change):
    losses, gradients and weights bit for bit, dropout drawn."""
    batch = synthetic_batch(1, H, W, OCC, seed=3)
    runs = []
    for keep in (False, True):
        if keep:
            plain = port_jperceiver.checkpoint
            monkeypatch.setattr(port_jperceiver, "checkpoint", lambda *a, **k: plain(
                *a, **dict(k, preserve_rng_state=True)))
        step = make_train_step(_model(remat=True), FLAGSHIP, device="cpu", seed=5,
                               steps_per_epoch=1000)
        m = step(batch)
        runs.append([m[k] for k in sorted(m)] + [p.grad for p in step.params]
                    + [p.detach() for p in step.params])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_restore_mid_run_continues_bit_for_bit(tmp_path):
    """Three steps, against one step, a checkpoint, a step that the restore
    then undoes, and two steps: the same weights, optimizer state, BatchNorm
    statistics, generator and iteration. The restore drops the step's
    graphs."""
    batches = [synthetic_batch(1, H, W, OCC, seed=s) for s in (4, 5, 6)]

    def state(step):
        return ([t.detach() for t in step.model.state_dict().values()]
                + [v for st in step.optimizer.state.values() for v in st.values()]
                + [step.generator.get_state()])

    ref = make_train_step(_model(), FLAGSHIP, device="cpu", seed=2, steps_per_epoch=1000)
    for b in batches:
        ref(b)
    step = make_train_step(_model(), FLAGSHIP, device="cpu", seed=2, steps_per_epoch=1000)
    step(batches[0])
    save_checkpoint(str(tmp_path), step, 1)
    step(batches[1])
    step.graphs.entries["a shape"] = None
    assert restore_checkpoint(str(tmp_path), step) == 1
    assert step.graphs.entries == {} and step.iteration == 1
    for b in batches[1:]:
        step(b)
    assert step.iteration == ref.iteration == 3
    assert all(torch.equal(a, b) for a, b in zip(state(step), state(ref), strict=True))


def test_graph_true_raises_on_the_cpu_and_under_a_process_group(monkeypatch):
    model = _model()
    with pytest.raises(ValueError, match="graph=True"):
        make_train_step(model, FLAGSHIP, device="cpu", steps_per_epoch=10, graph=True)
    with pytest.raises(ValueError, match="graph=True"):
        make_eval_step(model, device="cpu", graph=True)
    with pytest.raises(ValueError, match="graph=True"):
        make_streaming_fn(model, device="cpu", graph=True)
    cuda = torch.device("cuda")
    use = graphs.use_graphs
    assert use(None, cuda, "x", collectives=True) and not use(False, cuda, "x", collectives=True)
    assert not use(None, torch.device("cpu"), "x", collectives=True)
    # A process group whose collectives cannot be captured (gloo's):
    # `tests/test_torch_graph_ddp.py` holds each backend's decisions.
    monkeypatch.setattr(graphs.dist, "is_distributed", lambda: True)
    monkeypatch.setattr(graphs.dist, "can_capture", lambda: False)
    monkeypatch.setattr(graphs.dist, "backend", lambda: "gloo")
    assert not use(None, cuda, "x", collectives=True)
    with pytest.raises(ValueError, match="process group"):
        use(True, cuda, "x", collectives=True)


class _StandInGraph:
    """What `GraphCache` calls of a `torch.cuda.CUDAGraph`, without a card:
    replays are counted, generators recorded."""

    def __init__(self):
        self.replays, self.generators = 0, []

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def replay(self):
        self.replays += 1


def test_launch_counts_across_capture_and_replays(monkeypatch):
    """A body that launches two K3 and one K5 kernel (it bumps the wrappers'
    counters as they do): the warm-up counts its launches, a capture none,
    each replay the captured ones; a capture that fails leaves the counts
    as they were and raises with the entry point's name."""
    made = []
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: made.append(_StandInGraph()) or made[-1])
    monkeypatch.setattr(torch.cuda, "graph", lambda g, **kw: contextlib.nullcontext())
    calls = []

    def body(x, carry):
        calls.append(x.clone())
        conv3x3.LAUNCHES["conv3x3"] += 2
        maxpool.LAUNCHES["maxpool5x5"] += 1
        carry.add_(1)
        return {"y": x * 2}

    gen = torch.Generator()
    cache = graphs.GraphCache(body, "the test body", (gen,))
    carry = torch.zeros(())
    kernels.reset_launch_counts()
    x0 = torch.ones(3)
    out0 = cache.run("k", {"x": x0}, {"carry": carry})  # warm-up: eager
    assert kernels.launch_counts()["conv3x3"] == 2 and made == [] and len(calls) == 1
    out1 = cache.run("k", {"x": torch.full((3,), 5.0)}, {"carry": carry})  # capture + replay
    (g,) = made
    assert g.replays == 1 and g.generators == [gen] and cache.captures == 1
    assert kernels.launch_counts()["conv3x3"] == 4 and kernels.launch_counts()["maxpool5x5"] == 2
    assert torch.equal(calls[-1], torch.full((3,), 5.0))  # captured on the static copy
    static = cache.entries["k"].inputs["x"]
    out2 = cache.run("k", {"x": torch.full((3,), 7.0)}, {"carry": carry})  # replay only
    assert out2 is out1 and out0 is not out1 and len(calls) == 2 and g.replays == 2
    assert torch.equal(static, torch.full((3,), 7.0))  # the input copied in
    assert kernels.launch_counts()["conv3x3"] == 6 and kernels.launch_counts()["maxpool5x5"] == 3
    assert cache.entries["k"].launches.per_replay == {"conv3x3": 2, "maxpool5x5": 1}

    def failing(x):
        conv3x3.LAUNCHES["conv3x3"] += 1
        raise RuntimeError("operation not permitted when stream is capturing")

    bad = graphs.GraphCache(failing, "the failing body")
    bad.entries["k"], bad.eager_calls = None, 1  # warmed up
    before = kernels.launch_counts()
    with pytest.raises(RuntimeError, match="capture of the failing body failed"):
        bad.run("k", {"x": x0})
    assert kernels.launch_counts() == before
    kernels.reset_launch_counts()


def test_tensor_key_names_shapes_and_dtypes():
    a = {"x": torch.zeros(2, 3), "noise": None}
    assert graphs.tensor_key(a) == (("noise", None), ("x", ((2, 3), torch.float32)))
    one, two = ({"x": torch.zeros(b, 3)} for b in (1, 2))
    assert graphs.tensor_key(one) != graphs.tensor_key(two)
