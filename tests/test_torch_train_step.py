"""The port's training step as a whole against the JAX package's
`make_train_step`, at 128^2, occ 32, road branch (`type="static"`, the
flagship's loss configuration), with random weights and BatchNorm
statistics from a seed.

Both steps run in float64: the port's model and batch in float64 on its
main path (`reproj_min`, whose plain version takes float64 on the CPU), the
JAX step under x64 with compute dtype float64, fp32 warp taps (the image's
dtype) and its unfused photometric path. The JAX package writes its pose
parameters and sampling coordinates in fp32 (`jnp.float32` casts); this test
widens those casts to float64 in the two modules that make them, as the port
widens its own, so that both sides compute one function in one precision.
Dropout is off on both sides (flax's `Dropout` patched to the identity, the
port's rate set to 0), and the port takes JAX's own automask noise draw. The
JAX optimizer is replaced by one that keeps the gradients, so they can be
read; the port's gradients are read after its clip.

The JAX step is compiled with `xla_cpu_prefer_vector_width=128`. With the
CPU backend's default vector width, the jitted step's gradients of the pose
encoder's stem (conv1 and bn1, the input side of its equality-mask max-pool
`max_pool_3x3_s2`) come out up to 99% of their scale away from the same JAX
function run op by op, and from float64 central differences of the loss;
with 128-bit vectors they agree with both (the port's to 1e-4 of the
central differences, the op-by-op JAX gradients to 1e-14). Every other
parameter is the same either way.

Tolerances: every loss key to 1e-4 * max(1, |ref|); each parameter's
gradient to 1e-3 of its own max |ref|; a parameter whose reference gradient
is below 1e-12 of the step's largest gradient G is zero in exact arithmetic
(a conv bias that a train-mode BatchNorm cancels), and the port's must be
below 1e-12 G too; the new BatchNorm running statistics to 1e-5.
"""

import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import jperceiver_tpu.models.jperceiver as jax_jperceiver_module
import jperceiver_tpu.ops.sampling as jax_sampling_module
from jperceiver_tpu.config import Config
from jperceiver_tpu.data import synthetic_batch as jax_synthetic_batch
from jperceiver_tpu.engine.train_state import TrainState
from jperceiver_tpu.engine.trainer import make_train_step as jax_make_train_step
from jperceiver_tpu.models import JPerceiver as JaxJPerceiver
from jperceiver_tpu_torch.convert import state_dict_from_jax
from jperceiver_tpu_torch.data import synthetic_batch
from jperceiver_tpu_torch.engine import make_train_step
from jperceiver_tpu_torch.models import JPerceiver

from torch_port_helpers import random_variables

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


def test_train_step_matches_jax(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    batch = jax_synthetic_batch(1, H, W, OCC, seed=3)
    v = random_variables(JaxJPerceiver(height=H, width=W, occ_map_size=OCC, branches="road"),
                         {k: jnp.asarray(a) for k, a in batch.items()}, train=True, seed=4)
    for module in (jax_jperceiver_module, jax_sampling_module):
        monkeypatch.setattr(module, "jnp", _Float64Casts("jnp_float64_casts"))
    cfg = Config.fromdict(dict(FLAGSHIP, warp_tap_dtype="float32", use_pallas_reproj=False))
    rng = jax.random.key(5)
    with jax.enable_x64(True):
        jm = JaxJPerceiver(height=H, width=W, occ_map_size=OCC, branches="road",
                           dtype=jnp.float64)
        params, stats, batch64 = _f64(v["params"]), _f64(v["batch_stats"]), _f64(batch)
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                           opt_state=_keep_grads().init(params), tx=_keep_grads())
        jax_step = jax_make_train_step(jm, cfg, donate=False).lower(state, batch64, rng).compile(
            compiler_options={"xla_cpu_prefer_vector_width": 128})
        new_state, want = jax_step(state, batch64, rng)
        # The step's automask draw: compute_losses splits the step's loss key.
        _, loss_rng = jax.random.split(jax.random.fold_in(rng, 0))
        noise = jax.random.normal(jax.random.split(loss_rng)[1], (4, 2, 1, H, W),
                                  jnp.float64) * 1e-5
        want = {k: float(a) for k, a in want.items()}
        as_np = (lambda t: jax.tree_util.tree_map(np.asarray, t))
        ref = state_dict_from_jax(as_np(new_state.opt_state), as_np(new_state.batch_stats))
        noise = np.asarray(noise)

    model = JPerceiver(occ_map_size=OCC, branches="road", dtype=torch.float64).double()
    model.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"]), strict=True)
    model.DepthDecoder.dropout_rate = 0.0
    step = make_train_step(model, dict(FLAGSHIP, use_pallas_reproj=True,
                                       pallas_reproj_bf16=False), device="cpu",
                           steps_per_epoch=1000)
    got = step({k: a.astype(np.float64) if np.issubdtype(a.dtype, np.floating) else a
                for k, a in synthetic_batch(1, H, W, OCC, seed=3).items()},
               noise=torch.from_numpy(noise))

    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert abs(float(got[k]) - w) <= 1e-4 * max(1.0, abs(w)), (k, float(got[k]), w)
    clip = min(1.0, 35.0 / want["grad_norm"])
    refs = {name: ref[name] * clip for name, _ in model.named_parameters()}
    big = max(float(r.abs().max()) for r in refs.values())
    for name, p in model.named_parameters():
        err = float((p.grad - refs[name]).abs().max())
        scale = float(refs[name].abs().max())
        if scale <= 1e-12 * big:
            assert float(p.grad.abs().max()) <= 1e-12 * big, (name, err, scale)
        else:
            assert err <= 1e-3 * scale, (name, err, scale)
    for name, buf in model.named_buffers():
        if "running" in name:
            torch.testing.assert_close(buf, ref[name], rtol=1e-5, atol=1e-5, msg=name)


def test_synthetic_batch_matches_jax():
    mine = synthetic_batch(2, 32, 48, 16, seed=5)
    ref = jax_synthetic_batch(2, 32, 48, 16, seed=5)
    assert sorted(mine) == sorted(ref)
    for k, v in ref.items():
        if k in ("color", "color_aug"):
            v = v.transpose(0, 1, 4, 2, 3)
        elif k.endswith("_sdf"):
            v = v.transpose(0, 3, 1, 2)
        np.testing.assert_allclose(mine[k], v, rtol=1e-6, atol=1e-5, err_msg=k)


def test_train_step_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(JPerceiver(occ_map_size=OCC, branches="road"), FLAGSHIP,
                        steps_per_epoch=1000)
