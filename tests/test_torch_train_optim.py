"""The optimizer knobs the port once dropped, against optax through the JAX
package's `build_optimizer`: `optimizer.mu_dtype` (Adam's first moment
stored in bf16, `AdamLowPrecisionMu`) and
`optimizer.paramwise_options.bias_lr_mult` (the updates of non-norm biases
scaled), each over five steps of clip(35) + Adam / AdamW on the same
gradients, some above the clip norm. The labels of the flagship's
parameter tree are held to the JAX package's in `test_torch_config.py`.

Tolerance: parameters to 1e-6 (rtol and atol): the same fp32 arithmetic;
the bf16 first moment is rounded from the same fp32 value on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jperceiver_tpu.engine import optim as jax_optim
from jperceiver_tpu_torch.engine.optim import (AdamLowPrecisionMu, build_optimizer,
                                               clip_by_global_norm_, global_norm,
                                               param_labels, set_lr)
from jperceiver_tpu_torch.models.common import BatchNorm2d


class _Tiny(torch.nn.Module):
    """conv (weight, bias) and a BatchNorm (weight, bias): the three labels."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 4, 3)
        self.bn1 = BatchNorm2d(4)


def _flax_tree(p):
    """The port's parameters as the flax tree with the same labels."""
    return {"conv": {"kernel": p["conv.weight"], "bias": p["conv.bias"]},
            "bn1": {"scale": p["bn1.weight"], "bias": p["bn1.bias"]}}


def _run(opt_cfg, steps=5):
    cfg = {"optimizer": opt_cfg, "optimizer_config": {"grad_clip": {"max_norm": 35.0}},
           "lr_config": {"policy": "step", "step": [1]}}
    model = _Tiny()
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)))
    names = [n for n, _ in model.named_parameters()]
    labels = param_labels(model)
    assert labels == {"conv.weight": "default", "conv.bias": "bias",
                      "bn1.weight": "norm", "bn1.bias": "norm"}
    params = list(model.parameters())
    opt, sched, clip = build_optimizer(cfg, params, steps_per_epoch=3,
                                       labels=[labels[n] for n in names])
    jp = _flax_tree({n: jnp.asarray(p.detach().numpy()) for n, p in model.named_parameters()})
    tx, _ = jax_optim.build_optimizer(cfg, steps_per_epoch=3, params=jp)
    state = tx.init(jp)
    for i in range(steps):
        grads = {n: (rng.standard_normal(p.shape) * (40.0 if i % 2 else 1.0)).astype(np.float32)
                 for n, p in model.named_parameters()}
        upd, state = tx.update(_flax_tree({n: jnp.asarray(g) for n, g in grads.items()}),
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n].copy())
        gl = [p.grad for p in params]
        clip_by_global_norm_(gl, global_norm(gl), clip)
        set_lr(opt, sched, i)
        opt.step()
        want = _flax_tree({n: None for n in names})
        got = _flax_tree(dict(model.named_parameters()))
        for mod in want:
            for leaf in want[mod]:
                np.testing.assert_allclose(got[mod][leaf].detach().numpy(),
                                           np.asarray(jp[mod][leaf]), rtol=1e-6, atol=1e-6,
                                           err_msg=f"step {i} {mod}/{leaf}")
    return opt, state


@pytest.mark.parametrize("wd", [0.0, 1e-2])
def test_mu_dtype_matches_optax(wd):
    opt, state = _run({"type": "Adam", "lr": 1e-2, "weight_decay": wd,
                       "mu_dtype": "bfloat16"})
    assert isinstance(opt, AdamLowPrecisionMu)
    for st in opt.state.values():
        assert st["mu"].dtype == torch.bfloat16 and st["nu"].dtype == torch.float32
    # optax keeps the moment in bf16 too (state: clip, then Adam's).
    assert all(m.dtype == jnp.bfloat16 for m in jax.tree_util.tree_leaves(state[1][0].mu))


@pytest.mark.parametrize("opt_cfg", [
    {"type": "Adam", "lr": 1e-2, "weight_decay": 0.0},
    {"type": "Adam", "lr": 1e-2, "weight_decay": 1e-2},
    {"type": "Adam", "lr": 1e-2, "weight_decay": 0.0, "mu_dtype": "bfloat16"},
    {"type": "SGD", "lr": 1e-2, "momentum": 0.9},
], ids=["adam", "adamw", "adam_mu_bf16", "sgd"])
def test_bias_lr_mult_matches_optax(opt_cfg):
    opt, _ = _run(dict(opt_cfg, paramwise_options={"bias_lr_mult": 2.0}))
    assert sorted(g["lr_mult"] for g in opt.param_groups) == [1.0, 2.0]


def test_paramwise_options_need_labels():
    cfg = {"optimizer": {"type": "Adam", "lr": 1e-4,
                         "paramwise_options": {"bias_lr_mult": 2.0}}}
    with pytest.raises(ValueError, match="one label per parameter"):
        build_optimizer(cfg, list(_Tiny().parameters()), steps_per_epoch=3)

