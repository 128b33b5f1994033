"""Backward passes of the port's conv and pool wrappers on the CPU (their
plain versions) against the JAX package's `custom_vjp`s, and the port's
train-mode BatchNorm and dropout.

- `conv3x3_fwd`'s backward (K3 as the data-grad at pad 2 - pad, K4 as the
  weight-grad, a sum for the bias) against the VJPs of `pallas_conv3x3` and
  `pallas_conv3x3_valid`, whose Pallas kernels run in interpret mode, at
  shapes where `_wgrad_pallas` takes its strip-accumulating path (row
  tile >= 4). Tolerance 1e-4 (fp32) / 2e-2 (bf16) of max(1, max |jax|).
- The 5x5 and stem 3x3/s2 pools: equality-mask backwards bit for bit on
  bf16 inputs full of ties (quarter steps through a ReLU; the cotangents
  are quarter steps too, so every sum is exact in bf16).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jperceiver_tpu.models.common import BatchNorm as JBatchNorm
from jperceiver_tpu.ops.pallas import conv3x3 as jax_conv3x3
from jperceiver_tpu.ops.pallas.maxpool import max_pool_3x3_s2, max_pool_5x5_s1
from jperceiver_tpu_torch.models.common import BatchNorm2d, dropout
from jperceiver_tpu_torch.ops.cuda import (conv3x3_fwd, conv3x3_wgrad,
                                           conv3x3_wgrad_plain, maxpool3x3s2,
                                           maxpool5x5)

from torch_port_helpers import assert_close, nchw, nhwc

_DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pad,c,o", [(1, 8, 16), (0, 40, 24), (1, 64, 8)])
def test_conv3x3_backward_matches_pallas_vjp(dtype, pad, c, o):
    jdt, tdt = _DT[dtype]
    rng = np.random.default_rng(c + o + pad)
    ho, wo = 8, 12
    x = rng.standard_normal((2, ho + 2 - 2 * pad, wo + 2 - 2 * pad, c)).astype(np.float32)
    w = (rng.standard_normal((3, 3, c, o)) / np.sqrt(9 * c)).astype(np.float32)
    b = rng.standard_normal((o,)).astype(np.float32)
    cot = rng.standard_normal((2, ho, wo, o)).astype(np.float32)
    # The JAX weight-grad takes its Pallas strip path at this shape.
    assert jax_conv3x3._row_tile(ho, wo, c, o, jnp.dtype(jdt).itemsize) >= 4
    fn = jax_conv3x3.pallas_conv3x3 if pad else jax_conv3x3.pallas_conv3x3_valid
    _, vjp = jax.vjp(fn, jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(b, jdt))
    jdx, jdw, jdb = vjp(jnp.asarray(cot, jdt))

    xt = nchw(x).to(tdt).requires_grad_()
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).to(tdt).requires_grad_()
    bt = torch.from_numpy(b).to(tdt).requires_grad_()
    y = conv3x3_fwd(xt, wt, bt, pad)
    y.backward(nchw(cot).to(tdt))
    assert xt.grad.dtype == wt.grad.dtype == bt.grad.dtype == tdt
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert_close(nhwc(xt.grad), np.asarray(jdx, np.float32), tol, "dx")
    assert_close(wt.grad.float().numpy().transpose(2, 3, 1, 0),
                 np.asarray(jdw, np.float32), tol, "dw")
    assert_close(bt.grad.float().numpy(), np.asarray(jdb, np.float32), tol, "db")


@pytest.mark.parametrize("mode", ["same", "valid"])
def test_conv3x3_backward_matches_forced_pallas_module(mode):
    """The JAX `Conv3x3` module routed to the Pallas kernel by its deep-gate
    scope with `force` (as the JAX package's own tests take it on the CPU):
    its VJP against the port's `conv3x3_fwd` backward."""
    from jperceiver_tpu.models.common import Conv3x3 as JConv3x3, pallas_conv_deep_scope

    rng = np.random.default_rng(9)
    pad = 1 if mode == "same" else 0
    x = rng.standard_normal((1, 8 + 2 - 2 * pad, 12 + 2 - 2 * pad, 16)).astype(np.float32)
    cot = rng.standard_normal((1, 8, 12, 24)).astype(np.float32)
    jm = JConv3x3(24, mode=mode)
    v = jm.init(jax.random.key(0), jnp.asarray(x))
    with pallas_conv_deep_scope(True, force=True):
        _, vjp = jax.vjp(lambda p, xx: jm.apply(p, xx), v, jnp.asarray(x))
        jdv, jdx = vjp(jnp.asarray(cot))
    k = np.asarray(v["params"]["kernel"])
    xt = nchw(x).requires_grad_()
    wt = torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).requires_grad_()
    bt = torch.from_numpy(np.asarray(v["params"]["bias"])).requires_grad_()
    conv3x3_fwd(xt, wt, bt, pad).backward(nchw(cot))
    assert_close(nhwc(xt.grad), np.asarray(jdx), 1e-4, "dx")
    assert_close(wt.grad.numpy().transpose(2, 3, 1, 0), np.asarray(jdv["params"]["kernel"]),
                 1e-4, "dw")
    assert_close(bt.grad.numpy(), np.asarray(jdv["params"]["bias"]), 1e-4, "db")


@pytest.mark.parametrize("pad", [0, 1, 2])
def test_conv3x3_wgrad_plain_is_the_weight_gradient(pad):
    """K4's plain version equals autograd's weight gradient of F.conv2d,
    at every pad the wrapper takes (2 is the dgrad's)."""
    rng = np.random.default_rng(pad)
    x = torch.from_numpy(rng.standard_normal((2, 5, 9, 7)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((6, 5, 3, 3)).astype(np.float32))
    w.requires_grad_()
    y = torch.nn.functional.conv2d(x, w, padding=pad)
    g = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
    y.backward(g)
    got = conv3x3_wgrad(x, g, pad)
    assert got.shape == w.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, w.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(conv3x3_wgrad_plain(x, g, pad), got)


def test_conv3x3_dgrad_at_pad_2_with_513_outputs():
    """The data-grad of a VALID 513-channel conv (the decoder iconv) is a
    pad-2 conv with 513 output channels; its input gradient matches
    autograd of F.conv2d."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((1, 513, 6, 7)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((32, 513, 3, 3)) / 68).astype(np.float32))
    xr = x.clone().requires_grad_()
    y = torch.nn.functional.conv2d(xr, w)
    g = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
    y.backward(g)
    xk = x.clone().requires_grad_()
    conv3x3_fwd(xk, w, None, 0).backward(g)
    assert xk.grad.shape == (1, 513, 6, 7)
    torch.testing.assert_close(xk.grad, xr.grad, rtol=1e-4, atol=1e-5)


def _ties(rng, shape):
    return np.maximum(np.round(4 * rng.standard_normal(shape)) / 4, 0).astype(np.float32)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_maxpool5x5_backward_routes_every_tie(use_kernel):
    rng = np.random.default_rng(3)
    x = _ties(rng, (2, 12, 20, 16))
    cot = np.round(4 * rng.standard_normal(x.shape)).astype(np.float32) / 4
    xj = jnp.asarray(x, jnp.bfloat16)
    _, vjp = jax.vjp(max_pool_5x5_s1, xj)
    (want,) = vjp(jnp.asarray(cot, jnp.bfloat16))
    xt = nchw(x).to(torch.bfloat16).requires_grad_()
    maxpool5x5(xt, use_kernel).backward(nchw(cot).to(torch.bfloat16))
    assert xt.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(nhwc(xt.grad), np.asarray(want, np.float32))
    # A tie gives every tied input the whole cotangent: more than F.max_pool2d.
    xr = nchw(x).to(torch.bfloat16).requires_grad_()
    torch.nn.functional.max_pool2d(xr, 5, 1, 2).backward(nchw(cot).to(torch.bfloat16))
    assert not torch.equal(xr.grad, xt.grad)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("h,w", [(16, 20), (17, 23)])
def test_stem_pool_backward_routes_every_tie(h, w, use_kernel):
    rng = np.random.default_rng(h)
    x = _ties(rng, (2, h, w, 8))
    xj = jnp.asarray(x, jnp.bfloat16)
    y, vjp = jax.vjp(max_pool_3x3_s2, xj)
    cot = np.round(4 * rng.standard_normal(y.shape)).astype(np.float32) / 4
    (want,) = vjp(jnp.asarray(cot, jnp.bfloat16))
    xt = nchw(x).to(torch.bfloat16).requires_grad_()
    yt = maxpool3x3s2(xt, use_kernel)
    np.testing.assert_array_equal(nhwc(yt), np.asarray(y, np.float32))
    yt.backward(nchw(cot).to(torch.bfloat16))
    np.testing.assert_array_equal(nhwc(xt.grad), np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_mode_matches_flax(dtype):
    """Train-mode BatchNorm: output, gradients and the running statistics
    (biased variance, momentum 0.9 in flax terms) against the JAX
    package's BatchNorm."""
    jdt, tdt = _DT[dtype]
    rng = np.random.default_rng(1)
    x = (2.0 + 3.0 * rng.standard_normal((3, 6, 7, 5))).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    bias = rng.standard_normal(5).astype(np.float32)
    mean0 = rng.standard_normal(5).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    jm = JBatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=jdt)
    v = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
         "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}

    def f(xx, params):
        return jm.apply({"params": params, "batch_stats": v["batch_stats"]}, xx,
                        mutable=["batch_stats"])

    y, stats = f(jnp.asarray(x, jdt), v["params"])
    _, vjp = jax.vjp(lambda xx, p: f(xx, p)[0], jnp.asarray(x, jdt), v["params"])
    jdx, jdp = vjp(jnp.asarray(cot, jdt))

    bn = BatchNorm2d(5)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    bn.train()
    xt = nchw(x).to(tdt).requires_grad_()
    yt = bn(xt)
    yt.backward(nchw(cot).to(tdt))
    assert yt.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert_close(nhwc(yt), np.asarray(y, np.float32), tol, "y")
    assert_close(nhwc(xt.grad), np.asarray(jdx, np.float32), 10 * tol, "dx")
    assert_close(bn.weight.grad.numpy(), np.asarray(jdp["scale"]), 10 * tol, "dscale")
    assert_close(bn.bias.grad.numpy(), np.asarray(jdp["bias"]), 10 * tol, "dbias")
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-6)
    assert int(bn.num_batches_tracked) == 1
    # Eval mode normalizes with the running statistics, as flax does.
    bn.eval()
    want = JBatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5, dtype=jdt).apply(
        {"params": v["params"], "batch_stats": stats["batch_stats"]}, jnp.asarray(x, jdt))
    with torch.no_grad():
        assert_close(nhwc(bn(nchw(x).to(tdt))), np.asarray(want, np.float32), tol, "eval y")


def test_dropout_keeps_half_scaled_by_two():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(4, 8, 64, 64)
    y = dropout(x, 0.5, g)
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}
    assert abs(float((y > 0).float().mean()) - 0.5) < 0.01
    # The same seed draws the same mask.
    assert torch.equal(y, dropout(x, 0.5, torch.Generator().manual_seed(0)))
    # flax draws a Bernoulli keep mask and scales the same way.
    jy = fnn.Dropout(0.5, deterministic=False).apply({}, jnp.ones((64, 64)),
                                                      rngs={"dropout": jax.random.key(0)})
    assert set(np.unique(np.asarray(jy)).tolist()) == {0.0, 2.0}
