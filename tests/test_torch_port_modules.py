"""Each module of the port's inference slice against its JAX counterpart,
fp32, eval mode, with random params AND random BatchNorm running stats.

Weights reach the port through its bridge (`convert.state_dict_from_jax`).
Tolerance: max |port - jax| <= 1e-4 * max(1, max |jax|), fp32 sums taken in
another order through a few layers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jperceiver_tpu.models.depth_net import DepthDecoder as JDepthDecoder
from jperceiver_tpu.models.layout_net import (
    CrossViewTransformer as JCCT, CycledViewProjection as JCVP,
    LayoutDecoder as JLayoutDecoder, LayoutEncoder as JLayoutEncoder)
from jperceiver_tpu.models.pose_net import PoseDecoder as JPoseDecoder
from jperceiver_tpu.models.resnet import ResNet as JResNet
from jperceiver_tpu_torch.models.depth_net import DepthDecoder
from jperceiver_tpu_torch.models.layout_net import (
    CrossViewTransformer, CycledViewProjection, LayoutDecoder, LayoutEncoder)
from jperceiver_tpu_torch.models.pose_net import PoseDecoder
from jperceiver_tpu_torch.models.resnet import ResNet

from torch_port_helpers import assert_close, load_port, nchw, nhwc, random_variables

TOL = 1e-4


def _u(shape, seed):
    """Non-negative activations, like the post-ReLU features modules get."""
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("in_ch,root,prefix", [
    (3, ("depth_encoder", "encoder"), "DepthEncoder.encoder."),
    (6, ("pose_encoder", "encoder"), "PoseEncoder.encoder."),
])
def test_resnet18(in_ch, root, prefix):
    x = np.random.default_rng(in_ch).standard_normal((2, 64, 96, in_ch)).astype(np.float32)
    jm = JResNet(18, in_channels=in_ch)
    v = random_variables(jm, jnp.asarray(x), seed=in_ch)
    want = jm.apply(v, jnp.asarray(x), False)
    port = load_port(ResNet(18, in_ch), v, root, prefix)
    with torch.no_grad():
        got = port(nchw(x))
    assert len(got) == len(want) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(nhwc(g), w, TOL, f"level {i}")


def test_depth_decoder():
    shapes = [(1, 64, 64, 64), (1, 32, 32, 64), (1, 16, 16, 128),
              (1, 8, 8, 256), (1, 4, 4, 512)]
    feats = [_u(s, i) for i, s in enumerate(shapes)]
    jm = JDepthDecoder()
    jf = [jnp.asarray(f) for f in feats]
    v = random_variables(jm, jf, False, seed=10)
    want = jm.apply(v, jf, False)
    port = load_port(DepthDecoder(18), v, ("depth_decoder",), "DepthDecoder.")
    with torch.no_grad():
        got = port([nchw(f) for f in feats])
    assert sorted(got) == sorted(want) == ["disp/0", "disp/1", "disp/2", "disp/3"]
    for k in want:
        assert_close(nhwc(got[k]), want[k], TOL, k)


def test_pose_decoder():
    f = _u((2, 6, 20, 512), 11)  # the 192x640 pose input at 1/32
    jm = JPoseDecoder()
    v = random_variables(jm, [jnp.asarray(f)], seed=11)
    want = jm.apply(v, [jnp.asarray(f)])
    port = load_port(PoseDecoder(18), v, ("pose_decoder",), "PoseDecoder.")
    with torch.no_grad():
        got = port([nchw(f)])
    for g, w, name in zip(got, want, ("axisangle", "translation")):
        assert_close(g.numpy(), w, TOL, name)


def test_layout_encoder():
    img = _u((1, 256, 256, 3), 12)
    jm = JLayoutEncoder(18)
    v = random_variables(jm, jnp.asarray(img), False, seed=12)
    want = jm.apply(v, jnp.asarray(img), False)
    port = load_port(LayoutEncoder(18), v, ("layout_encoder",), "LayoutEncoder.")
    with torch.no_grad():
        got = port(nchw(img))
    assert_close(nhwc(got), want, TOL, "layout features")


def test_cycled_view_projection():
    x = _u((2, 8, 8, 128), 13)
    jm = JCVP(8)
    v = random_variables(jm, jnp.asarray(x), seed=13)
    want = jm.apply(v, jnp.asarray(x))
    port = load_port(CycledViewProjection(8), v, ("cvp",), "CycledViewProjection.")
    with torch.no_grad():
        got = port(nchw(x))
    for g, w, name in zip(got, want, ("transform", "retransform")):
        assert_close(nhwc(g), w, TOL, name)


def test_cross_view_transformer_8x8():
    """CCT at its real 8x8 grid (occ 256), where the hard-attention argmax
    chooses among 64 positions."""
    front, cross, hat = (_u((2, 8, 8, 128), 14 + i) for i in range(3))
    depth = _u((2, 32, 32, 512), 17)
    args = [jnp.asarray(a) for a in (front, cross, hat, depth)]
    jm = JCCT(128)
    v = random_variables(jm, *args, seed=14)
    want = jm.apply(v, *args)
    port = load_port(CrossViewTransformer(128, 512), v, ("cct",),
                     "CrossViewTransformer.")
    with torch.no_grad():
        got = port(*(nchw(a) for a in (front, cross, hat, depth)))
    for g, w, name in zip(got, want, ("fused", "cv_attn", "cm_attn")):
        assert_close(nhwc(g), w, TOL, name)


def test_layout_decoder():
    x = _u((1, 2, 2, 128), 18)
    jm = JLayoutDecoder(2)
    v = random_variables(jm, jnp.asarray(x), False, seed=18)
    want = jm.apply(v, jnp.asarray(x), False)
    port = load_port(LayoutDecoder(2, 128), v, ("layout_decoder",), "LayoutDecoder.")
    with torch.no_grad():
        got = port(nchw(x))
    assert got.shape == (1, 2, 64, 64)
    assert_close(nhwc(got), want, TOL, "topview logits")
