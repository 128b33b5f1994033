"""The port's ops against the JAX package's: reflect pad, resizes, geometry."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jperceiver_tpu.ops import geometry as jgeo
from jperceiver_tpu.ops.padding import reflect_pad as jax_reflect_pad
from jperceiver_tpu.ops.sampling import resize_bilinear as jax_resize_bilinear
from jperceiver_tpu.ops.sampling import upsample2x_nearest as jax_upsample2x
from jperceiver_tpu_torch.ops import geometry as tgeo
from jperceiver_tpu_torch.ops.padding import reflect_pad
from jperceiver_tpu_torch.ops.sampling import resize_bilinear, upsample2x_nearest

from torch_port_helpers import nchw, nhwc


def _img(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("p", [1, 2])
def test_reflect_pad(p):
    x = _img((2, 7, 9, 3))
    np.testing.assert_array_equal(nhwc(reflect_pad(nchw(x), p)),
                                  np.asarray(jax_reflect_pad(jnp.asarray(x), p)))


@pytest.mark.parametrize("src,dst", [((1024, 1024), (192, 640)),  # pose resize
                                     ((128, 128), (192, 640)),    # upsample
                                     ((64, 96), (32, 40))])
def test_resize_bilinear(src, dst):
    """Antialiased like jax.image.resize when downsampling: 1024^2 ->
    192x640 differs by up to 0.47 without it."""
    x = _img((1,) + src + (3,), seed=1)
    got = nhwc(resize_bilinear(nchw(x), *dst))
    want = np.asarray(jax_resize_bilinear(jnp.asarray(x), *dst))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_upsample2x_nearest():
    x = _img((2, 5, 6, 4), seed=2)
    np.testing.assert_array_equal(nhwc(upsample2x_nearest(nchw(x))),
                                  np.asarray(jax_upsample2x(jnp.asarray(x))))


def _poses(seed=3, n=6):
    rng = np.random.default_rng(seed)
    aa = (0.3 * rng.standard_normal((n, 3))).astype(np.float32)
    aa[0] = 0.0  # zero rotation: the 1e-7 guard
    tr = rng.standard_normal((n, 3)).astype(np.float32)
    return aa, tr


def test_rot_from_axisangle():
    aa, _ = _poses()
    np.testing.assert_allclose(
        tgeo.rot_from_axisangle(torch.from_numpy(aa)).numpy(),
        np.asarray(jgeo.rot_from_axisangle(jnp.asarray(aa))), atol=1e-6)


@pytest.mark.parametrize("invert", [False, True])
def test_transformation_from_parameters(invert):
    aa, tr = _poses()
    got = tgeo.transformation_from_parameters(
        torch.from_numpy(aa), torch.from_numpy(tr), invert=invert)
    want = jgeo.transformation_from_parameters(
        jnp.asarray(aa), jnp.asarray(tr), invert=invert)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_se3_inverse_and_compose():
    aa, tr = _poses(seed=4)
    t = jgeo.transformation_from_parameters(jnp.asarray(aa), jnp.asarray(tr))
    tt = torch.from_numpy(np.array(t))
    inv = tgeo.se3_inverse(tt)
    np.testing.assert_allclose(inv.numpy(), np.asarray(jgeo.se3_inverse(t)), atol=1e-6)
    np.testing.assert_allclose(tgeo.se3_compose(tt, inv).numpy(),
                               np.broadcast_to(np.eye(4), (6, 4, 4)), atol=1e-5)
    np.testing.assert_allclose(tgeo.se3_compose(tt, inv).numpy(),
                               np.asarray(jgeo.se3_compose(t, jgeo.se3_inverse(t))),
                               atol=1e-6)


def test_geometry_products_ignore_tf32_flags():
    """The 4x4 products are fp32 sums whatever the TF32 flags say."""
    aa, tr = _poses(seed=5)
    want = tgeo.transformation_from_parameters(torch.from_numpy(aa), torch.from_numpy(tr))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = tgeo.transformation_from_parameters(torch.from_numpy(aa), torch.from_numpy(tr))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert torch.equal(got, want)
