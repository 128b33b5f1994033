"""The port's kernel wrappers on the CPU (their plain versions) against the
JAX package's kernels, and the K3 gates.

K3 (`conv3x3_fwd`) is held against `pallas_conv3x3` / `pallas_conv3x3_valid`,
which run the Pallas kernel in interpret mode on the CPU. K5
(`maxpool5x5_fwd`) is held bit for bit against `max_pool_5x5_s1` and
`_pool_ref`. The kernels themselves run only on a GPU:
`tests/test_torch_port_cuda.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jperceiver_tpu.ops.pallas import conv3x3 as jax_conv3x3
from jperceiver_tpu.ops.pallas.maxpool import _pool_ref, max_pool_5x5_s1
from jperceiver_tpu_torch.models.jperceiver import conv3x3_sites
from jperceiver_tpu_torch.ops.cuda import conv3x3_fwd, maxpool5x5_fwd
from jperceiver_tpu_torch.ops.cuda.conv3x3 import (conv_site_eligible,
                                                   deep_gate, shallow_gate)

from torch_port_helpers import nchw, nhwc

_DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [8, 64])
@pytest.mark.parametrize("pad", [0, 1])
def test_conv3x3_plain_matches_pallas(dtype, c, pad):
    jdt, tdt = _DT[dtype]
    rng = np.random.default_rng(c + pad)
    o = 16
    h, w = 10, 14  # non-square output
    x = rng.standard_normal((2, h + 2 - 2 * pad, w + 2 - 2 * pad, c)).astype(np.float32)
    # Weights ~ N(0, 1/(9C)): outputs of order 1, as in a trained network.
    wt = (rng.standard_normal((3, 3, c, o)) / np.sqrt(9 * c)).astype(np.float32)
    b = rng.standard_normal((o,)).astype(np.float32)
    fn = jax_conv3x3.pallas_conv3x3 if pad else jax_conv3x3.pallas_conv3x3_valid
    want = np.asarray(fn(jnp.asarray(x, jdt), jnp.asarray(wt, jdt),
                         jnp.asarray(b, jdt)).astype(jnp.float32))
    got = conv3x3_fwd(nchw(x).to(tdt),
                      torch.from_numpy(wt.transpose(3, 2, 0, 1).copy()).to(tdt),
                      torch.from_numpy(b).to(tdt), pad)
    assert got.dtype == tdt and got.shape == (2, o, h, w)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(nhwc(got), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_maxpool5x5_plain_bit_exact(dtype):
    jdt, tdt = _DT[dtype]
    rng = np.random.default_rng(3)
    # Quarter steps through a ReLU: zero plateaus and many tied maxima.
    x = np.maximum(np.round(4 * rng.standard_normal((2, 12, 20, 16))) / 4, 0)
    x = x.astype(np.float32)
    xj = jnp.asarray(x, jdt)
    got = maxpool5x5_fwd(nchw(x).to(tdt))
    assert got.dtype == tdt
    got = nhwc(got)
    np.testing.assert_array_equal(got, np.asarray(max_pool_5x5_s1(xj), np.float32))
    np.testing.assert_array_equal(got, np.asarray(_pool_ref(xj), np.float32))


def test_gates_match_jax(monkeypatch):
    """The port's gate predicates equal the JAX package's, over a grid that
    covers each bound, with the JAX backend test forced to 'kernel
    available'."""
    monkeypatch.setattr(jax_conv3x3, "_interpret", lambda: False)
    for c_in in (32, 47, 48, 64, 128, 129, 256, 513):
        for c_out in (1, 64, 127, 128, 256):
            for h, w in ((256, 256), (128, 128), (127, 130), (64, 64),
                         (63, 64), (32, 32), (8, 2048), (6, 4096), (256, 64)):
                assert shallow_gate(c_in, c_out, h, w) == \
                    jax_conv3x3.use_pallas_conv(c_in, c_out, h, w), (c_in, c_out, h, w)
                assert deep_gate(c_in, c_out, h, w) == \
                    jax_conv3x3.use_pallas_conv_deep(c_in, c_out, h, w), (c_in, c_out, h, w)


def test_k3_sites_at_1024():
    """The 1024^2 eval forward (both branches, pose) has 26 K3 sites: 10 in
    each 1024^2 trunk (layer1-3) and 6 in the depth decoder (iconv and merge
    at 64^2, 128^2, 256^2; the iconv is one conv over the 513-channel
    concat). The pose trunk and the layout decoders have none."""
    sites = conv3x3_sites(1024, 1024, 256)
    k3 = [(s["c_in"], s["c_out"], s["h"], s["w"], s["pad"]) for s in sites if s["k3"]]
    trunk = ([(64, 64, 256, 256, 1)] * 4 + [(128, 128, 128, 128, 1)] * 3
             + [(256, 256, 64, 64, 1)] * 3)
    decoder = [(513, 256, 64, 64, 0), (256, 256, 64, 64, 0),
               (513, 256, 128, 128, 0), (256, 256, 128, 128, 0),
               (513, 256, 256, 256, 0), (256, 256, 256, 256, 0)]
    assert sorted(k3) == sorted(trunk * 2 + decoder)
    for s in sites:
        assert s["k3"] == (s["stride"] == 1 and conv_site_eligible(
            s["c_in"], s["c_out"], s["h"], s["w"], True, True))
    # Gates off: no site; one gate: its own sites.
    assert not any(conv_site_eligible(s["c_in"], s["c_out"], s["h"], s["w"], False, False)
                   for s in sites)
    n_shallow = sum(s["stride"] == 1 and conv_site_eligible(
        s["c_in"], s["c_out"], s["h"], s["w"], True, False) for s in sites)
    assert n_shallow == 8 + 6  # layer1 at 256^2, layer2 (128 ch) at 128^2


@pytest.mark.parametrize("cfg,want", [
    (None, (True, True)),
    ({"use_pallas_conv": False, "use_pallas_conv_deep": None}, (False, True)),
    ({"use_pallas_conv_deep": False}, (True, False)),
])
def test_eval_step_reads_gate_keys(cfg, want):
    """The eval step sets K3's gates from the JAX config keys; an absent or
    None key leaves its gate on."""
    from jperceiver_tpu_torch.engine import make_eval_step
    from jperceiver_tpu_torch.models import JPerceiver
    from jperceiver_tpu_torch.models.common import Conv3x3

    model = JPerceiver(occ_map_size=32)
    make_eval_step(model, cfg, device="cpu")
    assert {(m.gate_shallow, m.gate_deep) for m in model.modules()
            if isinstance(m, Conv3x3)} == {want}
