"""The port's reprojection pair (`reproj_min`: K1 forward, K2 backward) on
the CPU, i.e. their plain versions, against the JAX package's
`reproj_min_pallas`, whose Pallas kernels and ring fix-ups run in
interpret mode here.

Inputs hold exact frame ties: frame 1 copies frame 0 over the left half of
the image, so the frame-min routes half of the cotangent to each there, by
the `jnp.minimum` chain in both packages. The JAX side runs once a dtype at
B=3 (tracing its interpreted kernels takes some 15 s a call); the port runs
at B = 1, 2 and 3 on the first B batch elements of the same inputs, against
the same elements of the JAX result (batch elements are independent). Tolerances: the forward and the
fp32 gradient to 1e-5 of max(1, max |jax|) (fp32 statistics summed in
another order); bf16 gradients to 1e-2 (one bf16 rounding of each).
The kernels themselves run on the card: `tests/test_torch_port_cuda.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jperceiver_tpu.ops.pallas.reproj import reproj_min_pallas, reproj_min_reference
from jperceiver_tpu_torch.ops.cuda import reproj_min, reproj_min_plain

from torch_port_helpers import assert_close

_DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(b, seed, h=16, w=20):
    rng = np.random.default_rng(seed)
    preds = rng.random((2, b, 2, 3, h, w)).astype(np.float32)
    preds[:, :, 1, :, :, :w // 2] = preds[:, :, 0, :, :, :w // 2]
    targ = rng.random((b, 3, h, w)).astype(np.float32)
    cot = rng.standard_normal((2, b, h, w)).astype(np.float32)
    return preds, targ, cot


_PALLAS = {}


def _pallas_b3(dtype):
    """Inputs at B=3 and the JAX forward and VJP on them, once a dtype."""
    if dtype not in _PALLAS:
        jdt, _ = _DT[dtype]
        preds, targ, cot = _inputs(3, seed=3)
        tj = jnp.asarray(targ, jdt)
        want, vjp = jax.vjp(lambda p: reproj_min_pallas(p, tj, 8), jnp.asarray(preds, jdt))
        (want_g,) = vjp(jnp.asarray(cot))
        _PALLAS[dtype] = (preds, targ, cot, np.asarray(want), np.asarray(want_g, np.float32))
    return _PALLAS[dtype]


@pytest.mark.parametrize("dtype,b", [("float32", 1), ("float32", 2), ("float32", 3),
                                     ("bfloat16", 2)])
def test_reproj_min_matches_pallas(dtype, b):
    _, tdt = _DT[dtype]
    preds, targ, cot, want, want_g = _pallas_b3(dtype)
    preds, targ, cot = preds[:, :b], targ[:b], cot[:, :b]
    want, want_g = want[:, :b], want_g[:, :b]

    pt = torch.from_numpy(np.ascontiguousarray(preds)).to(tdt).requires_grad_()
    got = reproj_min(pt, torch.from_numpy(np.ascontiguousarray(targ)).to(tdt))
    got.backward(torch.from_numpy(np.ascontiguousarray(cot)))
    assert got.dtype == torch.float32 and pt.grad.dtype == tdt
    assert_close(got.detach().numpy(), want, 1e-5, "forward")
    assert_close(pt.grad.float().numpy(), want_g, 1e-5 if dtype == "float32" else 1e-2, "grad")


def test_reproj_ties_split_the_cotangent():
    """Where the two frames are equal the frame-min gives each half."""
    preds, targ, _ = _inputs(1, seed=7, h=12, w=16)
    preds[:, :, 1] = preds[:, :, 0]
    pt = torch.from_numpy(preds).requires_grad_()
    reproj_min(pt, torch.from_numpy(targ)).sum().backward()
    torch.testing.assert_close(pt.grad[:, :, 0], pt.grad[:, :, 1], rtol=0, atol=0)
    whole = torch.from_numpy(preds[:, :, :1]).requires_grad_()
    reproj_min(whole, torch.from_numpy(targ)).sum().backward()
    torch.testing.assert_close(pt.grad[:, :, 0] * 2, whole.grad[:, :, 0])


def test_reproj_plain_matches_reference_and_target_gets_zero():
    """The plain forward equals the JAX `reproj_min_reference` (three
    frames, odd sizes), and the target's gradient is zero."""
    rng = np.random.default_rng(11)
    preds = rng.random((1, 2, 3, 3, 9, 13)).astype(np.float32)
    targ = rng.random((2, 3, 9, 13)).astype(np.float32)
    want = reproj_min_reference(jnp.asarray(preds), jnp.asarray(targ))
    tt = torch.from_numpy(targ).requires_grad_()
    got = reproj_min(torch.from_numpy(preds), tt)
    assert_close(got.detach().numpy(), np.asarray(want), 1e-5, "forward")
    assert_close(reproj_min_plain(torch.from_numpy(preds), tt).detach().numpy(),
                 np.asarray(want), 1e-5, "plain")
    got.sum().backward()
    assert torch.count_nonzero(tt.grad) == 0


@pytest.mark.parametrize("bad", ["dtype", "shape"])
def test_reproj_rejects(bad):
    preds = torch.zeros(1, 1, 2, 3, 8, 8)
    targ = torch.zeros(1, 3, 8, 8)
    if bad == "dtype":
        targ = targ.to(torch.bfloat16)
        with pytest.raises(TypeError):
            reproj_min(preds, targ)
    else:
        with pytest.raises(ValueError):
            reproj_min(preds, targ[:, :2])
