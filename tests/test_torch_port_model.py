"""The port's inference slice as a whole against the JAX package: the eval
step, the weight bridge and streaming inference, at 128^2, occ 32, fp32.

Weights are random (params and BatchNorm running stats) from a seed and
reach the port through `convert.state_dict_from_jax`. Tolerance for every
output: max |port - jax| <= 2e-4 * max(1, max |jax|) -- fp32 sums in
another order through ~40 layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jperceiver_tpu.data import synthetic_batch as jax_synthetic_batch
from jperceiver_tpu.engine.checkpoint import export_torch_baseline
from jperceiver_tpu.engine.streaming import make_streaming_fn as jax_make_streaming_fn
from jperceiver_tpu.models import JPerceiver as JaxJPerceiver
from jperceiver_tpu_torch.convert import state_dict_from_jax
from jperceiver_tpu_torch.data import synthetic_batch
from jperceiver_tpu_torch.engine import make_eval_step, make_streaming_fn
from jperceiver_tpu_torch.models import JPerceiver

from torch_port_helpers import assert_close, nhwc, random_variables

H = W = 128
OCC = 32
TOL = 2e-4


def _jax_model(branches="both"):
    return JaxJPerceiver(height=H, width=W, occ_map_size=OCC, branches=branches)


def _variables(jm, seed=0):
    batch = {k: jnp.asarray(v) for k, v in jax_synthetic_batch(1, H, W, OCC).items()}
    return random_variables(jm, batch, train=False, with_pose=True, seed=seed)


@pytest.fixture(scope="module")
def both():
    jm = _jax_model()
    v = _variables(jm)
    port = JPerceiver(occ_map_size=OCC)
    port.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"]),
                         strict=True)
    return jm, v, port


def test_synthetic_batch_matches_jax():
    mine = synthetic_batch(2, 64, 96, seed=5)
    ref = jax_synthetic_batch(2, 64, 96, 16, seed=5)
    np.testing.assert_array_equal(mine["color_aug"],
                                  ref["color_aug"].transpose(0, 1, 4, 2, 3))
    for k in ("K", "inv_K"):
        np.testing.assert_array_equal(mine[k], ref[k])


def test_eval_step_matches_jax(both):
    jm, v, port = both
    want = jm.apply(v, {k: jnp.asarray(a) for k, a in
                        jax_synthetic_batch(1, H, W, OCC, seed=1).items()},
                    train=False, with_pose=True)
    got = make_eval_step(port, device="cpu")(synthetic_batch(1, H, W, seed=1))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == torch.float32, k
        g = nhwc(g) if g.dim() == 4 else g.numpy()
        assert_close(g, w, TOL, k)


def test_state_dict_equals_export_torch_baseline(both):
    _, v, _ = both
    mine = state_dict_from_jax(v["params"], v["batch_stats"])
    ref = export_torch_baseline(v["params"], v["batch_stats"])
    assert sorted(mine) == sorted(ref)
    for k, val in ref.items():
        assert mine[k].dtype == torch.from_numpy(np.asarray(val)).dtype, k
        np.testing.assert_array_equal(mine[k].numpy(), np.asarray(val), err_msg=k)


def test_single_branch_tree_loads():
    """A road-only tree has no vehicle subtrees: it loads strictly into a
    road-only port model and, with strict=False, into a both-branch one,
    which then misses exactly the vehicle modules."""
    jm = _jax_model("road")
    v = _variables(jm, seed=1)
    sd = state_dict_from_jax(v["params"], v["batch_stats"])
    JPerceiver(occ_map_size=OCC, branches="road").load_state_dict(
        sd, strict=True)
    res = JPerceiver(occ_map_size=OCC).load_state_dict(sd, strict=False)
    assert not res.unexpected_keys
    roots = {k.split(".")[0] for k in res.missing_keys}
    assert roots == {"CycledViewProjectionB", "CrossViewTransformerB",
                     "LayoutDecoderB", "LayoutTransformDecoderB"}


def test_streaming_matches_jax(both):
    """Port streaming (chunk 2, batched per chunk) against the JAX `lax.scan`
    runner (chunk 2), T=5 frames."""
    jm, v, port = both
    frames = np.random.default_rng(0).uniform(0, 1, (5, H, W, 3)).astype(np.float32)
    want = jax_make_streaming_fn(jm, chunk=2)(
        jax.tree_util.tree_map(jnp.asarray, v), jnp.asarray(frames))
    got = make_streaming_fn(port, chunk=2, device="cpu")(frames.transpose(0, 3, 1, 2))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        g = nhwc(g) if g.dim() == 4 else g.numpy()
        assert_close(g, w, TOL, k)


def test_entry_points_refuse_without_cuda(monkeypatch):
    """With no card, the entry points raise unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = JPerceiver(occ_map_size=OCC)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_eval_step(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_streaming_fn(model)
