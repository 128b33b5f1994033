"""The port's `compute_losses` against the JAX package's, loss key for loss
key, along the configuration axes the flagship test
(`test_torch_train_step.py`) does not take: the vehicle branch
(`dynamic`), the three Argoverse types, `static_raw` with its Garg crop,
automask off (the plain frame-min route), `use_pallas_reproj=False`, two
frames, and the stereo frame of `test_stereo.py`, which the port warps by
`batch["stereo_T"]`. Each JAX configuration costs a compile of a few
seconds, so the axes share configurations: every axis is in one of them.

Both packages get the same batch (`synthetic_batch` from one seed, NHWC for
JAX and NCHW for the port) and the same model outputs at 64^2, occ 16,
fp32. The model cannot run at 64^2 (its layout encoder reduces the input
128x), so the outputs are drawn from a seed in the model's output shapes:
disparities in (0, 1), BEV logits, small camera motions. Only losses are
compared, with no gradients. The JAX loss is jitted, as the JAX step runs
it, with fp32 warp taps (on the CPU its "auto" taps are bf16) and its
unfused photometric path (on the CPU its "auto" is off). The port takes its
fused route unless the configuration turns it off, with fp32 operands (its
"auto" is bf16 at B=1, as the JAX package's is where its kernel is on), and
JAX's own automask noise draw.

Tolerance: every key within 1e-5 of max(1, |jax|) (fp32 sums in another
order, the fused and unfused frame-min routes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jperceiver_tpu.config import Config as JaxConfig
from jperceiver_tpu.data import synthetic_batch as jax_synthetic_batch
from jperceiver_tpu.losses import compute_losses as jax_compute_losses
from jperceiver_tpu_torch.data import synthetic_batch
from jperceiver_tpu_torch.losses.multitask import compute_losses

H = W = 64
OCC = 16
B = 1
TOL = 1e-5
BASE = dict(
    type="static", split="odometry", frame_ids=[0, -1, 1], scales=[0, 1, 2, 3],
    height=H, width=W, occ_map_size=OCC, num_class=2, min_depth=0.1, max_depth=100.0,
    automask=True, disp_norm=True, smoothness_weight=1e-3, scale_weight=0.1,
    static_weight=5.0, dynamic_weight=15.0, loss_type="iou", loss_sum=3, loss_weight=20,
    loss2_weight=20, loss_weightS=20, loss2_weightS=20, cgt_label_hw=(94, 310))
# test_stereo.py's configuration, at 64^2.
STEREO = dict(BASE, frame_ids=[0, -1, "s"], automask=False, disp_norm=False,
              loss_sum=1, loss_weight=1, loss2_weight=1, loss_weightS=1, loss2_weightS=1)
AXES = {
    "dynamic_automask_off": dict(BASE, type="dynamic", automask=False),
    "argo_static_two_frames": dict(BASE, type="Argo_static", split="argo", frame_ids=[0, -1]),
    "argo_dynamic_unfused": dict(BASE, type="Argo_dynamic", split="argo",
                                 use_pallas_reproj=False),
    "argo_both": dict(BASE, type="Argo_both", split="argo"),
    # the Garg crop is set for the full (375, 1242) label
    "static_raw": dict(BASE, type="static_raw", split="raw", cgt_label_hw=(375, 1242)),
    "stereo": STEREO,
}


def _rotation(rng):
    """A small rotation matrix (Rodrigues of an axis-angle of ~0.02 rad)."""
    v = rng.normal(0, 0.02, 3)
    t = np.linalg.norm(v)
    k = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]]) / t
    return np.eye(3) + np.sin(t) * k + (1 - np.cos(t)) * k @ k


def _outputs(cfg, seed):
    """Model outputs (NHWC numpy, JAX's layout) for `cfg`, from `seed`."""
    rng = np.random.default_rng(seed)
    out = {}
    for s in cfg["scales"]:
        h, w = H >> (s + 1), W >> (s + 1)
        out[f"disp/{s}"] = (1 / (1 + np.exp(-rng.normal(0, 1.5, (B, h, w, 1))))).astype(
            np.float32)
    for sfx in ("", "B"):
        for key in ("topview", "transform_topview"):
            out[key + sfx] = rng.normal(0, 2, (B, OCC, OCC, 2)).astype(np.float32)
        for key in ("features", "retransform_features"):
            out[key + sfx] = rng.normal(0, 1, (B, 2, 2, 8)).astype(np.float32)
    for f in cfg["frame_ids"][1:]:
        if f == "s":
            continue
        T = np.tile(np.eye(4), (B, 1, 1))
        for b in range(B):
            T[b, :3, :3] = _rotation(rng)
            T[b, :3, 3] = rng.normal(0, 0.3, 3)
        out[f"cam_T_cam/{f}"] = T.astype(np.float32)
    return out


def _batch(cfg, seed):
    n_f = len(cfg["frame_ids"])
    jb = jax_synthetic_batch(B, H, W, OCC, num_frames=n_f, seed=seed)
    pb = synthetic_batch(B, H, W, OCC, num_frames=n_f, seed=seed)
    if "s" in cfg["frame_ids"]:
        st = np.tile(np.eye(4, dtype=np.float32)[None], (B, 1, 1))
        st[:, 0, 3] = -0.1
        jb["stereo_T"] = pb["stereo_T"] = st
    return jb, pb


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _port_losses(cfg, out, batch, noise=None):
    return compute_losses({k: _nchw(v) if v.ndim == 4 else torch.from_numpy(v)
                           for k, v in out.items()},
                          {k: torch.from_numpy(v) for k, v in batch.items()},
                          dict(cfg, pallas_reproj_bf16=False), noise=noise)


def _compare(cfg, seed=0):
    jb, pb = _batch(cfg, seed)
    out = _outputs(cfg, seed + 100)
    rng = jax.random.key(seed + 7)
    jcfg = JaxConfig.fromdict(dict(cfg, warp_tap_dtype="float32"))
    want = jax.jit(lambda o, b, r: jax_compute_losses(o, b, jcfg, r))(
        {k: jnp.asarray(v) for k, v in out.items()},
        {k: jnp.asarray(v) for k, v in jb.items()}, rng)
    noise = None
    if cfg["automask"]:
        n_f = len(cfg["frame_ids"]) - 1
        noise = torch.from_numpy(np.array(jax.random.normal(
            jax.random.split(rng)[1], (len(cfg["scales"]), n_f, B, H, W), jnp.float32) * 1e-5))
    got = _port_losses(cfg, out, pb, noise)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = float(w)
        assert np.isfinite(w), k
        assert abs(float(got[k]) - w) <= TOL * max(1.0, abs(w)), (k, float(got[k]), w)
    return got


@pytest.mark.parametrize("axis", sorted(AXES))
def test_compute_losses_matches_jax(axis):
    got = _compare(AXES[axis])
    if axis == "static_raw":
        # The crop leaves label pixels, so the scale loss is not 0.
        assert float(got["scale_loss/0"]) > 0


def test_stereo_frame_warped_by_stereo_T():
    """The stereo frame reaches the photometric loss through stereo_T: the
    loss moves with the baseline (it raised KeyError before)."""
    out = _outputs(STEREO, 100)
    _, pb = _batch(STEREO, 0)
    a = _port_losses(STEREO, out, pb)
    pb["stereo_T"][:, 0, 3] = 0.1
    b = _port_losses(STEREO, out, pb)
    assert float(a["min_reconstruct_loss/0"]) != float(b["min_reconstruct_loss/0"])
