"""Each op of the port's training slice against its JAX counterpart on the
same numpy inputs, forward and, where the step differentiates it, backward:
geometry, sampling, SSIM and the photometric loss, smoothness, every
segmentation loss, the SDF, the CGT label, and the optimizer (Adam / AdamW
with the global-norm clip, and the LR schedule) against optax.

Images are NHWC on the JAX side and NCHW in the port. Tolerance: 1e-5 of
max(1, max |jax|) unless a test says otherwise (fp32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jperceiver_tpu.engine import optim as jax_optim
from jperceiver_tpu.losses.cgt import cgt_scale_label as jax_cgt
from jperceiver_tpu.ops import geometry as jgeo
from jperceiver_tpu.ops import sampling as jsamp
from jperceiver_tpu.ops import seg_losses as jseg
from jperceiver_tpu.ops.photometric import reprojection_loss as jax_reprojection_loss
from jperceiver_tpu.ops.sdf import signed_distance_field as jax_sdf
from jperceiver_tpu.ops.smoothness import edge_aware_smoothness as jax_smoothness
from jperceiver_tpu.ops.ssim import ssim as jax_ssim
from jperceiver_tpu_torch.data.synthetic import kitti_like_calib
from jperceiver_tpu_torch.engine.optim import (build_lr_schedule, build_optimizer,
                                               clip_by_global_norm_, global_norm)
from jperceiver_tpu_torch.losses.cgt import cgt_scale_label
from jperceiver_tpu_torch.ops import geometry as geo
from jperceiver_tpu_torch.ops import sampling as samp
from jperceiver_tpu_torch.ops import seg_losses as seg
from jperceiver_tpu_torch.ops.photometric import reprojection_loss
from jperceiver_tpu_torch.ops.sdf import signed_distance_field
from jperceiver_tpu_torch.ops.smoothness import edge_aware_smoothness
from jperceiver_tpu_torch.ops.ssim import ssim

from torch_port_helpers import assert_close, nchw, nhwc

TOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def test_geometry_matches_jax():
    rng = _rng(0)
    disp = rng.uniform(0.01, 1, (2, 6, 8, 1)).astype(np.float32)
    K = np.tile(np.array([[5.0, 0, 4, 0], [0, 6, 3, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                         np.float32), (2, 1, 1))
    inv_K = np.linalg.inv(K).astype(np.float32)
    T = np.stack([np.eye(4, dtype=np.float32)] * 2)
    T[:, :3, 3] = rng.standard_normal((2, 3)) * 0.1
    sd, depth = jgeo.disp_to_depth(jnp.asarray(disp), 0.1, 100.0)
    psd, pdepth = geo.disp_to_depth(nchw(disp), 0.1, 100.0)
    assert_close(nhwc(psd), np.asarray(sd), TOL, "scaled_disp")
    assert_close(nhwc(pdepth), np.asarray(depth), TOL, "depth")
    pts = jgeo.backproject(depth, jnp.asarray(inv_K))
    ppts = geo.backproject(pdepth, torch.from_numpy(inv_K))
    assert_close(ppts.numpy(), np.asarray(pts), TOL, "backproject")
    grid = jgeo.project(pts, jnp.asarray(K), jnp.asarray(T), 6, 8)
    pgrid = geo.project(ppts, torch.from_numpy(K), torch.from_numpy(T), 6, 8)
    assert_close(pgrid.numpy(), np.asarray(grid), TOL, "project")
    K3, Tr = kitti_like_calib()
    hom = jgeo.ground_homography(jnp.asarray(Tr[None]), jnp.asarray(K3[None, :3, :3]))
    phom = geo.ground_homography(torch.from_numpy(Tr[None]), torch.from_numpy(K3[None, :3, :3]))
    assert_close(phom.numpy(), np.asarray(hom), TOL, "ground_homography")


@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
@pytest.mark.parametrize("img_grad", [True, False])
def test_grid_sample_matches_jax(padding_mode, img_grad):
    """Forward and the grid gradient; coordinates run past the image so
    both paddings and the clamp are exercised. With `img_grad` False the
    JAX side takes its constant-image VJP, as the photometric warp does."""
    rng = _rng(1)
    img = rng.random((2, 7, 9, 3)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 5, 6, 2)).astype(np.float32)
    cot = rng.standard_normal((2, 5, 6, 3)).astype(np.float32)
    out, vjp = jax.vjp(lambda g: jsamp.grid_sample(jnp.asarray(img), g, padding_mode,
                                                   img_grad=img_grad), jnp.asarray(grid))
    (want_g,) = vjp(jnp.asarray(cot))
    gt = torch.from_numpy(grid).requires_grad_()
    got = samp.grid_sample(nchw(img), gt, padding_mode)
    got.backward(nchw(cot))
    assert_close(nhwc(got), np.asarray(out), TOL, "forward")
    assert_close(gt.grad.numpy(), np.asarray(want_g), 1e-4, "grid grad")


def test_grid_sample_multi_and_warp_perspective_match_jax():
    rng = _rng(2)
    img = rng.random((1, 8, 10, 3)).astype(np.float32)
    grids = rng.uniform(-1, 1, (1, 3, 4, 5, 2)).astype(np.float32)
    want = jsamp.grid_sample_multi(jnp.asarray(img), jnp.asarray(grids))
    got = samp.grid_sample_multi(nchw(img), torch.from_numpy(grids))
    assert got.shape == (1, 3, 3, 4, 5)
    assert_close(got.numpy().transpose(0, 1, 3, 4, 2), np.asarray(want), TOL, "multi")
    M = np.array([[[1.1, 0.1, 0.5], [0.05, 0.9, -0.3], [0.001, 0.002, 1.0]]], np.float32)
    want = jsamp.warp_perspective(jnp.asarray(img), jnp.asarray(M), (6, 12))
    got = samp.warp_perspective(nchw(img), torch.from_numpy(M), (6, 12))
    assert_close(nhwc(got), np.asarray(want), 1e-4, "warp_perspective")


def test_resize_area_matches_jax():
    img = _rng(3).random((2, 12, 16, 3)).astype(np.float32)
    for oh, ow in ((6, 8), (3, 4), (12, 16)):
        want = jsamp.resize_area(jnp.asarray(img), oh, ow)
        assert_close(nhwc(samp.resize_area(nchw(img), oh, ow)), np.asarray(want), TOL,
                     f"{oh}x{ow}")


def test_ssim_and_reprojection_loss_match_jax():
    """Forward and gradient; the target broadcasts against a stack of
    predictions, as the unfused photometric path uses it. A constant patch
    puts the SSIM clip exactly on 0, where JAX's gradient is one half."""
    rng = _rng(4)
    pred = rng.random((3, 2, 8, 9, 3)).astype(np.float32)
    targ = rng.random((2, 8, 9, 3)).astype(np.float32)
    pred[0, 0, :4, :4] = targ[0, :4, :4] = 0.5
    cot = rng.standard_normal((3, 2, 8, 9, 3)).astype(np.float32)
    for jfn, fn, c in ((jax_ssim, ssim, cot), (jax_reprojection_loss, reprojection_loss,
                                                cot[..., :1])):
        want, vjp = jax.vjp(lambda p: jfn(p, jnp.asarray(targ)), jnp.asarray(pred))
        (want_g,) = vjp(jnp.asarray(c))
        pt = torch.from_numpy(pred.transpose(0, 1, 4, 2, 3).copy()).requires_grad_()
        got = fn(pt, nchw(targ))
        got.backward(torch.from_numpy(c.transpose(0, 1, 4, 2, 3).copy()))
        assert_close(got.detach().numpy().transpose(0, 1, 3, 4, 2), np.asarray(want), TOL,
                     fn.__name__)
        assert_close(pt.grad.numpy().transpose(0, 1, 3, 4, 2), np.asarray(want_g), 1e-4,
                     f"{fn.__name__} grad")


def test_smoothness_matches_jax():
    rng = _rng(5)
    disp = rng.random((2, 4, 6, 1)).astype(np.float32)
    img = rng.random((2, 16, 24, 3)).astype(np.float32)
    want, vjp = jax.vjp(lambda d: jax_smoothness(d, jnp.asarray(img)), jnp.asarray(disp))
    (want_g,) = vjp(jnp.ones(()))
    dt = nchw(disp).requires_grad_()
    got = edge_aware_smoothness(dt, nchw(img))
    got.backward()
    assert_close(got.detach().numpy(), np.asarray(want), TOL, "smoothness")
    assert_close(nhwc(dt.grad), np.asarray(want_g), 1e-4, "grad")


def _seg_inputs(seed, c=2):
    rng = _rng(seed)
    logits = (3 * rng.standard_normal((2, 12, 12, c))).astype(np.float32)
    labels = rng.integers(0, c, (2, 12, 12)).astype(np.int32)
    labels[1] = 0  # a sample with an absent foreground class
    return logits, labels


@pytest.mark.parametrize("name", ["soft_iou_loss", "soft_dice_loss", "tversky_loss",
                                  "focal_loss", "generalized_dice_loss", "ss_loss",
                                  "asym_loss", "hausdorff_loss"])
def test_seg_loss_matches_jax(name):
    logits, labels = _seg_inputs(6, c=3 if name == "focal_loss" else 2)
    jfn, fn = getattr(jseg, name), getattr(seg, name)
    want, jg = jax.value_and_grad(lambda lg: jfn(lg, jnp.asarray(labels)))(jnp.asarray(logits))
    lt = nchw(logits).requires_grad_()
    got = fn(lt, torch.from_numpy(labels))
    got.backward()
    assert_close(got.detach().numpy(), np.asarray(want), TOL, name)
    assert_close(nhwc(lt.grad), np.asarray(jg), 1e-4, f"{name} grad")


@pytest.mark.parametrize("loss_sum", [1, 2, 3])
def test_topview_seg_loss_matches_jax(loss_sum):
    """The composite loss of the flagship (iou + boundary + weighted CE at
    loss_sum 3), with the SDF of each package's own `ops/sdf.py`."""
    logits, labels = _seg_inputs(7)
    weight = np.array([1.0, 5.0], np.float32)
    sdf_j = jax_sdf(labels, 2)
    sdf_t = signed_distance_field(labels, 2)
    np.testing.assert_allclose(sdf_t.transpose(0, 2, 3, 1), sdf_j, rtol=1e-6, atol=1e-5)

    def jfn(lg):
        return jseg.topview_seg_loss(lg, jnp.asarray(labels), jnp.asarray(weight), "iou",
                                     loss_sum, 20.0, 20.0, jnp.asarray(sdf_j))

    want, jg = jax.value_and_grad(jfn)(jnp.asarray(logits))
    lt = nchw(logits).requires_grad_()
    got = seg.topview_seg_loss(lt, torch.from_numpy(labels), torch.from_numpy(weight), "iou",
                               loss_sum, 20.0, 20.0, torch.from_numpy(sdf_t))
    got.backward()
    assert_close(got.detach().numpy(), np.asarray(want), TOL, "loss")
    assert_close(nhwc(lt.grad), np.asarray(jg), 1e-4, "grad")


def test_weighted_ce_and_boundary_match_jax():
    logits, labels = _seg_inputs(8)
    weight = np.array([1.0, 15.0], np.float32)
    want = jseg.weighted_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                       jnp.asarray(weight))
    got = seg.weighted_cross_entropy(nchw(logits), torch.from_numpy(labels),
                                     torch.from_numpy(weight))
    assert_close(got.numpy(), np.asarray(want), TOL, "ce")
    sdf = signed_distance_field(labels, 2)
    want = jseg.boundary_loss(jnp.asarray(logits), jnp.asarray(sdf.transpose(0, 2, 3, 1)))
    assert_close(seg.boundary_loss(nchw(logits), torch.from_numpy(sdf)).numpy(),
                 np.asarray(want), TOL, "boundary")


@pytest.mark.parametrize("kind,split", [("static", "odometry"), ("dynamic", "odometry"),
                                        ("both", "argo")])
def test_cgt_label_matches_jax(kind, split):
    """The CGT scale label at a BEV of 32 drawn at the full (375, 1242)
    KITTI resolution. Labels agree except where the sampling position of a
    pixel sits within fp32 rounding of a BEV cell edge (bilinear weights
    there flip a whole cell): at most 1 in 10,000 pixels may differ."""
    K3, Tr = kitti_like_calib()
    b, s = 2, 32
    bev = np.zeros((b, s, s), np.int32)
    bev[:, s // 4:s - 2, s // 3:2 * s // 3] = 1
    layout = bev.astype(np.float32) if kind == "both" else bev
    args = dict(kind=kind, split=split, occ_map_size=s, out_hw=(375, 1242))
    want = np.asarray(jax_cgt(None if kind == "dynamic" else jnp.asarray(layout),
                              jnp.asarray(np.tile(K3[None, :3, :3], (b, 1, 1))),
                              jnp.asarray(np.tile(Tr[None], (b, 1, 1))), **args))[..., 0]
    got = cgt_scale_label(None if kind == "dynamic" else torch.from_numpy(layout),
                          torch.from_numpy(np.tile(K3[None, :3, :3], (b, 1, 1))),
                          torch.from_numpy(np.tile(Tr[None], (b, 1, 1))), **args)[:, 0]
    assert got.shape == want.shape and (want > 0).sum() > 1000
    err = np.abs(got.numpy() - want)
    assert (err > 1e-4 * max(1.0, want.max())).mean() <= 1e-4, err.max()


def _params(seed):
    rng = _rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (5,), (2, 2, 3))]


@pytest.mark.parametrize("wd", [0.0, 1e-2])
def test_adam_with_clip_matches_optax(wd):
    """Five steps of clip(35) + Adam (AdamW with weight decay) on the same
    gradients, some above the clip norm: parameters to 1e-6."""
    cfg = {"optimizer": {"type": "Adam", "lr": 1e-2, "weight_decay": wd},
           "optimizer_config": {"grad_clip": {"max_norm": 35.0}},
           "lr_config": {"policy": "step", "step": [1]}}
    p0 = _params(0)
    tx, _ = jax_optim.build_optimizer(cfg, steps_per_epoch=3)
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt, sched, clip = build_optimizer(cfg, tp, steps_per_epoch=3)
    assert clip == 35.0
    for i in range(5):
        grads = [g * (40.0 if i % 2 else 1.0) for g in _params(10 + i)]
        upd, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, g in zip(tp, grads):
            p.grad = torch.from_numpy(g.copy())
        norm = global_norm([p.grad for p in tp])
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
        clip_by_global_norm_([p.grad for p in tp], norm, clip)
        for group in opt.param_groups:
            group["lr"] = sched(i)
        opt.step()
        for p, want in zip(tp, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("lr_config", [
    {"policy": "step", "step": [2, 5]},
    {"policy": "step", "step": [3], "warmup": "linear", "warmup_iters": 7,
     "warmup_ratio": 0.25},
    {"policy": "fixed", "warmup": "linear"},
])
def test_lr_schedule_matches_jax(lr_config):
    cfg = {"learning_rate": 2e-4, "lr_config": lr_config}
    want = jax_optim.build_lr_schedule(cfg, 4)
    got = build_lr_schedule(cfg, 4)
    for it in range(0, 40):
        np.testing.assert_allclose(got(it), float(want(it)), rtol=1e-6)
