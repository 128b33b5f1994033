"""BEV-layout segmentation losses (counterpart of
`jperceiver_tpu/ops/seg_losses.py`): soft IoU / Dice / Tversky, focal,
weighted cross-entropy, boundary, generalized Dice, sensitivity-specificity,
asymmetric and Hausdorff, and the `topview_seg_loss` selector.

Logits are NCHW (B, C, H, W); labels (B, H, W) integers; a signed distance
field is (B, C-1, H, W), precomputed on the host (`ops/sdf.py`). tp/fp/fn
are per sample and class, summed over the spatial dims.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel import global_sum, world_size


def _onehot(labels: torch.Tensor, num_classes: int, dtype) -> torch.Tensor:
    """(B, H, W) -> (B, C, H, W) one-hot in `dtype`."""
    return F.one_hot(labels.long(), num_classes).permute(0, 3, 1, 2).to(dtype)


def _tp_fp_fn(probs: torch.Tensor, labels: torch.Tensor):
    onehot = _onehot(labels, probs.shape[1], probs.dtype)
    tp = (probs * onehot).sum((2, 3))
    fp = (probs * (1.0 - onehot)).sum((2, 3))
    fn = ((1.0 - probs) * onehot).sum((2, 3))
    return tp, fp, fn


def soft_iou_loss(logits, labels, smooth: float = 1.0):
    """-(soft IoU); a perfect prediction gives -1."""
    tp, fp, fn = _tp_fp_fn(logits.softmax(1), labels)
    return -((tp + smooth) / (tp + fp + fn + smooth)).mean()


def soft_dice_loss(logits, labels, smooth: float = 1.0):
    tp, fp, fn = _tp_fp_fn(logits.softmax(1), labels)
    return -((2.0 * tp + smooth) / (2.0 * tp + fp + fn + smooth)).mean()


def tversky_loss(logits, labels, alpha: float = 0.3, beta: float = 0.7,
                 smooth: float = 1.0):
    tp, fp, fn = _tp_fp_fn(logits.softmax(1), labels)
    return -((tp + smooth) / (tp + alpha * fp + beta * fn + smooth)).mean()


def focal_loss(logits, labels, alpha: float = 0.25, gamma: float = 2.0,
               balance_index: int = 0, smooth: float = 1e-5):
    """Label-smoothed focal loss on softmax probabilities."""
    num_classes = logits.shape[1]
    probs = logits.softmax(1)
    onehot = _onehot(labels, num_classes, probs.dtype)
    onehot = onehot.clamp(smooth / (num_classes - 1), 1.0 - smooth)
    pt = (onehot * probs).sum(1) + smooth
    alpha_vec = torch.full((num_classes,), 1.0 - alpha, dtype=probs.dtype,
                           device=probs.device)
    alpha_vec[balance_index] = alpha
    at = alpha_vec[labels.long()]
    return (-at * (1.0 - pt) ** gamma * torch.log(pt)).mean()


def weighted_cross_entropy(logits, labels, class_weight):
    """torch `nn.CrossEntropyLoss(weight=w)`: the weighted mean NLL over the
    global batch. Under a process group the weights' sum (no gradient) is
    the ranks' and the numerator is scaled by the world size, so that DDP's
    average of the gradients is the gradient of the global mean."""
    logp = logits.log_softmax(1)
    lab = labels.long()
    nll = -logp.gather(1, lab[:, None])[:, 0]
    w = class_weight.to(logp.dtype)[lab]
    return (w * nll).sum() * world_size() / global_sum(w.sum())


def boundary_loss(logits, sdf):
    """Mean of the foreground probabilities times their signed distance."""
    return (logits.softmax(1)[:, 1:] * sdf).mean()


def generalized_dice_loss(logits, labels, smooth: float = 1e-5):
    """Generalized Dice: class weights 1 / |gt_c|^2."""
    probs = logits.softmax(1)
    onehot = _onehot(labels, logits.shape[1], probs.dtype)
    gt_sum = onehot.sum((2, 3))
    w = 1.0 / (gt_sum + 1e-10) ** 2
    intersection = w * (probs * onehot).sum((2, 3))
    union = w * (probs.sum((2, 3)) + gt_sum)
    return (-2.0 * (intersection.sum(-1) + smooth) / (union.sum(-1) + smooth)).mean()


def ss_loss(logits, labels, r: float = 0.1, smooth: float = 1.0):
    """Sensitivity-specificity loss, with the reference's swapped naming:
    the "specificity" part is the squared error over the GT-positive
    region."""
    probs = logits.softmax(1)
    onehot = _onehot(labels, logits.shape[1], probs.dtype)
    bg = 1.0 - onehot
    sq = (onehot - probs) ** 2
    spec = (sq * onehot).sum((2, 3)) / (onehot.sum((2, 3)) + smooth)
    sens = (sq * bg).sum((2, 3)) / (bg.sum((2, 3)) + smooth)
    return (r * spec + (1.0 - r) * sens).mean()


def asym_loss(logits, labels, beta: float = 1.5, smooth: float = 1.0):
    """Asymmetric similarity loss."""
    tp, fp, fn = _tp_fp_fn(logits.softmax(1), labels)
    weight = beta ** 2 / (1.0 + beta ** 2)
    return -((tp + smooth) / (tp + weight * fn + (1.0 - weight) * fp + smooth)).mean()


def _edt_sq(mask: torch.Tensor, big: float = 1e12) -> torch.Tensor:
    """Exact squared Euclidean distance transform of a (B, H, W) boolean
    foreground: the squared distance of each foreground pixel to the
    nearest background pixel, 0 on the background. Two separable min-plus
    passes; the second holds a (B, H, H, W) tensor, so it is for BEV
    sizes, not image sizes."""
    b, h, w = mask.shape
    cols = torch.arange(w, dtype=torch.float32, device=mask.device)
    dj = (cols[None, :] - cols[:, None]) ** 2
    bg = ~mask.bool()
    big_t = torch.tensor(big, dtype=torch.float32, device=mask.device)
    d1 = torch.where(bg[..., :, None], dj[None, None], big_t).amin(-2)
    rows = torch.arange(h, dtype=torch.float32, device=mask.device)
    di = (rows[None, :] - rows[:, None]) ** 2
    dsq = (d1[:, :, None, :] + di[None, :, :, None]).amin(1)
    return torch.where(mask.bool(), torch.minimum(dsq, big_t), 0.0)


def hausdorff_loss(logits, labels):
    """HD-inspired Hausdorff loss (alpha 2): (softmax - onehot)^2 weighted
    by the squared distance maps of prediction and label, which carry no
    gradient."""
    num_classes = logits.shape[1]
    probs = logits.softmax(1)
    onehot = _onehot(labels, num_classes, probs.dtype)
    dists = []
    with torch.no_grad():
        for c in range(1, num_classes):
            pred_mask = probs[:, c] > 0.5
            gt_mask = onehot[:, c] > 0.5
            pc = torch.where(pred_mask.any((1, 2))[:, None, None],
                             _edt_sq(pred_mask), 0.0)
            gt = torch.where(gt_mask.any((1, 2))[:, None, None],
                             _edt_sq(gt_mask), 0.0)
            dists.append(pc + gt)
    dist = torch.stack(dists, 1)
    return ((probs[:, 1:] - onehot[:, 1:]) ** 2 * dist).mean()


_PRIMARY = {
    "iou": soft_iou_loss,
    "dice": soft_dice_loss,
    "focal": focal_loss,
    "tversky": tversky_loss,
    "gdice": generalized_dice_loss,
    "ss": ss_loss,
    "asym": asym_loss,
}


def topview_seg_loss(logits, labels, class_weight, loss_type: str = "iou",
                     loss_sum: int = 3, loss_weight: float = 1.0,
                     loss2_weight: float = 1.0, sdf=None):
    """The composite topview loss: loss_sum 1 is the primary loss only, 2
    adds the boundary loss, 3 adds the weighted cross-entropy too."""
    out = _PRIMARY[loss_type](logits, labels) * loss_weight
    if loss_sum >= 2:
        if sdf is None:
            raise ValueError("loss_sum>=2 requires a precomputed SDF input")
        out = out + boundary_loss(logits, sdf) * loss2_weight
    if loss_sum >= 3:
        out = out + weighted_cross_entropy(logits, labels, class_weight)
    return out
