"""The reprojection forward (K1, fused over the warped frames and the
automask identity frames) replayed on the CPU, block by block as `k1_plan`
has it, against the JAX package.

On the card a K1 block owns one image and a tile of 32 columns x th rows.
It stages the target over the tile and its 1-pixel reflect halo, forms the
target's window statistics once, then walks every frame that reads this
target -- each scale's frames in order, then the identity frames -- and for
each channel plane forms the 3-sums of x, x^2 and x*y along each staged row,
adds three rows of them into the window sums, and takes the loss term from
them and the target's 2 mu_y, mu_y^2 + C1 and sigma_y + C2 (the contract's
uncentred statistics, regrouped); the channel terms are added from zero and
divided by C. The warped frames'
losses go through the chain of minimums into the output and the routing
code; the identity frames' losses are written as they are. Here each tile
is cut out of the tensors with plain slicing and the same steps run on it
in fp32, so an index error in the plan, the staging offsets or the frame
walk shows up before any card runs it.

Held to the JAX package's `reproj_min_pallas` forward (its Pallas kernel in
interpret mode) on both operand sets: the warped stack (S = 4, F = 2 and 3)
and the identity frames as (F', B, 1, C, H, W), within 1e-5 of max(1,
max |jax|) in fp32 and 1e-2 in bf16 (the same fp32 statistics summed in
another order; bf16 operands are upcast exactly by both); the code equal to
`encode_route` of the replay's own per-frame losses. The images are 36 x 70
and 2 x 3: the tiles cut them on every side at both plans tried.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jperceiver_tpu.ops.pallas.reproj import reproj_min_pallas
from jperceiver_tpu_torch.ops.cuda.reproj import k1_plan, reproj_min_automask
from jperceiver_tpu_torch.ops.photometric import reprojection_loss

from test_torch_port_reproj_plan import encode_route
from torch_port_helpers import assert_close

_DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
_C1, _C2, _SSIM_W, _L1_W, _EPS, _NINTH = 0.01 ** 2, 0.03 ** 2, 0.85, 0.15, 1e-3, 1.0 / 9.0


def _reflect(idx: torch.Tensor, n: int) -> torch.Tensor:
    idx = idx.abs()
    idx = torch.where(idx >= n, 2 * n - 2 - idx, idx)
    return idx.clamp(0, n - 1)


def _row3(a: torch.Tensor, tw: int) -> torch.Tensor:
    """3-sums along each staged row: columns q, q+1, q+2 for q < tw."""
    return a[..., 0:tw] + a[..., 1:tw + 1] + a[..., 2:tw + 2]


def _col3(a: torch.Tensor, th: int) -> torch.Tensor:
    """Three staged rows' sums added: rows r, r+1, r+2 for r < th."""
    return a[..., 0:th, :] + a[..., 1:th + 1, :] + a[..., 2:th + 2, :]


def replay_k1(preds, ident, targ, plan):
    """K1 block by block: (out (S, B, H, W), code, ident_l (F', B, H, W),
    rl (S, B, F, H, W) the warped frames' losses), in fp32."""
    p, q, t = preds.float(), ident.float(), targ.float()
    s_, b_, f_, c_, h, w = preds.shape
    th, tw = plan.th, plan.tw
    out = torch.full((s_, b_, h, w), float("nan"))
    ident_l = torch.full((q.shape[0], b_, h, w), float("nan"))
    rl = torch.full((s_, b_, f_, h, w), float("nan"))
    for blk in range(plan.blocks):
        b, i0, j0 = plan.tile(blk)
        ri = _reflect(torch.arange(i0 - 1, i0 + th + 1), h)
        ci = _reflect(torch.arange(j0 - 1, j0 + tw + 1), w)
        ys = t[b][:, ri][:, :, ci]  # (C, th + 2, tw + 2)
        mu_y = _col3(_row3(ys, tw), th) * _NINTH
        sig_y = _col3(_row3(ys * ys, tw), th) * _NINTH - mu_y * mu_y
        # The target's statistics as the term takes them: 2 mu_y,
        # mu_y^2 + C1, sigma_y + C2.
        m2, ta, tb = 2 * mu_y, mu_y * mu_y + _C1, sig_y + _C2
        yc = ys[:, 1:th + 1, 1:tw + 1]
        frames = [p[s, b, f] for s in range(s_) for f in range(f_)] + [
            q[k, b] for k in range(q.shape[0])]
        losses = []
        for x in frames:
            xs = x[:, ri][:, :, ci]
            mu_x = _col3(_row3(xs, tw), th) * _NINTH
            sxx = _col3(_row3(xs * xs, tw), th)
            sxy = _col3(_row3(xs * ys, tw), th)
            p2 = mu_x * m2  # 2 mu_x mu_y
            num = (p2 + _C1) * (sxy * (2 * _NINTH) + _C2 - p2)
            den = (mu_x * mu_x + ta) * (sxx * _NINTH + tb - mu_x * mu_x)
            d = yc - xs[:, 1:th + 1, 1:tw + 1]
            term = (_SSIM_W * (0.5 - 0.5 * (num / den)).clamp(0, 1)
                    + _L1_W * torch.sqrt(d * d + _EPS * _EPS))
            acc = torch.zeros(th, tw)
            for c in range(c_):
                acc = acc + term[c]
            losses.append(acc * (1.0 / c_))
        rows, cols = min(th, h - i0), min(tw, w - j0)
        for k, loss in enumerate(losses):
            if k < s_ * f_:
                rl[k // f_, b, k % f_, i0:i0 + rows, j0:j0 + cols] = loss[:rows, :cols]
            else:
                ident_l[k - s_ * f_, b, i0:i0 + rows, j0:j0 + cols] = loss[:rows, :cols]
    best = rl[:, :, 0]
    for f in range(1, f_):
        best = torch.minimum(best, rl[:, :, f])
    out[:] = best
    return out, encode_route(rl), ident_l, rl


def _inputs(b, f, h, w, seed):
    """Warped preds (S = 4) with exact frame ties (frame 1 copies frame 0 on
    the left half, frame 2 on the top half), identity frames (F', B, C, H,
    W) and a target."""
    rng = np.random.default_rng(seed)
    preds = rng.random((4, b, f, 3, h, w)).astype(np.float32)
    preds[:, :, 1, :, :, :w // 2] = preds[:, :, 0, :, :, :w // 2]
    if f > 2:
        preds[:, :, 2, :, :h // 2] = preds[:, :, 0, :, :h // 2]
    ident = rng.random((f, b, 3, h, w)).astype(np.float32)
    targ = rng.random((b, 3, h, w)).astype(np.float32)
    return preds, ident, targ


_PALLAS = {}


def _pallas(b, f, h, w, dtype):
    """The JAX forward on both operand sets, once per case."""
    key = (b, f, h, w, dtype)
    if key not in _PALLAS:
        jdt, _ = _DT[dtype]
        preds, ident, targ = _inputs(b, f, h, w, seed=b + 10 * f + h + w)
        tj = jnp.asarray(targ, jdt)
        warp = reproj_min_pallas(jnp.asarray(preds, jdt), tj, 8)
        idl = reproj_min_pallas(jnp.asarray(ident[:, :, None], jdt), tj, 8)
        _PALLAS[key] = (preds, ident, targ, np.asarray(warp), np.asarray(idl))
    return _PALLAS[key]


def _torch(a, dt):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dt)


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("b,f,h,w,dtype", [(2, 2, 36, 70, "float32"), (1, 3, 36, 70, "float32"),
                                           (1, 3, 36, 70, "bfloat16"), (1, 2, 2, 3, "float32")])
def test_k1_replay_matches_pallas(b, f, h, w, dtype, sms):
    _, tdt = _DT[dtype]
    preds, ident, targ, want, want_ident = _pallas(b, f, h, w, dtype)
    pt, it, tt = _torch(preds, tdt), _torch(ident, tdt), _torch(targ, tdt)
    plan = k1_plan(b, h, w, sms)
    assert plan.th == (32 if sms == 1 and h > 2 else 8)
    out, code, ident_l, rl = replay_k1(pt, it, tt, plan)
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert_close(out.numpy(), want, tol, "warped")
    assert_close(ident_l.numpy(), want_ident, tol, "identity")
    # Every link of the chain is coded; frame 1 ties frame 0 wherever their
    # windows are equal (the left half but its last column).
    assert int(code.max()) < 2 ** (2 * (f - 1))
    assert bool(((code & 3) == 2)[..., : w // 2 - 1].all())
    # The code's per-frame losses are the plain version's, frame by frame.
    plain_rl = reprojection_loss(pt.float(), tt.float()[:, None])[:, :, :, 0]
    assert_close(rl.numpy(), plain_rl.numpy(), 1e-5, "per-frame losses")
    # And the entry's CPU path (the plain versions) gives both outputs.
    got, got_ident = reproj_min_automask(pt, it, tt)
    assert_close(got.numpy(), want, tol, "entry warped")
    assert_close(got_ident.numpy(), want_ident, tol, "entry identity")


def test_k1_plan_at_the_flagship():
    """1024^2, B = 1, 132 SMs: 32-row tiles (a halo of 34/32 rows), 1,024
    blocks of 256 threads, every pixel in exactly one block, and the block's
    shared memory (two staged frames in bf16 and fp32, the target in fp32)
    well below a quarter of the SM's."""
    plan = k1_plan(1, 1024, 1024, 132)
    assert (plan.th, plan.tw, plan.threads, plan.blocks) == (32, 32, 256, 1024)
    seen = torch.zeros(1024, 1024, dtype=torch.int32)
    for blk in range(plan.blocks):
        b, i0, j0 = plan.tile(blk)
        assert b == 0
        seen[i0:i0 + plan.th, j0:j0 + plan.tw] += 1
    assert torch.equal(seen, torch.ones_like(seen))
    for item in (2, 4):
        a = 16 // item
        smem = 2 * 3 * (plan.th + 2) * (2 * a + plan.tw) * item + 3 * (plan.th + 2) * (plan.tw + 2) * 4
        assert smem <= 228 * 1024 // 4
