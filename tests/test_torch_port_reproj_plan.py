"""The reprojection backward's algorithm (K2 with K1's routing code)
replayed on the CPU, against the JAX package.

On the card K1 writes, for each (s, b, pixel), two bits a link of the
frame-min chain best_f = min(best_{f-1}, rl_f): rl_f greater than (0),
less than (1) or equal to (2) best_{f-1}. K2 decodes them into each frame's
share of the cotangent, as `jnp.minimum`'s backward splits it, and runs one
block per (s, b, frame) and 32 x 32 tile: it stages the 36 x 36 reflect-
padded pixels, computes the window statistics once at each of the 34 x 34
stat pixels that carry weight -- the means from three-column sums, the
second moments around the means -- and the cotangents P1, P2, P3 of the
mean, variance and covariance with one reciprocal of den, then gathers onto
each pixel the terms P1 + P2 (x - mu_x) + P3 (y - mu_y) of the windows that
hold it, a reflect-ring copy counted as a multiplicity of the stat pixel's
term, plus its Charbonnier term. Here the same steps run tile by tile with
plain tensor slicing, in fp32, and the gradient is held to `jax.vjp` of
`reproj_min_pallas` (its Pallas kernels and ring fix-ups in interpret mode)
to 1e-5 of max(1, max |jax|) in fp32 (the same function with the
statistics rounded differently) and 1e-2 in bf16 (one bf16 rounding of each
gradient). The JAX side runs once per (F, size, dtype) at B = 3; B = 1, 2
and 3 take the first B batch elements (they are independent).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jperceiver_tpu.ops.pallas.reproj import reproj_min_pallas
from jperceiver_tpu_torch.ops.cuda.reproj import _reproj_bwd_plain
from jperceiver_tpu_torch.ops.photometric import reprojection_loss

from torch_port_helpers import assert_close

_DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
_BT = 32  # K2's output tile
_C1, _C2, _SSIM_W, _L1_W, _EPS = 0.01 ** 2, 0.03 ** 2, 0.85, 0.15, 1e-3


def encode_route(rl: torch.Tensor) -> torch.Tensor:
    """K1's routing code of per-frame losses rl (S, B, F, H, W)."""
    best = rl[:, :, 0]
    code = torch.zeros(best.shape, dtype=torch.int32)
    for f in range(1, rl.shape[2]):
        o = torch.where(rl[:, :, f] < best, 1, torch.where(rl[:, :, f] == best, 2, 0))
        code |= o << (2 * (f - 1))
        best = torch.minimum(best, rl[:, :, f])
    return code


def decode_route(code: torch.Tensor, cot: torch.Tensor, n_frames: int) -> torch.Tensor:
    """K2's frame weights (S, B, F, H, W): the cotangent routed back down
    the chain, a tie halving it."""
    a = cot.clone()
    w = [None] * n_frames
    for k in range(n_frames - 1, 0, -1):
        o = (code >> (2 * (k - 1))) & 3
        w[k] = torch.where(o == 1, a, torch.where(o == 2, 0.5 * a, 0.0))
        a = torch.where(o == 1, 0.0, torch.where(o == 2, 0.5 * a, a))
    w[0] = a
    return torch.stack(w, 2)


def _reflect(idx: torch.Tensor, n: int) -> torch.Tensor:
    idx = idx.abs()
    idx = torch.where(idx >= n, 2 * n - 2 - idx, idx)
    return idx.clamp(0, n - 1)


def _mult(i: torch.Tensor, p: torch.Tensor, n: int) -> torch.Tensor:
    """Copies of image row i in the window of stat row p (|p - i| <= 1)."""
    return 1.0 + ((i == 1) & (p == 0)).float() + ((i == n - 2) & (p == n - 1)).float()


def replay_k2_frame(x: torch.Tensor, y: torch.Tensor, wgt: torch.Tensor) -> torch.Tensor:
    """K2 for one (s, b, frame): x, y (C, H, W) fp32, wgt (H, W) the frame's
    weight / C. Returns d/dx (C, H, W) fp32, tile by tile."""
    c, h, w = x.shape
    out = torch.zeros(c, h, w)
    e = _BT + 2
    for i0 in range(0, h, _BT):
        for j0 in range(0, w, _BT):
            ri = _reflect(torch.arange(i0 - 2, i0 + _BT + 2), h)
            ci = _reflect(torch.arange(j0 - 2, j0 + _BT + 2), w)
            xs, ys = x[:, ri][:, :, ci], y[:, ri][:, :, ci]  # staged (C, 36, 36)
            pi = torch.arange(i0 - 1, i0 + _BT + 1)[:, None]
            pj = torch.arange(j0 - 1, j0 + _BT + 1)[None, :]
            inside = (pi >= 0) & (pi < h) & (pj >= 0) & (pj < w)
            wt = torch.where(inside, wgt[pi.clamp(0, h - 1), pj.clamp(0, w - 1)], 0.0)
            if not bool((wt != 0).any()):
                continue  # the kernel writes zeros and stops
            xw = [[xs[:, a:a + e, q:q + e] for q in range(3)] for a in range(3)]
            yw = [[ys[:, a:a + e, q:q + e] for q in range(3)] for a in range(3)]
            sx = [xw[a][0] + xw[a][1] + xw[a][2] for a in range(3)]
            sy = [yw[a][0] + yw[a][1] + yw[a][2] for a in range(3)]
            mx = (sx[0] + sx[1] + sx[2]) * (1.0 / 9.0)
            my = (sy[0] + sy[1] + sy[2]) * (1.0 / 9.0)
            sxx = syy = sxy = 0.0
            for a in range(3):
                for q in range(3):
                    dx, dy = xw[a][q] - mx, yw[a][q] - my
                    sxx, syy, sxy = sxx + dx * dx, syy + dy * dy, sxy + dx * dy
            am = 2 * mx * my + _C1
            bn = 2 * (sxy * (1.0 / 9.0)) + _C2
            d_ = mx * mx + my * my + _C1
            e_ = (sxx + syy) * (1.0 / 9.0) + _C2
            num, den = am * bn, d_ * e_
            kclip = torch.where((num < den) & (num > -den), 1.0,
                                torch.where((num == den) | (num == -den), 0.5, 0.0))
            gq = -0.5 * _SSIM_W * wt * kclip
            inv = 1.0 / den
            t = -gq * (num * inv) * inv
            g_a, g_b, g_d, g_e = gq * bn * inv, gq * am * inv, t * e_, t * d_
            live = wt != 0
            p1 = torch.where(live, (2 * my * g_a + 2 * mx * g_d) * (1.0 / 9.0), 0.0)
            p2 = torch.where(live, 2 * g_e * (1.0 / 9.0), 0.0)
            p3 = torch.where(live, 2 * g_b * (1.0 / 9.0), 0.0)
            mx, my = torch.where(live, mx, 0.0), torch.where(live, my, 0.0)
            # Gather onto the tile's pixels, stat rows then columns in order.
            ti = torch.arange(i0, i0 + _BT)[:, None]
            tj = torch.arange(j0, j0 + _BT)[None, :]
            xq, yq = xs[:, 2:2 + _BT, 2:2 + _BT], ys[:, 2:2 + _BT, 2:2 + _BT]
            acc = torch.zeros(c, _BT, _BT)
            for s in range(3):
                mr = _mult(ti, ti - 1 + s, h)
                for q in range(3):
                    m = mr * _mult(tj, tj - 1 + q, w)
                    sl = (slice(None), slice(s, s + _BT), slice(q, q + _BT))
                    acc = acc + m * (p1[sl] + p2[sl] * (xq - mx[sl]) + p3[sl] * (yq - my[sl]))
            d = yq - xq
            acc = acc - _L1_W * wt[1:1 + _BT, 1:1 + _BT] * d * torch.rsqrt(d * d + _EPS * _EPS)
            rows, cols = min(_BT, h - i0), min(_BT, w - j0)
            out[:, i0:i0 + rows, j0:j0 + cols] = acc[:, :rows, :cols]
    return out


def replay_k2(preds: torch.Tensor, targ: torch.Tensor, cot: torch.Tensor) -> torch.Tensor:
    """The preds' gradient as K1's code and K2 compute it, in the preds'
    dtype. K1's per-frame losses are the plain version's here."""
    p, t = preds.float(), targ.float()
    s_, b_, f_, c_, _, _ = preds.shape
    rl = reprojection_loss(p, t[:, None])[:, :, :, 0]
    wts = decode_route(encode_route(rl), cot.float(), f_) * (1.0 / c_)
    grad = torch.empty(p.shape)
    for s in range(s_):
        for b in range(b_):
            for f in range(f_):
                grad[s, b, f] = replay_k2_frame(p[s, b, f], t[b], wts[s, b, f])
    return grad.to(preds.dtype)


def _inputs(b, f, h, w, seed):
    """Preds with exact frame ties: frame 1 copies frame 0 on the left half,
    frame 2 copies frame 0 on the top half (three-way ties where both)."""
    rng = np.random.default_rng(seed)
    preds = rng.random((2, b, f, 3, h, w)).astype(np.float32)
    if f > 1:
        preds[:, :, 1, :, :, :w // 2] = preds[:, :, 0, :, :, :w // 2]
    if f > 2:
        preds[:, :, 2, :, :h // 2] = preds[:, :, 0, :, :h // 2]
    targ = rng.random((b, 3, h, w)).astype(np.float32)
    cot = rng.standard_normal((2, b, h, w)).astype(np.float32)
    return preds, targ, cot


_PALLAS = {}


def _pallas_b3(f, h, w, dtype):
    """The JAX VJP at B = 3, once per (F, size, dtype)."""
    key = (f, h, w, dtype)
    if key not in _PALLAS:
        jdt, _ = _DT[dtype]
        preds, targ, cot = _inputs(3, f, h, w, seed=f * 100 + h + w)
        tj = jnp.asarray(targ, jdt)
        _, vjp = jax.vjp(lambda p: reproj_min_pallas(p, tj, 8), jnp.asarray(preds, jdt))
        (want,) = vjp(jnp.asarray(cot))
        _PALLAS[key] = (preds, targ, cot, np.asarray(want, np.float32))
    return _PALLAS[key]


def _torch(a, dt):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dt)


# (F, H, W, dtype), each at B = 1, 2, 3: 36 x 40 cuts the 32 x 32 tiles on
# both axes; H or W of 2 and 3 make every pixel a ring pixel.
_CASES = [(f, 36, 40, "float32") for f in (1, 2, 3)] + [
    (2, 2, 3, "float32"), (3, 3, 2, "float32"), (3, 36, 40, "bfloat16")]


@pytest.mark.parametrize("b", [1, 2, 3])
@pytest.mark.parametrize("f,h,w,dtype", _CASES)
def test_k2_replay_matches_pallas_vjp(f, h, w, dtype, b):
    _, tdt = _DT[dtype]
    preds, targ, cot, want = _pallas_b3(f, h, w, dtype)
    preds, targ, cot, want = preds[:, :b], targ[:b], cot[:, :b], want[:, :b]
    got = replay_k2(_torch(preds, tdt), _torch(targ, tdt), _torch(cot, torch.float32))
    assert got.dtype == tdt
    assert_close(got.float().numpy(), want, 1e-5 if dtype == "float32" else 1e-2, "grad")


@pytest.mark.parametrize("f", [2, 3])
def test_routing_code_splits_like_the_minimum_chain(f):
    """Encoded and decoded, the code gives each frame what autograd of the
    `torch.minimum` chain gives it, ties (exact, two- and three-way) too."""
    rng = np.random.default_rng(f)
    rl = torch.from_numpy(np.round(4 * rng.random((2, 2, f, 9, 11))).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((2, 2, 9, 11)).astype(np.float32))
    r = rl.clone().requires_grad_()
    best = r[:, :, 0]
    for k in range(1, f):
        best = torch.minimum(best, r[:, :, k])
    best.backward(cot)
    code = encode_route(rl)
    assert int(code.max()) < 2 ** (2 * (f - 1))
    assert torch.equal(decode_route(code, cot, f), r.grad)


def test_centred_statistics_no_farther_from_float64():
    """On flat, border-clamped windows (a frame's right part held at one
    value, as grid_sample's border padding does) the replay's fp32 gradient
    is no farther from the float64 one than the plain fp32 autograd's, the
    repair of summing around each window's mean."""
    rng = np.random.default_rng(5)
    preds = rng.random((1, 1, 2, 3, 40, 44)).astype(np.float32)
    preds[..., 20:] = preds[..., 19:20] + 1e-3 * rng.random((1, 1, 2, 3, 40, 24)).astype(np.float32)
    targ = rng.random((1, 3, 40, 44)).astype(np.float32)
    cot = rng.standard_normal((1, 1, 40, 44)).astype(np.float32)
    p, t, g = (torch.from_numpy(a) for a in (preds, targ, cot))
    g64 = _reproj_bwd_plain(p.double(), t.double(), g.double())
    err_replay = (replay_k2(p, t, g).double() - g64).abs().max().item()
    err_plain = (_reproj_bwd_plain(p, t, g).double() - g64).abs().max().item()
    assert err_replay <= err_plain, (err_replay, err_plain)
