"""The CRP pool's kernels (K5 forward and `maxpool5x5_bwd`) replayed on the
CPU, block by block as `k5_plan` has them, and the stem pool's backward
kernel (`maxpool3x3s2_bwd`) by its window walk, against the JAX package.

On the card a block of the forward stages a (th+4) x (tw+4) tile of
channel vectors with -inf outside the image, takes the 5-max along W of
each staged row and the 5-max along H of five of those. A block of the
backward stages x (th rows x tw+8 columns, -inf outside), y and g
((th+4) x (tw+4), -inf and 0 outside); phase A recomputes r = the W-max
and routes g down each column into dr, writing r and dr over the first th
staged rows of y and g; phase B routes dr along W onto x. Each route adds
in window order in the operand dtype. Here each staged tile is cut out of
the tensor with plain slicing and the same steps run on it, so an index
error in the plan or in the staging offsets shows up before any card runs
it. The results must equal JAX's `max_pool_5x5_s1` and its `_mp_bwd` bit
for bit, in fp32 and bf16, on inputs with ties (quarter steps through a
ReLU), at shapes whose tiles cut the image on every side.

A thread of the stem pool's backward owns one input pixel and channel
vector: an input row (column) of even index lies in window i / 2 only, an
odd one in windows (i - 1) / 2 and (i + 1) / 2, the latter where it exists;
the thread adds where(x == y[window], g[window], 0) over those windows, row
window then column window, ascending, in the dtype. Here the four parity
classes of (i, j) run as strided slices. The result must equal JAX's
`max_pool_3x3_s2` VJP (`_mp3_bwd`, nine compares over the dilated grid) and
the port's plain backward bit for bit, in fp32 and bf16, with ties, at even
and odd sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jperceiver_tpu.ops.pallas.maxpool import max_pool_3x3_s2, max_pool_5x5_s1
from jperceiver_tpu_torch.ops.cuda.maxpool import (k5_plan, maxpool3x3s2_bwd_plain,
                                                   maxpool5x5_bwd_plain)

_DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
_NEG = float("-inf")


def _stage(t, r0, nr, c0, nc, ch0, ch1, fill):
    """Rows r0.. (nr), columns c0.. (nc), channels ch0:ch1 of t (H, W, C),
    `fill` outside the image."""
    h, w, _ = t.shape
    out = torch.full((nr, nc, ch1 - ch0), fill, dtype=t.dtype)
    ylo, yhi, xlo, xhi = max(r0, 0), min(r0 + nr, h), max(c0, 0), min(c0 + nc, w)
    if ylo < yhi and xlo < xhi:
        out[ylo - r0:yhi - r0, xlo - c0:xhi - c0] = t[ylo:yhi, xlo:xhi, ch0:ch1]
    return out


def _route(a, m, g):
    """sum over d = 0..4 of where(a == m[d], g[d], 0), m[d] and g[d] the
    window's d-th neighbours, added in the dtype in window order."""
    acc = torch.zeros_like(a)
    for d in range(5):
        acc = acc + torch.where(a == m[d], g[d], 0)
    return acc


def _blocks(plan):
    for blk in range(plan.blocks):
        b, i0, j0, v0 = plan.tile(blk)
        yield b, i0, j0, v0 * plan.vec, min((v0 + plan.cb) * plan.vec, plan.cv * plan.vec)


def replay_fwd(x, plan):
    th, tw = plan.th, plan.tw
    y = torch.full_like(x, float("nan"))
    _, h, w, _ = x.shape
    for b, i0, j0, ch0, ch1 in _blocks(plan):
        xs = _stage(x[b], i0 - 2, th + 4, j0 - 2, tw + 4, ch0, ch1, _NEG)
        wmax = xs[:, 0:tw]
        for d in range(1, 5):
            wmax = torch.maximum(wmax, xs[:, d:d + tw])
        out = wmax[0:th]
        for d in range(1, 5):
            out = torch.maximum(out, wmax[d:d + th])
        rows, cols = min(th, h - i0), min(tw, w - j0)
        y[b, i0:i0 + rows, j0:j0 + cols, ch0:ch1] = out[:rows, :cols]
    return y


def replay_bwd(x, y, g, plan):
    th, tw = plan.th, plan.tw
    dx = torch.full_like(x, float("nan"))
    _, h, w, _ = x.shape
    for b, i0, j0, ch0, ch1 in _blocks(plan):
        xs = _stage(x[b], i0, th, j0 - 4, tw + 8, ch0, ch1, _NEG)
        ys = _stage(y[b], i0 - 2, th + 4, j0 - 2, tw + 4, ch0, ch1, _NEG)
        gs = _stage(g[b], i0 - 2, th + 4, j0 - 2, tw + 4, ch0, ch1, 0.0)
        # Phase A, columns j0-2 .. j0+tw+1: r from x, dr routed down each column.
        r = xs[:, 0:tw + 4]
        for d in range(1, 5):
            r = torch.maximum(r, xs[:, d:d + tw + 4])
        dr = _route(r, [ys[d:d + th] for d in range(5)], [gs[d:d + th] for d in range(5)])
        ys[:th], gs[:th] = r, dr  # written over the staged rows the column has passed
        # Phase B, columns j0 .. j0+tw-1: dr routed along W onto x.
        out = _route(xs[:, 4:4 + tw], [ys[:th, d:d + tw] for d in range(5)],
                     [gs[:th, d:d + tw] for d in range(5)])
        rows, cols = min(th, h - i0), min(tw, w - j0)
        dx[b, i0:i0 + rows, j0:j0 + cols, ch0:ch1] = out[:rows, :cols]
    return dx


# (B, H, W, C): tiles cut on every side. C = 13 runs one channel a vector;
# 24, 64 and 256 run 16-byte vectors (24 in fp32: six vectors, a partial
# second channel tile).
_SHAPES = [(2, 17, 30, 13), (1, 9, 35, 256), (2, 21, 40, 24), (1, 5, 6, 64)]


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,w,c", _SHAPES)
def test_pool_plan_replay_matches_jax(b, h, w, c, dtype, sms):
    jdt, tdt = _DT[dtype]
    rng = np.random.default_rng(h * w + c)
    x = np.maximum(np.round(4 * rng.standard_normal((b, h, w, c))) / 4, 0).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    want_y, vjp = jax.vjp(max_pool_5x5_s1, jnp.asarray(x, jdt))
    (want_dx,) = vjp(jnp.asarray(g, jdt))
    xt, gt = torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt)
    item = xt.element_size()
    fwd, bwd = (k5_plan(b, h, w, c, item, sms, backward) for backward in (False, True))
    y = replay_fwd(xt, fwd)
    dx = replay_bwd(xt, y, gt, bwd)
    np.testing.assert_array_equal(y.float().numpy(), np.asarray(want_y, np.float32))
    np.testing.assert_array_equal(dx.float().numpy(), np.asarray(want_dx, np.float32))
    # And the port's plain backward, which the card holds the kernel to.
    nchw = (0, 3, 1, 2)
    plain = maxpool5x5_bwd_plain(xt.permute(nchw), y.permute(nchw), gt.permute(nchw))
    assert torch.equal(plain.permute(0, 2, 3, 1), dx)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("s", [32, 64, 128, 256])
def test_pool_plan_at_the_crp_shapes(s, backward):
    """The four CRP pools of the 1024^2 step (256 channels, bf16, 132 SMs):
    16-byte vectors, every output pixel and vector in exactly one block,
    and the grid at least 4 blocks a SM (or one row a block)."""
    plan = k5_plan(1, s, s, 256, 2, 132, backward)
    assert (plan.vec, plan.cv, plan.cb, plan.tw) == (8, 32, 4, 32)
    assert plan.blocks >= 4 * 132 or plan.th == 1
    assert plan.th <= (8 if backward else 16)
    seen = torch.zeros(s, s, plan.cv, dtype=torch.int32)
    for blk in range(plan.blocks):
        b, i0, j0, v0 = plan.tile(blk)
        assert b == 0
        seen[i0:i0 + plan.th, j0:j0 + plan.tw, v0:v0 + plan.cb] += 1
    assert torch.equal(seen, torch.ones_like(seen))
    # Shared memory a block: the forward's staged tile, the backward's x, y, g.
    vb = 16
    smem = ((plan.th + 4) * (plan.tw + 4) * plan.cb * vb if not backward else
            (plan.th * (plan.tw + 8) + 2 * (plan.th + 4) * (plan.tw + 4)) * plan.cb * vb)
    assert smem <= 227 * 1024 // 2


def replay_stem_bwd(x, y, g):
    """`maxpool3x3s2_bwd`'s walk on (B, H, W, C) tensors, one parity class
    of (row, column) at a time. A window index past the last output is
    skipped by the kernel; here it reads -inf (y) and 0 (g), a zero term."""
    b, h, w, c = x.shape
    ho, wo = y.shape[1], y.shape[2]
    yp = torch.full((b, ho + 1, wo + 1, c), _NEG, dtype=y.dtype)
    gp = torch.zeros((b, ho + 1, wo + 1, c), dtype=g.dtype)
    yp[:, :ho, :wo], gp[:, :ho, :wo] = y, g
    dx = torch.full_like(x, float("nan"))
    for pi in (0, 1):
        for pj in (0, 1):
            xs = x[:, pi::2, pj::2]  # rows 2a + pi, columns 2e + pj
            n, m = xs.shape[1], xs.shape[2]
            acc = torch.zeros_like(xs)
            for dr in range(pi + 1):  # windows a (and a + 1 for odd rows)
                for dc in range(pj + 1):
                    win = (slice(None), slice(dr, dr + n), slice(dc, dc + m))
                    acc = acc + torch.where(xs == yp[win], gp[win], 0)
            dx[:, pi::2, pj::2] = acc
    return dx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,w,c", [(2, 16, 20, 8), (1, 17, 23, 13), (2, 9, 6, 64),
                                     (1, 24, 15, 16)])
def test_stem_pool_backward_replay_matches_jax(b, h, w, c, dtype):
    jdt, tdt = _DT[dtype]
    rng = np.random.default_rng(h * w + c)
    x = np.maximum(np.round(4 * rng.standard_normal((b, h, w, c))) / 4, 0).astype(np.float32)
    want_y, vjp = jax.vjp(max_pool_3x3_s2, jnp.asarray(x, jdt))
    g = rng.standard_normal(want_y.shape).astype(np.float32)
    (want_dx,) = vjp(jnp.asarray(g, jdt))
    xt, gt = torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt)
    y = torch.from_numpy(np.array(want_y, np.float32)).to(tdt)
    dx = replay_stem_bwd(xt, y, gt)
    np.testing.assert_array_equal(dx.float().numpy(), np.asarray(want_dx, np.float32))
    nchw = (0, 3, 1, 2)
    plain = maxpool3x3s2_bwd_plain(xt.permute(nchw), y.permute(nchw), gt.permute(nchw))
    assert torch.equal(plain.permute(0, 2, 3, 1), dx)
