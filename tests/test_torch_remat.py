"""`JPerceiver(remat=...)`: the trunks that the JAX module wraps in
`nn.remat` are checkpointed (`torch.utils.checkpoint`, non-reentrant) and
recomputed in the backward. On the CPU in float64 at 128^2 (the smallest
input the layout encoder takes: it reduces the input 128x), one training
forward, a loss that weighs every output by fixed random weights, and its
backward, with remat off, "all", "enc" and "dec" give:
- the same loss and gradients, each gradient within 1e-12 of its own scale;
- the same BatchNorm running statistics (a recompute updates none);
- the same dropout masks, drawn twice a step whatever the mode (the depth
  decoder draws them before its checkpoint);
- a recompute that enters every 3x3 conv and CRP block of the checkpointed
  trunks, and nothing else: on the card each such conv launches K3 and
  each CRP block K5 once more in the backward. (The recompute stops after
  the last tensor the backward needs, checkpoint's early stop, so the last
  conv of a layout decoder is entered but not left; K3 launches before it
  saves its inputs, so it launches there too.)
"""

import numpy as np
import pytest
import torch

import jperceiver_tpu_torch.models.depth_net as depth_net
from jperceiver_tpu_torch.data import synthetic_batch
from jperceiver_tpu_torch.engine.trainer import batch_to
from jperceiver_tpu_torch.models import JPerceiver
from jperceiver_tpu_torch.models.common import Conv3x3, CRPBlock

H = W = 128
OCC = 32
TRUNKS = {False: set(),
          "enc": {"DepthEncoder", "PoseEncoder", "LayoutEncoder"},
          "dec": {"DepthDecoder", "LayoutDecoder", "LayoutTransformDecoder"}}
TRUNKS["all"] = TRUNKS["enc"] | TRUNKS["dec"]


def _run(remat, monkeypatch):
    torch.manual_seed(0)
    model = JPerceiver(height=H, width=W, occ_map_size=OCC, branches="road", remat=remat,
                       dtype=torch.float64).double()
    calls = {}
    for name, mod in model.named_modules():
        if isinstance(mod, (Conv3x3, CRPBlock)):
            trunk = name.split(".")[0]
            mod.register_forward_pre_hook(
                lambda *a, key=(trunk, type(mod).__name__): calls.__setitem__(
                    key, calls.get(key, 0) + 1))
    masks = []

    def recording_dropout(x, rate, generator):
        y = real_dropout(x, rate, generator)
        masks.append((y == 0).clone())
        return y

    real_dropout = depth_net.dropout
    monkeypatch.setattr(depth_net, "dropout", recording_dropout)
    batch = batch_to(synthetic_batch(1, H, W, OCC, seed=1, dtype=np.float64), "cpu")
    gen = torch.Generator().manual_seed(2)
    out = model(batch, train=True, generator=gen)
    wgen = torch.Generator().manual_seed(3)
    loss = sum((v * torch.randn(v.shape, generator=wgen, dtype=v.dtype)).sum()
               for _, v in sorted(out.items()))
    forward_calls = dict(calls)
    loss.backward()
    monkeypatch.undo()
    return {"loss": loss.item(), "masks": masks, "forward": forward_calls,
            "recomputed": {k: v - forward_calls[k] for k, v in calls.items()},
            "grads": {n: p.grad for n, p in model.named_parameters()},
            "stats": {n: b.clone() for n, b in model.named_buffers()}}


def test_remat_modes_match_no_remat(monkeypatch):
    ref = _run(False, monkeypatch)
    assert len(ref["masks"]) == 2 and not any(ref["recomputed"].values())
    big = max(float(g.abs().max()) for g in ref["grads"].values())
    for mode in ("all", "enc", "dec"):
        got = _run(mode, monkeypatch)
        assert got["loss"] == pytest.approx(ref["loss"], rel=1e-12, abs=0)
        for n, g in ref["grads"].items():
            scale = max(float(g.abs().max()), 1e-12 * big)
            assert float((got["grads"][n] - g).abs().max()) <= 1e-12 * scale, (mode, n)
        for n, b in ref["stats"].items():
            assert torch.equal(got["stats"][n], b), (mode, n)
        assert len(got["masks"]) == 2
        for a, b in zip(got["masks"], ref["masks"]):
            assert torch.equal(a, b), mode
        assert got["forward"] == ref["forward"]
        want = {k: (v if k[0] in TRUNKS[mode] else 0) for k, v in ref["forward"].items()}
        assert got["recomputed"] == want, mode
