#!/usr/bin/env python3
"""Where the fp32 training step's gradients leave float64, route by route.

    python3 chip_grad_routes.py

Runs the 1024^2 flagship step of `chip_smoke.py` (same weights, batch and
seed) once in float64 with every kernel off, and in fp32 with the kernels
routed five ways: none ("off"), K1/K2 only ("reproj"), K3/K4 at the
encoders' sites only ("enc"), K3/K4 at the depth decoder's sites and K5
("dec"), and all of them ("on"). For each route it records:

  * every parameter's gradient distance to float64, beside its scale;
  * the routing of every equality-mask max-pool (the 16 CRP pools and the
    stem pools): how many of the masks' entries (input == window max)
    differ from the float64 run's;
  * for the "on" route, the data-grad of the 513-channel iconv3 site on the
    step's own operands, by K3, by cuDNN in fp32 and in float64; and K2 and
    its plain version on the step's own reprojection operands against the
    float64 autograd gradient.

Writes chiprun_out/grad_routes.json and prints a summary. Needs one CUDA
device and a checkout of the repo.
"""

from __future__ import annotations

import copy
import json
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
ROUTES = (("f64", False, False, False), ("off", False, False, False),
          ("reproj", True, False, False), ("enc", False, True, False),
          ("dec", False, False, True), ("on", True, True, True))


def pool_masks(torch, kind, x):
    """The masks the equality-mask backward routes by: for the separable 5x5
    pool, input == row max and row max == window max at each of 5 offsets;
    for the 3x3/2 stem pool, input == window max at each of 9 offsets."""
    F = torch.nn.functional
    h, w = x.shape[2], x.shape[3]
    out = []
    if kind == "p5":
        xp = F.pad(x, (2, 2, 0, 0), value=float("-inf"))
        r = torch.stack([xp[..., k:k + w] for k in range(5)]).amax(0)
        rp = F.pad(r, (0, 0, 2, 2), value=float("-inf"))
        y = torch.stack([rp[..., k:k + h, :] for k in range(5)]).amax(0)
        for k in range(5):
            out += [xp[..., k:k + w] == r, rp[..., k:k + h, :] == y]
    else:
        y = F.max_pool2d(x, 3, 2, 1)
        yd = torch.full((x.shape[0], x.shape[1], h + 2, w + 2), float("-inf"),
                        dtype=x.dtype, device=x.device)
        yd[:, :, 1:2 * y.shape[2]:2, 1:2 * y.shape[3]:2] = y
        out = [x == yd[:, :, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_grad_routes: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as cs
        import jperceiver_tpu_torch.models.common as common
        import jperceiver_tpu_torch.models.resnet as resnet
        from jperceiver_tpu_torch.data import synthetic_batch
        from jperceiver_tpu_torch.engine import make_train_step
        from jperceiver_tpu_torch.engine.trainer import batch_to
        from jperceiver_tpu_torch.losses import multitask
        from jperceiver_tpu_torch.models.common import Conv3x3
        from jperceiver_tpu_torch.ops.cuda import reproj as rp
        from jperceiver_tpu_torch.ops.cuda.conv3x3 import _conv
    except ImportError as exc:
        print(f"chip_grad_routes: run from a checkout of the repo ({exc})", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    pools, caps = [], {}
    mp5, mp3 = common.maxpool5x5, resnet.maxpool3x3s2
    rmin, rmin_am = multitask.reproj_min, multitask.reproj_min_automask

    def rec5(x, use_kernel=True):
        pools.append(("p5", x.detach().clone()))
        return mp5(x, use_kernel)

    def rec3(x, use_kernel=True):
        pools.append(("p3", x.detach().clone()))
        return mp3(x, use_kernel)

    def capture(preds, targ, out):
        if preds.requires_grad and "preds" not in caps:
            caps.update(preds=preds.detach().clone(), targ=targ.detach().clone())
            out.register_hook(lambda g: caps.__setitem__("cot", g.detach().clone()))
        return out

    def rec_reproj(preds, targ):
        return capture(preds, targ, rmin(preds, targ))

    def rec_reproj_am(preds, ident, targ):
        out, ident_l = rmin_am(preds, ident, targ)
        return capture(preds, targ, out), ident_l

    common.maxpool5x5, resnet.maxpool3x3s2 = rec5, rec3
    multitask.reproj_min, multitask.reproj_min_automask = rec_reproj, rec_reproj_am

    batch = batch_to(synthetic_batch(1, cs.HW, cs.HW, cs.OCC, seed=0), "cuda")
    model32 = cs.build_model(torch, torch.float32, "road")
    init = copy.deepcopy(model32.state_dict())
    grads, flips, ref_masks, iconv3 = {}, {}, None, {}
    for name, reproj_on, enc_on, dec_on in ROUTES:
        pools.clear()
        if name == "f64":
            model = cs.build_model(torch, torch.float64, "road").double()
            run_batch = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
        else:
            model, run_batch = model32, batch
        model.load_state_dict(init)
        step = make_train_step(model, dict(cs.TRAIN_CFG, use_pallas_reproj=reproj_on,
                                           pallas_reproj_bf16=False), seed=0,
                               steps_per_epoch=cs.STEPS_PER_EPOCH)
        for mname, m in model.named_modules():
            if isinstance(m, Conv3x3):
                m.gate_shallow = m.gate_deep = dec_on if mname.startswith("DepthDecoder") else enc_on
            elif isinstance(m, common.CRPBlock):
                m.use_kernel = dec_on
        site = model.DepthDecoder.iconv3.conv
        record = iconv3.setdefault(name, {})

        def keep_operands(mod, args, out, record=record):
            record["x"] = args[0].detach().clone()
            out.register_hook(lambda g: record.__setitem__("gy", g.detach().clone()))

        hook = site.register_forward_hook(keep_operands)
        step(run_batch)
        hook.remove()
        grads[name] = {n: p.grad.detach().double().clone() for n, p in model.named_parameters()}
        if name == "f64":
            ref_masks = [pool_masks(torch, kind, x) for kind, x in pools]
            flips["pools"] = [[kind] + list(x.shape) for kind, x in pools]
        else:
            flips[name] = [int(sum((a != b).sum().item() for a, b in
                                   zip(pool_masks(torch, kind, x), masks)))
                           for (kind, x), masks in zip(pools, ref_masks)]
        record["w"] = site.weight.detach().clone()
        del step
        print(f"route {name} done", file=sys.stderr, flush=True)

    ref = grads["f64"]
    params = []
    for n, g64 in ref.items():
        row = {"name": n, "scale": g64.abs().max().item()}
        for name, *_ in ROUTES[1:]:
            row[name] = (grads[name][n] - g64).abs().max().item()
        params.append(row)
    params.sort(key=lambda r: -r["on"] / (3 * r["off"] + 1e-3 * r["scale"]))

    # iconv3's data-grad on the "on" route's own operands.
    x, gy, w = (iconv3["on"][k] for k in ("x", "gy", "w"))
    gy = gy.contiguous(memory_format=torch.channels_last)
    d64 = torch.nn.grad.conv2d_input(x.shape, w.double(), gy.double(), padding=0)
    dk = _conv(gy, w.flip(2, 3).transpose(0, 1), None, 2, "conv3x3_dgrad").double()
    dc = torch.nn.grad.conv2d_input(x.shape, w, gy, padding=0).double()
    dgrad = {"shape": list(x.shape), "ref_max": d64.abs().max().item(),
             "k3_err": (dk - d64).abs().max().item(), "cudnn_err": (dc - d64).abs().max().item()}

    # K2 and its plain version on the step's own reprojection operands.
    preds, targ, cot = caps["preds"], caps["targ"], caps["cot"]
    _, code, _ = rp._fwd(preds, targ, route=True)
    d, dref = rp._bwd(preds, targ, cot, code), rp._reproj_bwd_plain(preds, targ, cot)
    k2 = cs._k2_f64_witness(torch, preds, targ, cot, d, dref)
    k2["shape"], k2["dtype"] = list(preds.shape), str(preds.dtype)

    res = {"params": params, "pool_flips": flips, "iconv3_dgrad": dgrad, "k2_step_operands": k2}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "grad_routes.json"), "w") as f:
        json.dump(res, f, indent=1)
    summary = {"worst_params": params[:6], "iconv3_dgrad": dgrad, "k2_step_operands": k2,
               "pool_flips_total": {k: sum(v) for k, v in flips.items() if k != "pools"},
               "crp4_pool_flips": {k: v[1:5] for k, v in flips.items() if k != "pools"}}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
