"""The numbers that decide `correct`, each a gap between what the program
produced and what the plain reference computes from the same weights and
inputs, and their limits (`limits/<cell>.json`, which name the numbers
that decide; the others are readings).

Training, over the compared first steps: `loss` the widest gap of a
step's loss over the sum of the magnitudes of the reference's loss terms
(the total passes through 0 as the layout terms, negative soft IoUs,
grow), `loss_first` step 1's; `grad` and `change` the worst parameter's
gap between the program's norm and the reference's (its gradient as Adam
got it at step 1; its distance from the start after the compared steps),
over the larger of that parameter's reference norm and the median
parameter's, `grad_median` and `change_median` the median parameter's.
`change` leaves out the parameters whose reference gradient is under a
thousandth of the median parameter's: Adam moves those by round-off alone.
`disp` and `pose` judge step 1's forward outputs as below.

Outputs (and a training step's first forward): the worst relative L2 gap
of an output to the fp32 reference, a pose taken as its difference from
the identity (the motion), in units of the gap that the program's own
rounding makes in the plain formula on the same inputs and weights: its
convolutions in TF32, as cuDNN computes an fp32 convolution by default
(`reference/model.py::precision`). The network's sensitivity to rounding
differs from seed to seed by an order of magnitude (its random weights),
so a gap is read against that seed's own TF32 gap. A layout is read as
the median over the samples and branches, since the cross-view
transformer's hard attention flips on near ties and changes a patch of
the layout on a few requests (`<number>_max` keeps the worst, and
`<number>_class` the largest share of cells whose class, the argmax over
the channels, differs from the reference's).
"""

from __future__ import annotations

import statistics

import torch

NEGLIGIBLE = 1e-3


def _gaps(prog: dict, ref: dict, names) -> list[float]:
    floor = statistics.median(ref.values())
    return [abs(prog[n] - ref[n]) / max(ref[n], floor, 1e-30) for n in names]


OUTPUTS = {"disp": ["disp/0", "disp/1", "disp/2", "disp/3"],
           "pose": ["cam_T_cam/-1", "cam_T_cam/1"]}


def train_numbers(prog: dict, ref: dict, ref_unit: dict) -> dict:
    """Every reading of the compared steps (the module's docstring)."""
    losses = [abs(p - r) / scale for p, r, scale in zip(prog["loss"], ref["loss"], ref["scale"])]
    floor = statistics.median(ref["grad"].values())
    moving = [n for n, g in ref["grad"].items() if g >= NEGLIGIBLE * floor]
    names = list(ref["grad"])
    grad = _gaps(prog["grad"], ref["grad"], names)
    change = _gaps(prog["change"], {n: ref["change"][n] for n in moving}, moving)
    outputs = output_numbers([(prog["outputs"], ref["outputs"], ref_unit)], OUTPUTS)
    return {**outputs, "loss": max(losses), "loss_first": losses[0],
            "grad": max(grad), "grad_median": statistics.median(grad),
            "grad_leaf": names[grad.index(max(grad))],
            "change": max(change), "change_median": statistics.median(change),
            "change_leaf": moving[change.index(max(change))]}


def rel_gap(prog: torch.Tensor, ref: torch.Tensor, pose: bool = False) -> float:
    prog, ref = prog.double().cpu(), ref.double().cpu()
    base = ref
    if pose:
        base = ref - torch.eye(4, dtype=ref.dtype)
    return float((prog - ref).norm() / base.norm().clamp_min(1e-30))


def output_numbers(triples, groups: dict, units: dict | None = None) -> dict:
    """`triples`: (outputs judged, fp32 reference, TF32 reference) dicts of
    tensors, one a sample; `groups`: {number: [output keys]}. A number is
    the worst, over the samples and its keys, of the judged outputs' gap to
    the fp32 reference in units of the TF32 reference's gap on that sample,
    a layout's the median (`<number>_gap` keeps the worst gap itself, and a
    layout's `<number>_max` the worst ratio and `<number>_class` the worst
    share of cells of another class); keys
    absent from the reference are skipped, and outputs of another shape
    read inf. `units` {number: key} reads a number in units of another
    output's TF32 gap: a chained pose, whose own gap is a sum of frames'
    errors that cancel on some seeds, against the frames' poses."""
    units = units or {}
    out = {}
    for number, keys in groups.items():
        pose = number in ("pose", "global_pose")
        ratios, gaps, classes = [], [], []
        for side, r32, r_unit in triples:
            for k in keys:
                if k not in r32:
                    continue
                if side[k].shape != r32[k].shape:
                    ratios.append(float("inf"))
                    gaps.append(float("inf"))
                    classes.append(1.0)
                    continue
                gap = rel_gap(side[k], r32[k], pose)
                gaps.append(gap)
                unit = units.get(number, k)
                ratios.append(gap / max(rel_gap(r_unit[unit], r32[unit], pose), 1e-12))
                if number in LAYOUTS:
                    classes.append(class_share(side[k], r32[k]))
        if ratios:
            out[number], out[f"{number}_gap"] = max(ratios), max(gaps)
        if number in LAYOUTS and ratios:
            out[number], out[f"{number}_max"] = statistics.median(ratios), max(ratios)
            out[f"{number}_class"] = max(classes)
    return out


LAYOUTS = ("layout",)


def class_share(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The share of cells of a (B, C, S, S) layout whose class, the argmax
    over C, differs from the reference's."""
    return float((prog.cpu().argmax(1) != ref.cpu().argmax(1)).double().mean())


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}): correct when every number
    is finite and at most its limit, and every limit has its number."""
    table, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and value == value and value <= limit
        ok = ok and good
        table[name] = {"value": value, "limit": limit}
    return ok, table
