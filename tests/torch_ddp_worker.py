"""Processes of the port's data-parallel tests (`tests/test_torch_parallel.py`).

`python tests/torch_ddp_worker.py <role> <dir>` with the environment torchrun
sets (`RANK`, `WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`). Each process runs
on one intra-op thread, reads `<dir>/inputs.pt` and writes what the tests
hold to `<dir>/rank<r>.pt` or `<dir>/cli<r>.pt`:

  rank:    joins a gloo group and runs, on its rows of the global batch,
           the 128^2 float64 step (bn_groups 1 with dropout and the drawn
           automask noise; bn_groups 2 without dropout, on the given noise),
           three fp32 steps with ZeRO-1 off and on, a save and restore under
           ZeRO, the eval hook on its shard of 5 simulated scenes, and
           `set_bn_groups` with 3 groups on 2 ranks; rank 0 then runs the
           same steps and eval in one process at the global batch and
           compares;
  cli:     `tools.train.main(argv)` on its rank for each run of
           `inputs.pt`, recording the files this rank wrote;
  graph:   joins a gloo group and runs two fp32 steps of the 128^2 step
           with DDP built without `static_graph` and as the step builds
           it (`static_graph=True`), from the same weights and batches;
           the step's graph decisions under gloo; the capture's key check
           with the same and with different keys;
  nccl_graph: (on cards, one a rank) joins an NCCL group and runs the
           128^2 step eagerly and captured (the warm-ups, the capture, two
           replays) for bn_groups 1 and the world size and with ZeRO-1,
           recording whether every step's metrics, gradients and weights
           and the final state agree bit for bit, and the launches.

Imports only torch and the port, so a process starts in seconds.
"""

from __future__ import annotations

import builtins
import hashlib
import os
import shutil
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

H = W = 128
OCC = 32
GLOBAL_B = 2
FLAGSHIP = dict(
    type="static", split="odometry", frame_ids=[0, -1, 1], scales=[0, 1, 2, 3],
    height=H, width=W, occ_map_size=OCC, num_class=2, min_depth=0.1, max_depth=100.0,
    automask=True, disp_norm=True, smoothness_weight=1e-3, scale_weight=0.1,
    static_weight=5.0, dynamic_weight=15.0, loss_type="iou", loss_sum=3, loss_weight=20,
    loss2_weight=20, loss_weightS=20, loss2_weightS=20, cgt_label_hw=(375, 1242),
    optimizer=dict(type="Adam", lr=1e-4, weight_decay=0),
    optimizer_config=dict(grad_clip=dict(max_norm=35, norm_type=2)),
    lr_config=dict(policy="step", warmup=None, step=[50]),
    use_pallas_reproj=True, pallas_reproj_bf16=False)
LR, EPS = 1e-4, 1e-8  # FLAGSHIP's Adam
# name -> (config keys, dropout on, noise given)
STEPS = {"bn1": (dict(bn_groups=1), True, False), "bn2": (dict(bn_groups=2), False, True)}


def _model(weights, dtype):
    from jperceiver_tpu_torch.models import JPerceiver

    model = JPerceiver(occ_map_size=OCC, branches="road", dtype=dtype).to(dtype)
    model.load_state_dict(weights, strict=True)
    return model


def _rows(batch: dict, dtype) -> dict:
    """This rank's rows of the global batch, floating arrays in `dtype`."""
    from jperceiver_tpu_torch.parallel import rank, world_size

    b = len(batch["color_aug"]) // world_size()
    sl = slice(rank() * b, (rank() + 1) * b)
    return {k: (v[sl].astype(dtype) if np.issubdtype(v.dtype, np.floating) else v[sl])
            for k, v in batch.items()}


def _steps(inp: dict) -> dict:
    from jperceiver_tpu_torch.engine import make_train_step
    from jperceiver_tpu_torch.parallel import rank, world_size

    out = {}
    local = _rows(inp["batch"], np.float64)
    b = GLOBAL_B // world_size()
    for name, (keys, drop, given) in STEPS.items():
        model = _model(inp["weights"], torch.float64)
        if not drop:
            model.DepthDecoder.dropout_rate = 0.0
        step = make_train_step(model, dict(FLAGSHIP, **keys), device="cpu",
                               steps_per_epoch=1000)
        noise = None
        if given:
            noise = torch.from_numpy(inp["noise"][:, :, rank() * b:(rank() + 1) * b])
        metrics = step.reduce_metrics(step(local, noise=noise))
        out[name] = {"metrics": {k: float(v) for k, v in metrics.items()},
                     "state": {k: v.clone() for k, v in model.state_dict().items()},
                     "grads": {n: p.grad.clone() for n, p in model.named_parameters()}}
    return out


def _zero1(inp: dict, work_dir: str) -> dict:
    """Three fp32 steps with ZeRO-1 off and on; under ZeRO a checkpoint
    after step 2 (in `work_dir`, which every rank passes alike and rank 0
    alone writes), restored into a new step that then takes step 3."""
    from jperceiver_tpu_torch.engine import make_train_step, restore_checkpoint, save_checkpoint
    from jperceiver_tpu_torch.parallel import barrier, rank

    local = _rows(inp["batch"], np.float32)
    weights = {k: v.float() if v.is_floating_point() else v for k, v in inp["weights"].items()}
    cfg = dict(FLAGSHIP, bn_groups=1)

    def fresh(zero1):
        return make_train_step(_model(weights, torch.float32), cfg, device="cpu",
                               steps_per_epoch=1000, zero1=zero1)

    def same(a, b):
        sa, sb = a.model.state_dict(), b.model.state_dict()
        return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)

    off, on = fresh(False), fresh(True)
    for i in range(3):
        off(local)
        on(local)
        if i == 1:
            save_checkpoint(work_dir, on, 2)
    resumed = fresh(True)
    epoch = restore_checkpoint(work_dir, resumed)
    barrier()  # every rank has read the checkpoint
    if rank() == 0:
        shutil.rmtree(work_dir, ignore_errors=True)
    resumed(local)
    moments = sum(v.numel() for st in on.optimizer.optim.state.values()
                  for k, v in st.items() if k in ("mu", "nu")) // 2
    return {"off_equals_on": same(off, on), "resumed_equals_on": same(resumed, on),
            "resumed_epoch": epoch, "iteration": resumed.iteration,
            "local_moment_elements": moments,
            "param_elements": sum(p.numel() for p in on.params),
            "checksum": float(sum(v.double().sum() for v in on.model.state_dict().values()
                                  if v.is_floating_point()))}


def _refuses_bn_groups(groups: int) -> bool:
    """Whether `set_bn_groups` refuses `groups` under this process group."""
    from jperceiver_tpu_torch.models.common import BatchNorm2d, set_bn_groups

    try:
        set_bn_groups(BatchNorm2d(4), groups)
    except ValueError:
        return True
    return False


def _eval() -> dict:
    from jperceiver_tpu_torch.data import DataLoader, SimulatedDataset
    from jperceiver_tpu_torch.engine import EvalHook
    from jperceiver_tpu_torch.models import JPerceiver
    from jperceiver_tpu_torch.parallel import rank, world_size

    torch.manual_seed(0)
    model = JPerceiver(occ_map_size=OCC, branches="road")
    ds = SimulatedDataset(n_scenes=5, height=H, width=W, seed=7, with_gt=True)
    loader = DataLoader(ds, batch_size=1, shuffle=False, num_workers=1, drop_last=False,
                        process_index=rank(), process_count=world_size())
    summary = EvalHook(model, loader, FLAGSHIP, device="cpu")()
    summary.pop("fps")
    return summary


def _cli(runs: list[dict]) -> list[dict]:
    """`tools.train.main(argv)` for each run in turn (the process group of
    one run destroyed before the next joins its own, on `port`), recording
    the files this process opens for writing under the run's work dir and
    the paths it `torch.save`s to."""
    from jperceiver_tpu_torch.parallel import rank
    from jperceiver_tpu_torch.tools import train

    out = []
    for i, run in enumerate(runs):
        if i:
            os.environ["MASTER_PORT"] = str(run["port"])
        work_dir, wrote = run["work_dir"], []
        open0, save0 = builtins.open, torch.save

        def open_rec(file, mode="r", *a, **k):
            if any(c in mode for c in "wax") and str(file).startswith(work_dir):
                wrote.append(os.path.relpath(str(file), work_dir))
            return open0(file, mode, *a, **k)

        def save_rec(obj, f, *a, **k):
            wrote.append(os.path.relpath(str(f), work_dir))
            return save0(obj, f, *a, **k)

        builtins.open, torch.save = open_rec, save_rec
        try:
            trainer = train.main(run["argv"])
        finally:
            builtins.open, torch.save = open0, save0
        step = trainer.train_step
        out.append({"rank": rank(), "wrote": sorted(set(wrote)), "iteration": step.iteration,
                    "checksum": float(sum(v.double().sum()
                                          for v in step.model.state_dict().values()
                                          if v.is_floating_point()))})
        torch.distributed.destroy_process_group()
    return out


def _compare(ddp: dict, one: dict) -> dict:
    """What the tests hold: the losses of both, and per parameter the
    gradients' max-abs distance and scales; per state entry, whether it is
    within 1e-10 of its scale plus, element by element, LR |dg| / EPS (the
    most Adam's first step can move for a gradient that moved by dg), or
    equal for an integer entry."""
    grads = {n: (float((g - one["grads"][n]).abs().max()), float(one["grads"][n].abs().max()),
                 float(g.abs().max())) for n, g in ddp["grads"].items()}
    state = {}
    for k, v in ddp["state"].items():
        w = one["state"][k]
        if not w.is_floating_point():
            state[k] = (bool(torch.equal(v, w)), 0.0)
            continue
        bound = 1e-10 * float(w.abs().max())
        if k in ddp["grads"]:  # an updated parameter
            bound = bound + LR * (ddp["grads"][k] - one["grads"][k]).abs() / EPS
        d = (v - w).abs()
        state[k] = (bool((d <= bound).all()), float(d.max()) / max(float(w.abs().max()), 1e-300))
    return {"metrics": ddp["metrics"], "metrics_one": one["metrics"], "grads": grads,
            "state": state}


def _digest(state: dict) -> str:
    h = hashlib.sha256()
    for k, v in state.items():
        h.update(k.encode())
        h.update(v.contiguous().numpy().tobytes())
    return h.hexdigest()


def _graph_cpu(inp: dict) -> dict:
    """The `graph` role: DDP without `static_graph` against the step's
    (`static_graph=True`), the graph decisions under gloo, the capture's
    key check."""
    from jperceiver_tpu_torch.engine import graphs, make_train_step
    from jperceiver_tpu_torch.parallel import rank

    local = _rows(inp["batch"], np.float32)
    weights = {k: v.float() if v.is_floating_point() else v for k, v in inp["weights"].items()}
    runs = {}
    ddp_cls = torch.nn.parallel.DistributedDataParallel
    for name in ("dynamic", "static"):
        if name == "dynamic":  # DistributedDataParallel without static_graph
            torch.nn.parallel.DistributedDataParallel = (
                lambda *a, static_graph, **k: ddp_cls(*a, **k))
        try:
            step = make_train_step(_model(weights, torch.float32), FLAGSHIP, device="cpu",
                                   steps_per_epoch=1000)
        finally:
            torch.nn.parallel.DistributedDataParallel = ddp_cls
        seen = []
        for _ in range(2):
            m = step.reduce_metrics(step(local))
            seen.append([m[k].clone() for k in sorted(m)] + [p.grad.clone() for p in step.params])
        runs[name] = {"static_graph": step.ddp.static_graph, "graphed": step.graphed,
                      "warmup": step.graphs.warmup,
                      "steps": seen + [[t.clone() for t in step.model.state_dict().values()]]}
    dynamic, static = runs["dynamic"], runs["static"]
    same = all(torch.equal(a, b) for x, y in zip(dynamic["steps"], static["steps"], strict=True)
               for a, b in zip(x, y, strict=True))
    try:  # the step's decision on a card under this gloo group
        graphs.use_graphs(True, torch.device("cuda"), "make_train_step", collectives=True)
        refused = ""
    except ValueError as exc:
        refused = str(exc)
    decisions = {"train_none_on_cuda": graphs.use_graphs(None, torch.device("cuda"), "t",
                                                         collectives=True),
                 "eval_none_on_cuda": graphs.use_graphs(None, torch.device("cuda"), "e",
                                                        collectives=False)}
    # The capture's key check: the same key on both ranks passes (a stand-in
    # capture), another key on rank 1 raises on both ranks.
    def stand_in_capture(copied, held):
        raise AssertionError("captured")

    checks = {}
    for name, key in (("same", "k"), ("differ", f"k{rank()}")):
        cache = graphs.GraphCache(lambda x: x + 1, "the test body", collectives=True)
        cache._capture = stand_in_capture
        x = torch.zeros(2)
        for _ in range(cache.warmup):  # DDP_WARMUP under a process group
            cache.run(key, {"x": x})
        try:
            cache.run(key, {"x": x})
        except AssertionError:
            checks[name] = "captured"
        except RuntimeError as exc:
            checks[name] = str(exc)
    return {"same": same, "dynamic_static_graph": dynamic["static_graph"],
            "static_graph": static["static_graph"], "graphed": static["graphed"],
            "warmup": static["warmup"], "graph_true_refused": refused,
            "decisions": decisions, "key_checks": checks}


def _nccl_graph(inp: dict) -> dict:
    """The `nccl_graph` role, on this rank's card: for bn_groups 1, the
    world size and ZeRO-1, the eager step and the captured one from the
    same weights over the same batches (the LR milestone between the first
    and second replay), and whether every step's metrics, gradients and
    weights, then the model, optimizer state and generator, agree bit for
    bit; each step's launches."""
    from jperceiver_tpu_torch.engine import make_train_step
    from jperceiver_tpu_torch.engine.graphs import DDP_WARMUP
    from jperceiver_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from jperceiver_tpu_torch.parallel import world_size

    dev = torch.device("cuda", torch.cuda.current_device())
    n = DDP_WARMUP + 3
    local = _rows(inp["batch"], np.float32)
    weights = {k: v.float() if v.is_floating_point() else v for k, v in inp["weights"].items()}
    # The milestone at iteration DDP_WARMUP + 2: epoch 1 of that many steps.
    cfg = dict(FLAGSHIP, lr_config=dict(policy="step", warmup=None, step=[1]))
    out = {}
    for name, keys, zero1 in (("bn1", dict(bn_groups=1), False),
                              ("bnW", dict(bn_groups=world_size()), False),
                              ("zero1", dict(bn_groups=1), True)):
        runs = {}
        # The default at one rank, the opt-in at more (`use_graphs`).
        for graph in (False, None if world_size() == 1 else True):
            step = make_train_step(_model(weights, torch.float32), dict(cfg, **keys), dev,
                                   steps_per_epoch=DDP_WARMUP + 2, seed=3, zero1=zero1,
                                   graph=graph)
            seen, counts = [], []
            for _ in range(n):
                reset_launch_counts()
                m = step(local)
                torch.cuda.synchronize()
                counts.append(launch_counts())
                seen.append([m[k].clone() for k in sorted(m)]
                            + [p.grad.clone() for p in step.params]
                            + [p.detach().clone() for p in step.params])
            opt = getattr(step.optimizer, "optim", step.optimizer)
            seen.append([t.clone() for t in step.model.state_dict().values()]
                        + [v.clone() for st in opt.state.values() for v in st.values()]
                        + [step.generator.get_state()])
            runs[graph] = {"seen": seen, "counts": counts, "graphed": step.graphed,
                           "captures": step.graphs.captures}
            del step
        eager, capt = runs.pop(False), runs.popitem()[1]
        out[name] = {"differing": [i for i, (a, b) in enumerate(zip(eager["seen"], capt["seen"]))
                                   if not all(torch.equal(x, y) for x, y in zip(a, b))],
                     "graphed": capt["graphed"], "captures": capt["captures"],
                     "counts_equal": eager["counts"] == capt["counts"],
                     "counts": capt["counts"][-1]}
    return out


def main(role: str, d: str) -> None:
    """A rank: the two-rank steps, ZeRO-1, the eval hook and the group
    check; then, the process group gone, rank 0 runs the same steps and
    eval in one process at the global batch and keeps what the tests hold
    (the tensors stay in memory: the files are small)."""
    torch.set_num_threads(1)
    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    if role == "cli":
        out = _cli(inp["runs"])
        torch.save(out, os.path.join(d, f"cli{out[0]['rank']}.pt"))
        return
    from jperceiver_tpu_torch.parallel import init_distributed, rank

    if role in ("graph", "nccl_graph"):
        if role == "graph":
            init_distributed("gloo", timeout_s=300, device="cpu")
            out = _graph_cpu(inp)
        else:
            init_distributed("nccl", timeout_s=300)
            out = _nccl_graph(inp)
        r = rank()
        torch.distributed.destroy_process_group()
        torch.save(out, os.path.join(d, f"{role}{r}.pt"))
        return

    init_distributed("gloo", timeout_s=300, device="cpu")
    r = rank()
    ddp = _steps(inp)
    out = {"digest": {name: _digest(v["state"]) for name, v in ddp.items()},
           "zero1": _zero1(inp, os.path.join(d, "zero1_run")),
           "bn_groups_3_refused": _refuses_bn_groups(3), "eval": _eval()}
    torch.distributed.destroy_process_group()
    if r == 0:
        one = _steps(inp)
        out["cmp"] = {name: _compare(ddp[name], one[name]) for name in ddp}
        out["eval_one"] = _eval()
        # For the JAX mesh step: fp32 copies (held to 1e-3 of their scale).
        bn2 = ddp["bn2"]
        out["bn2"] = {"metrics": bn2["metrics"],
                      "grads": {n: g.float() for n, g in bn2["grads"].items()},
                      "running": {k: v for k, v in bn2["state"].items() if "running" in k}}
    torch.save(out, os.path.join(d, f"rank{r}.pt"))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
