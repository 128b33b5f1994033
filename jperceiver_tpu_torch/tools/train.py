"""Train CLI: one config file (or a named preset family), one work dir
(counterpart of `jperceiver_tpu/tools/train.py`).

    python -m jperceiver_tpu_torch.tools.train --config cfg.py --work_dir out/

It builds the model, the training (and, with `validate`, validation)
dataset and loader, a `Trainer` on the run's config with an `EvalHook`, a
checkpoint every `checkpoint_config.interval` epochs and a `JsonLogger`,
then trains with `fit_resilient`. `--resume_from <work dir>` restores the
newest checkpoint there (model, optimizer, iteration, generator) and goes
on from its epoch; `--load_from` / `--finetune` load weights only, the
second where names and shapes match. Runs on the card unless `--device cpu`.
On the card the training step and the eval hook's forward are CUDA graphs
(`engine/graphs.py`) unless `--graph off`, under `--launcher pytorch` on
one NCCL rank too (the step's collectives in its graph, after 11 eager
warm-up steps); under gloo, and on NCCL at more ranks, the step runs
eagerly, and `--graph on` captures it on NCCL at any number of ranks.
`--graph on` raises where a step cannot be captured (under gloo, on the
CPU).

Data parallel (the JAX CLI's `--multihost`): one process per card, started
by torchrun, with `--launcher pytorch`:

    torchrun --nproc_per_node=N -m jperceiver_tpu_torch.tools.train \
        --config cfg.py --work_dir out/ --launcher pytorch

Each rank trains on its shard of every epoch at `imgs_per_gpu` samples (the
global batch is N times that; the JAX CLI multiplies by its local device
count, as it runs one process per host) and evaluates its shard of the
validation set. `--dist_backend` is NCCL on the card by default and gloo
on the CPU; two ranks that share one card need gloo. Rank 0 alone writes
the checkpoints and the log; `--resume_from` restores on every rank.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train JPerceiver (PyTorch port)")
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--config", help="python config file")
    g.add_argument("--family", help="named preset family (config.families.list_families())")
    p.add_argument("--work_dir", required=True)
    p.add_argument("--resume_from", default=None)
    p.add_argument("--load_from", default=None)
    p.add_argument("--finetune", default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--max_steps_per_epoch", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="default: the CUDA card (cuda:LOCAL_RANK under --launcher pytorch)")
    p.add_argument("--launcher", choices=("none", "pytorch"), default="none",
                   help="pytorch: join the process group torchrun's environment describes")
    p.add_argument("--dist_backend", default=None,
                   help="nccl or gloo (default: nccl on the card, gloo on the CPU)")
    p.add_argument("--graph", choices=("auto", "on", "off"), default="auto",
                   help="CUDA graphs of the step and the eval forward: auto captures on "
                        "the card (the step under one NCCL rank, not under gloo or more "
                        "NCCL ranks, which 'on' captures)")
    return p.parse_args(argv)


def main(argv=None):
    """Trains as the arguments say; returns the `Trainer`."""
    args = parse_args(argv)

    from ..config import Config, build_family
    from ..data import DataLoader, get_dataset
    from ..engine.checkpoint import (apply_pretrained_encoders, load_weights,
                                     restore_checkpoint, save_checkpoint)
    from ..engine.env import device_summary, set_random_seed
    from ..engine.eval_hook import EvalHook
    from ..engine.logger import JsonLogger, get_root_logger
    from ..engine.trainer import Trainer
    from ..models import build_model
    from ..parallel import init_distributed, local_device, rank, world_size

    device = args.device
    if args.launcher == "pytorch":
        init_distributed(args.dist_backend, device=device)
        device = local_device(device)
    cfg = build_family(args.family) if args.family else Config.fromfile(args.config)
    for k in ("resume_from", "load_from", "finetune"):
        if getattr(args, k) is not None:
            cfg[k] = getattr(args, k)
    seed = args.seed or 0
    graph = {"auto": None, "on": True, "off": False}[args.graph]
    if args.seed is not None:
        set_random_seed(args.seed)
    logger = get_root_logger()
    logger.info("devices: %s", device_summary())

    model_cfg = cfg.model
    # The losses read flat fields; the data-level ones are merged in.
    for key in ("type", "split"):
        if key not in model_cfg and key in cfg.data:
            model_cfg[key] = cfg.data[key]
    model = build_model(model_cfg)
    if any(model_cfg.get(k) for k in ("depth_pretrained_path", "pose_pretrained_path",
                                      "layout_pretrained_path")):
        apply_pretrained_encoders(model, model_cfg)
        logger.info("initialized encoder trunks from pretrained .pth files")

    with_sdf = int(model_cfg.get("loss_sum", 1)) >= 2
    num_class = model_cfg.get("num_class", 2)
    workers = int(cfg.get("workers_per_gpu", 4))
    train_ds = get_dataset(cfg.data, training=True, with_sdf=with_sdf, num_class=num_class)
    shard = dict(process_index=rank(), process_count=world_size())
    train_loader = DataLoader(train_ds, batch_size=int(cfg.get("imgs_per_gpu", 2)),
                              shuffle=True, num_workers=workers, **shard)
    steps_per_epoch = len(train_loader)
    if args.max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.max_steps_per_epoch)

    eval_hook = None
    if cfg.get("validate", False):
        val_ds = get_dataset(cfg.data, training=False, with_sdf=with_sdf, num_class=num_class)
        # Evaluation sees every sample: the tail is padded, not dropped.
        val_loader = DataLoader(val_ds, batch_size=1, shuffle=False, num_workers=workers,
                                drop_last=False, **shard)
        eval_hook = EvalHook(model, val_loader, model_cfg, device=device, graph=graph)

    interval = int(cfg.get("checkpoint_config", {}).get("interval", 1))

    def checkpoint_fn(step, epoch):  # every rank: rank 0 writes
        if epoch % interval == 0:
            save_checkpoint(args.work_dir, step, epoch)

    trainer = Trainer(model, cfg, train_loader, steps_per_epoch, device=device,
                      eval_hook=eval_hook, checkpoint_fn=checkpoint_fn,
                      log_fn=JsonLogger(args.work_dir),
                      log_interval=int(cfg.get("log_config", {}).get("interval", 50)),
                      seed=seed, graph=graph)
    start_epoch = 0
    if cfg.get("resume_from"):
        start_epoch = restore_checkpoint(cfg.resume_from, trainer.train_step)
        logger.info("resumed from %s at epoch %d", cfg.resume_from, start_epoch)
    elif cfg.get("load_from"):
        load_weights(cfg.load_from, model)
    elif cfg.get("finetune"):
        load_weights(cfg.finetune, model, strict=False)
    trainer.fit_resilient(int(cfg.get("total_epochs", 1)), args.work_dir,
                          start_epoch=start_epoch)
    return trainer


if __name__ == "__main__":
    main()
