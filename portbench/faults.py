"""Faults planted in the program underneath a run, for the readings that
the limits are set against (`calibrate.py --fault`) and for the tests
that see `correct` come out false. Each is a context manager that
patches the program while it is active; none is used by a measured run.

- `unchanged`: the training step leaves its state unchanged (Adam's
  update is skipped);
- `half_batch`: the training step's objective takes the first half of
  the batch's rows (rounded up) and its mean over them, while the
  forward runs on every row;
- `altered_layout`: the eval step's road layout answer has its two
  classes swapped;
- `altered_pose`: streaming's first frame-to-frame pose of each call has
  its translation reversed.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name, value):
    before = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, before)


def unchanged():
    from jperceiver_tpu_torch.engine import optim

    return _patched(optim.Adam, "step", lambda self, closure=None: None)


def half_batch():
    import torch

    from jperceiver_tpu_torch.engine import trainer

    losses = trainer.compute_losses

    def half(outputs, batch, cfg, **kwargs):
        rows = batch["color_aug"].shape[0]

        def first(d):
            return {k: v[:(rows + 1) // 2] if torch.is_tensor(v) and v.dim() and
                    v.shape[0] == rows else v for k, v in d.items()}

        return losses(first(outputs), first(batch), cfg, **kwargs)

    return _patched(trainer, "compute_losses", half)


def altered_layout():
    import jperceiver_tpu_torch.engine as engine

    make = engine.make_eval_step

    def altered(*args, **kwargs):
        step = make(*args, **kwargs)

        def wrong(batch):
            out = dict(step(batch))
            out["topview"] = out["topview"].flip(1)
            return out

        return wrong

    return _patched(engine, "make_eval_step", altered)


def altered_pose():
    from jperceiver_tpu_torch.engine import streaming

    make = streaming.make_streaming_fn

    def altered(*args, **kwargs):
        fn = make(*args, **kwargs)

        def wrong(frames, init_pose=None):
            out = dict(fn(frames, init_pose))
            pose = out["cam_T_cam"].clone()
            pose[0, :3, 3] *= -1
            out["cam_T_cam"] = pose
            return out

        return wrong

    return _patched(streaming, "make_streaming_fn", altered)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered_layout": altered_layout, "altered_pose": altered_pose}
