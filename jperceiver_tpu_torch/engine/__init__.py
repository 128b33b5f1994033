"""Entry points of the port: the eval step, streaming inference, the
training step, the epoch loop, checkpoints and the eval hook."""

from .checkpoint import latest_epoch, load_weights, restore_checkpoint, save_checkpoint
from .env import device_summary, set_random_seed
from .eval_hook import EvalHook
from .infer import make_eval_step
from .logger import JsonLogger, get_root_logger
from .streaming import make_streaming_fn
from .trainer import Trainer, TrainStep, make_train_step

__all__ = ["EvalHook", "JsonLogger", "TrainStep", "Trainer", "device_summary",
           "get_root_logger", "latest_epoch", "load_weights", "make_eval_step",
           "make_streaming_fn", "make_train_step", "restore_checkpoint", "save_checkpoint",
           "set_random_seed"]
