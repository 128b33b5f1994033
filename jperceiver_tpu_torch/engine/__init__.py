"""Entry points of the port: the eval step, streaming inference, the
training step and the epoch loop."""

from .env import device_summary, set_random_seed
from .infer import make_eval_step
from .logger import JsonLogger, get_root_logger
from .streaming import make_streaming_fn
from .trainer import Trainer, TrainStep, make_train_step

__all__ = ["JsonLogger", "TrainStep", "Trainer", "device_summary", "get_root_logger",
           "make_eval_step", "make_streaming_fn", "make_train_step", "set_random_seed"]
