"""Entry points of the port: the eval step, streaming inference and the
training step."""

from .infer import make_eval_step
from .streaming import make_streaming_fn
from .trainer import make_train_step

__all__ = ["make_eval_step", "make_streaming_fn", "make_train_step"]
