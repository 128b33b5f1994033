"""Entry points of the port: the eval step and streaming inference."""

from .infer import make_eval_step
from .streaming import make_streaming_fn

__all__ = ["make_eval_step", "make_streaming_fn"]
