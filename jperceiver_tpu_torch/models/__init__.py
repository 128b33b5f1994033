"""The port's models (NCHW `nn.Module`s named after the reference keys)."""

from .common import set_kernels
from .jperceiver import JPerceiver
from .registry import MODELS, build_model, register

__all__ = ["JPerceiver", "MODELS", "build_model", "register", "set_kernels"]
