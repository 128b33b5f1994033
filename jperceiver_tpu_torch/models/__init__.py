"""The port's models (NCHW `nn.Module`s named after the reference keys)."""

from .common import set_kernels
from .jperceiver import JPerceiver

__all__ = ["JPerceiver", "set_kernels"]
