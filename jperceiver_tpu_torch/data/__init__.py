"""Input data for the port (its own copy of what the inference path needs)."""

from .synthetic import synthetic_batch

__all__ = ["synthetic_batch"]
