"""Input data for the port (its own copy of the JAX package's synthetic batch)."""

from .synthetic import synthetic_batch

__all__ = ["synthetic_batch"]
