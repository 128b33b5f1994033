"""The training objective of the port: the CGT label and the multi-task loss."""

from .cgt import cgt_scale_label
from .multitask import compute_losses, total_loss

__all__ = ["cgt_scale_label", "compute_losses", "total_loss"]
