"""PyTorch / CUDA port of jperceiver_tpu for NVIDIA Hopper (H100).

A second package beside the JAX one, which stays the reference. It imports
nothing of JAX or of `jperceiver_tpu`. It covers the eval forward of
JPerceiver (`engine/infer.py`), streaming video inference
(`engine/streaming.py`), the training step and the epoch loop
(`engine/trainer.py`), the configs and presets (`config/`),
`models.build_model` and the data pipeline (`data/`), with
every TPU kernel of the JAX package hand-written in CUDA under
`ops/cuda/csrc/`: the reprojection loss forward and backward (K1, K2), the
3x3 conv forward, data-grad and weight-grad (K3, K4) and the 5x5 max-pool
(K5). Entry points run on CUDA unless the caller passes `device="cpu"`.
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
