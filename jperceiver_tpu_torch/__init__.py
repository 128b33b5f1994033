"""PyTorch / CUDA port of jperceiver_tpu for NVIDIA Hopper (H100).

A second package beside the JAX one, which stays the reference. It imports
nothing of JAX or of `jperceiver_tpu`. This slice is the inference path:
the eval forward of JPerceiver (`engine/infer.py`) and streaming video
inference (`engine/streaming.py`), with the TPU kernels of that path
(3x3 conv K3, 5x5 max-pool K5) hand-written in CUDA under `ops/cuda/csrc/`.
Entry points run on CUDA unless the caller passes `device="cpu"`.
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
