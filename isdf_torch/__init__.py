"""isdf_torch — the PyTorch + CUDA port of isdf_tpu for NVIDIA Hopper.

Same layers and module names as ``isdf_tpu`` (core/, shapes/, sweep/, opt/,
world/, search/, plan/), written in PyTorch; the TPU's Pallas kernels become
hand-written CUDA kernels under ``csrc/``, built at first use.  The package
imports nothing of ``isdf_tpu`` and no JAX.  Entry points run on the CUDA
card unless the caller passes ``device="cpu"`` (isdf_torch/device.py).
"""

__version__ = "0.1.0"

from isdf_torch.config import Config  # noqa: F401
