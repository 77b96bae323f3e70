"""PyTorch + CUDA port of ``repro``: analytical cross-validation for
least-squares models (Treder 2018) on an NVIDIA H100.

It imports torch, numpy and the standard library, never jax or ``repro``.
The Pallas TPU kernels of the ported paths are hand-written CUDA C++ kernels
here (``csrc/``, built with nvcc at first use); see ``kernels.common`` for
the device and dispatch rules.
"""

from repro_torch import core, data, kernels, rsa  # noqa: F401
from repro_torch.data import eeg, synthetic  # noqa: F401
