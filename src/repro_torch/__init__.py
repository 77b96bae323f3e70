"""PyTorch + CUDA port of ``repro``: analytical cross-validation for
least-squares models (Treder 2018) on an NVIDIA H100.

It imports torch, numpy and the standard library, never jax or ``repro``.
The Pallas TPU kernels of the ported paths are hand-written CUDA C++ kernels
here (``csrc/``, built with nvcc at first use); see ``kernels.common`` for
the device and dispatch rules.

The subpackages load on first access, so ``python -m
repro_torch.analysis`` (stdlib only) runs without importing torch.
"""

import importlib

_LAZY = {"core": "repro_torch.core", "data": "repro_torch.data",
         "kernels": "repro_torch.kernels", "rsa": "repro_torch.rsa",
         "eeg": "repro_torch.data.eeg", "synthetic": "repro_torch.data.synthetic"}


def __getattr__(name):
    if name in _LAZY:
        return importlib.import_module(_LAZY[name])
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
