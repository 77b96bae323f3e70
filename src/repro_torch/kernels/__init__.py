# Hand-written CUDA C++ kernels for Hopper (sources in repro_torch/csrc).
# Each subpackage: <name>.py (ctypes launch of the CUDA kernel), ops.py
# (public wrapper: plain version on CPU tensors, kernel on CUDA tensors),
# ref.py (plain PyTorch version).
