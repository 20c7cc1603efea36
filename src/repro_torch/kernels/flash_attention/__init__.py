# Flash attention for the training path, forward and backward: csrc/
# (hand-written CUDA C++ for sm_90a), kernel.py (ctypes binding, launch),
# ref.py (the plain PyTorch versions), ops.py (the autograd function: kernels
# for CUDA tensors, plain versions for CPU tensors, one launch counter per
# kernel).
from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    LAUNCHES,
    flash_attention,
    reset_launches,
)
