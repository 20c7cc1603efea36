# Flash attention for the training path, forward and backward: csrc/
# (hand-written CUDA C++ for sm_90a), kernel.py (ctypes binding, launch),
# ref.py (the plain PyTorch versions), ops.py (the autograd function: kernels
# for CUDA tensors, plain versions for CPU tensors, one launch counter per
# kernel, and one of its launches without the causal mask).
from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    LAUNCHES,
    LAUNCHES_NONCAUSAL,
    flash_attention,
    reset_launches,
)
