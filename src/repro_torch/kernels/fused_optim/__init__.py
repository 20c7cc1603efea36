# Fused pSGD, momentum and AdaGrad-DA updates: csrc/ (hand-written CUDA C++
# for sm_90a, one launch over every leaf), kernel.py (ctypes binding,
# leaf table, launch), ref.py (the plain PyTorch versions), ops.py (the
# public wrappers: kernel for CUDA tensors, plain versions for CPU tensors,
# one launch counter per kernel).
from repro_torch.kernels.fused_optim.ops import (  # noqa: F401
    LAUNCHES,
    adagrad_da_update,
    momentum_update,
    psgd_update,
    reset_launches,
)
