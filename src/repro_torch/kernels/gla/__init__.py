# Chunked gated linear attention for the recurrent mixers (RWKV6; Mamba2
# with include_current), forward and backward: csrc/ (hand-written CUDA C++
# for sm_90a), kernel.py (ctypes binding, launch), ref.py (the plain PyTorch
# versions), ops.py (the autograd function: kernels for CUDA tensors, plain
# versions for CPU tensors, one launch counter per kernel).
from repro_torch.kernels.gla.ops import (  # noqa: F401
    LAUNCHES,
    gla_chunked,
    reset_launches,
)
