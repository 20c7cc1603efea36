# Paged flash-decode, chunk-prefill and fused-sample kernels for the serving
# hot path: csrc/ (hand-written CUDA C++ for sm_90a), kernel.py (nvcc build,
# ctypes binding, launch), ref.py (their plain PyTorch versions), ops.py
# (the public wrappers: kernel for a CUDA tensor, plain version for a CPU
# tensor, one launch counter per kernel).
from repro_torch.kernels.paged_decode.ops import (  # noqa: F401
    LAUNCHES,
    fused_sample,
    paged_chunk_prefill,
    paged_flash_decode,
    reset_launches,
)
