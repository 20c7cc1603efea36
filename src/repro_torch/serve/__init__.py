"""Serving: the paged continuous-batching engine, its scheduler, slot ring
and page pool (``pages``, ``scheduler`` and ``slots`` are copies of the
JAX package's pure-Python modules)."""
from repro_torch.serve.engine import PagedContinuousBatchingEngine
from repro_torch.serve.pages import PagePool, RadixPrefixIndex, plan_admission
from repro_torch.serve.scheduler import AdmissionController, Request, RequestScheduler
from repro_torch.serve.slots import PagedSlotManager
from repro_torch.serve.step import (
    build_chunk_prefill_step,
    build_paged_decode_step,
    gumbel_noise,
    sample_tokens,
)

__all__ = [
    "AdmissionController",
    "PagePool",
    "PagedContinuousBatchingEngine",
    "PagedSlotManager",
    "RadixPrefixIndex",
    "Request",
    "RequestScheduler",
    "build_chunk_prefill_step",
    "build_paged_decode_step",
    "gumbel_noise",
    "plan_admission",
    "sample_tokens",
]
