"""Serving: the static and the continuous-batching engines over a dense
cache, the paged continuous-batching engine and its disaggregated
(prefill / decode) split, their scheduler, slot rings and page pool (``pages``, ``scheduler`` and ``slots`` are copies of the
JAX package's pure-Python modules)."""
from repro_torch.serve.engine import (
    ContinuousBatchingEngine,
    DisaggregatedEngine,
    PagedContinuousBatchingEngine,
    ServeEngine,
)
from repro_torch.serve.pages import PagePool, RadixPrefixIndex, plan_admission
from repro_torch.serve.scheduler import AdmissionController, Request, RequestScheduler
from repro_torch.serve.slots import PagedSlotManager, SlotManager
from repro_torch.serve.step import (
    build_chunk_prefill_step,
    build_page_export_step,
    build_page_import_step,
    build_paged_decode_step,
    build_slot_decode_step,
    gumbel_noise,
    sample_tokens,
)

__all__ = [
    "AdmissionController",
    "ContinuousBatchingEngine",
    "DisaggregatedEngine",
    "PagePool",
    "PagedContinuousBatchingEngine",
    "PagedSlotManager",
    "RadixPrefixIndex",
    "Request",
    "RequestScheduler",
    "ServeEngine",
    "SlotManager",
    "build_chunk_prefill_step",
    "build_page_export_step",
    "build_page_import_step",
    "build_paged_decode_step",
    "build_slot_decode_step",
    "gumbel_noise",
    "plan_admission",
    "sample_tokens",
]
