"""The port's step functions: the functions that run once a serving tick or
once an optimizer update, in which a host sync stalls the card's queue.

The JAX package finds its traced functions through ``jax.jit`` and declares
its compile buckets in ``analysis/contracts.py``'s ``COMPILE_BUCKETS``. The
port compiles nothing per shape, so nothing marks a step function in the
code: this registry is its hand-maintained counterpart, read by rule R203
(``rules_trace``). A new step builder, or a step function renamed, shows up
in a diff of this literal, so a reviewer sees the host-sync contract change.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class StepFunction:
    """One per-tick or per-update function: the module (a rel-path suffix)
    and its qualname (a builder's inner function: ``builder.step``)."""

    key: str
    module: str
    function: str


STEP_FUNCTIONS: Tuple[StepFunction, ...] = (
    # -- serving: the engines' ticks and chunks (serve/step.py's builders)
    StepFunction("serve.decode.slot", "repro_torch/serve/step.py", "build_slot_decode_step.step"),
    StepFunction("serve.decode.paged", "repro_torch/serve/step.py", "build_paged_decode_step.step"),
    StepFunction("serve.prefill.chunk", "repro_torch/serve/step.py", "build_chunk_prefill_step.step"),
    StepFunction("serve.stream.export", "repro_torch/serve/step.py", "build_page_export_step.step"),
    StepFunction("serve.stream.import", "repro_torch/serve/step.py", "build_page_import_step.step"),
    # -- training: one optimizer update
    StepFunction("train.step", "repro_torch/train/step.py", "build_train_step.step"),
    StepFunction("train.eval", "repro_torch/train/step.py", "build_eval_step.eval_step"),
    StepFunction("distributed.step.exact", "repro_torch/distributed/step.py", "build_elastic_train_step.step"),
    StepFunction("distributed.step.local", "repro_torch/distributed/step.py", "build_local_train_step.step"),
    StepFunction("distributed.step.sharded", "repro_torch/distributed/sharded.py",
                 "build_sharded_train_step.step"),
)


def step_functions_for(rel: str) -> Dict[str, StepFunction]:
    """qualname -> entry for the module at rel-path ``rel``."""
    return {s.function: s for s in STEP_FUNCTIONS if rel.endswith(s.module)}
