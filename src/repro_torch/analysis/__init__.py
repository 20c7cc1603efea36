"""Static rules and runtime sanitizers for the port's contracts.

- **runtime sanitizers** (``sanitize``): opt-in ``REPRO_SANITIZE=1`` hooks
  inside the trainer and the serving engines, the JAX package's
  ``analysis.sanitize`` copied: a NaN/Inf update tripwire, an exact
  page-pool refcount reconstruction, a step-cache audit against the
  declared buckets and a tracer audit.
- **static rules**, plain ``ast`` passes that never import the analyzed
  code, run by ``tools/lint_torch.py`` (``--strict``, ``--list-rules``):
  the JAX package's rules that have a PyTorch counterpart, under their IDs.
  ``rules_determinism``: R101 a backend-ordered reduction
  (``torch.distributed.all_reduce`` / ``reduce`` / ``reduce_scatter``) in
  ``train/`` or ``distributed/``; R102 iteration over a set; R103
  wall-clock time or unseeded randomness (``torch.rand*`` without
  ``generator=``, ``random.*``, global ``np.random``) in the state paths;
  R104 a ``fold_in_name`` keyed by dict order; R105 a device move
  (``.to(device)``, ``.cuda()``, ``.cpu()``) in ``serve/`` outside the
  disaggregated engine's seam. ``rules_trace``: R203 a host sync in a step
  function (``contracts.STEP_FUNCTIONS``, a hand-maintained literal: there
  is no ``jax.jit`` to find them). ``rules_kernels``: R402 a kernel
  directory without a plain ``ref.py``.

  No counterpart: R201 (Python control flow on a traced value) and R202
  (unhashable ``jax.jit`` static arguments), since nothing is traced; R301
  and R302 (the compile-bucket registry), since nothing is compiled per
  shape; R401 and R403 (``BlockSpec`` index maps, Pallas grids), since the
  port has no Pallas.

Suppressions: ``# repro-lint: disable=R103 -- justification`` on the
flagged line (or ``disable-file=`` anywhere in the file);
``tools/lint_torch.py --strict`` rejects a suppression without one.
"""
from repro_torch.analysis import contracts, sanitize
from repro_torch.analysis.core import (
    LintResult,
    Module,
    Rule,
    Suppression,
    Violation,
    all_rules,
    lint_paths,
    lint_source,
)

__all__ = [
    "contracts",
    "sanitize",
    "LintResult",
    "Module",
    "Rule",
    "Suppression",
    "Violation",
    "all_rules",
    "lint_paths",
    "lint_source",
]
