"""Runtime sanitizers of the port (``sanitize``): opt-in ``REPRO_SANITIZE=1``
hooks inside the trainer and the serving engines, the JAX package's
``analysis.sanitize`` copied: a NaN/Inf update tripwire, an exact page-pool
refcount reconstruction, a step-cache audit against the declared buckets
and a tracer audit. The JAX package's static lint rules (AST checks of its
JAX and Pallas idioms) are not ported."""
from repro_torch.analysis import sanitize

__all__ = ["sanitize"]
