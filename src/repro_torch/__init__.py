"""PyTorch/CUDA port of the ``repro`` package, for one NVIDIA H100.

It keeps the JAX package's layout and names, so each module has its
counterpart at the same path under ``repro/``. It imports ``torch`` and
numpy only: never ``jax``, and nothing of ``repro`` (the pure-Python
modules it needs are copied here). Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""
