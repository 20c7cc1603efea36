"""The paper's own experiments on the port: Fig. 2 (the optimal batch size
against the initial gap, ``fig2_optimal_batch``), Fig. 3 (stagewise
schedules on a ResNet, ``fig3_stagewise``), the loss-keyed adaptive SEBS
study (``adaptive_sebs``) and the SEBS-against-classical example
(``sebs_vs_stagewise``), each with the settings, methods and records of
its JAX counterpart (``benchmarks/`` and ``examples/``). Each runs as
``python -m repro_torch.experiments.<name> [--device cpu] [--out DIR]``.
"""
