"""The experiment drivers on the card: ports of the JAX package's
``experiments/`` scripts, one module each, with the same file name, flags,
tables and CSV columns.

    python -m hypergef_tpu_torch.experiments.fig7_9_realistic
    python -m hypergef_tpu_torch.experiments.fig7_9
    python -m hypergef_tpu_torch.experiments.auto_matrix
    python -m hypergef_tpu_torch.experiments.fig10
    python -m hypergef_tpu_torch.experiments.fig6 --quick
    python -m hypergef_tpu_torch.experiments.serve_bench
    python -m hypergef_tpu_torch.experiments.minibatch_bench

Each runs on the card unless it is given ``--device cpu`` (without a card
the default raises), writes its CSV to ``--out`` (a file in the working
directory by default), and opens it with the card's name and power limit
(``# host clock, cpu`` on the CPU). Each ``main(argv)`` also returns its
results to a caller in process. Timing is ``utils/timing.py::cuda_time_ms``
behind its queued sleep, none of the JAX drivers' TPU workarounds
(``chain_fold``, min-window widening, jit operands).
"""
