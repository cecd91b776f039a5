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
    python -m hypergef_tpu_torch.experiments.clustered_e2e
    python -m hypergef_tpu_torch.experiments.scale_aligned
    python -m hypergef_tpu_torch.experiments.dense_shard_scale
    python -m hypergef_tpu_torch.experiments.scale_projection
    python -m hypergef_tpu_torch.experiments.scale_serialized --epoch
    python -m hypergef_tpu_torch.experiments.minibatch_scale
    python -m hypergef_tpu_torch.experiments.weak_scaling
    python -m hypergef_tpu_torch.experiments.halo_overlap
    python -m hypergef_tpu_torch.experiments.fig8

Each runs on the card unless it is given ``--device cpu`` (without a card
the default raises), writes its CSV to ``--out`` (a file in the working
directory by default), and opens it with the card's name and power limit
(``# host clock, cpu`` on the CPU). Each ``main(argv)`` also returns its
results to a caller in process. Timing is ``utils/timing.py::cuda_time_ms``
behind its queued sleep, none of the JAX drivers' TPU workarounds
(``chain_fold``, min-window widening, jit operands). The scale drivers
model the exchanges one card cannot run (``--links``: the H100's NVLink 4
from its data sheet, or the JAX drivers' v5e ICI); every such row says
MODELED (:mod:`.scale_common`). fig8 times nothing: it counts each
route's bytes and flops (``utils/profiling.py``).
"""
