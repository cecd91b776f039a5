"""Distributed training over ``torch.distributed``: the port of
``hypergef_tpu/parallel`` (``__init__.py:1-52``), one process a shard.

* :mod:`.mesh`: process groups (``make_mesh``, ``make_hybrid_mesh``,
  ``local_shard_info``) and torchrun's environment (``init_distributed``);
  :mod:`.launch` spawns a world of ranks on one host;
* :mod:`.comm`: the collectives as autograd Functions;
* :mod:`.partition` and :mod:`.dist_aggr`: the edge-partitioned
  aggregation (X replicated); :mod:`.dense_shard`: its int8 dense form;
* :mod:`.dist_model` and :mod:`.trainer`: ``DistTrainer`` (the CLI's
  ``--shards``);
* :mod:`.halo` and :mod:`.halo_aggr`: the fully-sharded halo exchange, with
  the aligned interior on the band and max kernels;
* :mod:`.serial_halo` and :mod:`.serial_halo_train`: the halo plan's shards
  run one at a time on one device, the exchanges staged through the host
  (a forward, and the two-layer HGNN's training step and epochs);
* :mod:`.exact`: takes and tree stages with fixed-order backwards.

Every aggregation of :mod:`.dist_aggr` and :mod:`.dense_shard` takes
``feature_sharded=True`` on an ``(e, f)`` grid (``make_mesh(n_edge,
n_feature)``), and ``DistTrainer(n_feature=...)`` trains on one.
"""

from hypergef_tpu_torch.parallel.dense_shard import (
    ShardedDensePlan, plan_sharded_dense, sharded_dense_hgnn_aggregate,
    sharded_dense_unignn_aggregate,
)
from hypergef_tpu_torch.parallel.dist_aggr import sharded_hgnn_aggregate, sharded_unignn_aggregate
from hypergef_tpu_torch.parallel.halo import HaloPlan, plan_halo
from hypergef_tpu_torch.parallel.halo_aggr import (
    halo_hgnn_aggregate, halo_unignn_aggregate, make_halo_train_step, shard_vertex_features,
    unshard_vertex_features,
)
from hypergef_tpu_torch.parallel.mesh import (
    init_distributed, local_shard_info, make_hybrid_mesh, make_mesh,
)
from hypergef_tpu_torch.parallel.partition import (
    ShardedAggPlan, edge_partition_bounds, plan_sharded_aggregation,
)
from hypergef_tpu_torch.parallel.serial_halo import ShardTables, serialized_halo_forward
from hypergef_tpu_torch.parallel.serial_halo_train import (
    serialized_halo_train_epochs, serialized_halo_train_step,
)
from hypergef_tpu_torch.parallel.trainer import DistTrainer

__all__ = [
    "HaloPlan", "plan_halo", "halo_hgnn_aggregate", "halo_unignn_aggregate",
    "make_halo_train_step", "shard_vertex_features", "unshard_vertex_features", "DistTrainer",
    "ShardedAggPlan", "edge_partition_bounds", "plan_sharded_aggregation",
    "sharded_hgnn_aggregate", "sharded_unignn_aggregate", "ShardedDensePlan",
    "plan_sharded_dense", "sharded_dense_hgnn_aggregate", "sharded_dense_unignn_aggregate",
    "make_mesh", "init_distributed", "make_hybrid_mesh", "local_shard_info",
    "ShardTables", "serialized_halo_forward", "serialized_halo_train_step",
    "serialized_halo_train_epochs",
]
