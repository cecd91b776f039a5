"""hypergef_tpu_torch — the PyTorch / CUDA port of ``hypergef_tpu``.

The JAX package beside it is the reference: each module here names its
JAX counterpart by file and line, and the tests hold the two against each
other on the same NumPy inputs. This package imports ``torch`` and never
``jax``. Its kernels are hand-written CUDA for Hopper (``csrc/``), built at
first use; on CPU tensors each kernel's plain torch version runs instead.

What runs today is training (``Trainer``, ``train_full_batch``, on the card
unless given ``device="cpu"``; hyperedge-sampled minibatches with
``train.minibatch.MinibatchTrainer``), serving (``ServingModel``) and its
export (``serve.export_trainer``, ``ServingModel.load``) of HGNN (sum,
mean or max first aggregation), UniGIN and UniGCNII on the ``xla``,
``cumsum``, ``dense``, ``pallas``, ``tree``, ``pallas_sparse``, ``aligned``,
``bitstream`` and ``precomp`` routes, and distributed training over
``torch.distributed`` (``parallel``: ``DistTrainer``, the halo exchange;
``train.dp_minibatch``). By default (``backend="auto"``) the
routing ladder ``sparse.planner.plan_aggregation`` picks the route, as the
JAX package's does; ``backend=None`` takes ``cumsum``. ``aligned`` serves
community-sorted graphs (``sparse.reorder.community_reorder``,
``sparse.planner.plan_aligned``); ``bitstream`` holds the incidence one bit
per entry (``ops.bitstream.BitIncidence``). ``probes`` ports the TPU probe
scripts of ``scripts/`` onto one-construct CUDA kernels. See ROADMAP.md for
the rest.
"""

import torch

# The linear projections must stay in full f32, as XLA keeps them on the JAX
# side: TF32 would keep about three decimal digits of each product. This is
# PyTorch's default; it is set here so that no caller's setting changes it.
torch.backends.cuda.matmul.allow_tf32 = False

__version__ = "0.1.0"

from hypergef_tpu_torch.sparse.hypergraph import Hypergraph, HypergraphData  # noqa: E402
from hypergef_tpu_torch.sparse.planner import (  # noqa: E402
    AggregationPlan, DenseIncidence, DensePrecomp, plan_aggregation,
)

__all__ = [
    "Hypergraph",
    "HypergraphData",
    "AggregationPlan",
    "DenseIncidence",
    "DensePrecomp",
    "plan_aggregation",
]
