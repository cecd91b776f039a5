"""Aggregation plans: the host-built tables the routes consume.

Port of the dense part of ``hypergef_tpu/sparse/planner.py``: the int8
:class:`DenseIncidence` (``:433-515``) and an :class:`AggregationPlan`
(``:540-557``) that carries it. The other plan forms (tree, aligned,
bitstream, precomp) and the routing ladder ``plan_aggregation``
(``:638-782``) come with their routes (ROADMAP.md queue 1, item 3).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class DenseIncidence:
    """Dense |V|×|E| incidence-count table, int8, on a device.

    Entries are exact incidence counts (0/1 for a deduplicated graph), so
    int8 loses nothing. Both the ``dense`` route and the fused CUDA kernel
    read this table; the packed-int4 form of the JAX package is not ported
    (ROADMAP.md, "Do not port").
    """

    h: torch.Tensor  # int8 [N, E]
    num_nodes: int
    num_edges: int

    @classmethod
    def from_hypergraph(cls, hg, device) -> "DenseIncidence":
        """Build the int8 table on ``device`` (``planner.py:480-515``, int8
        branch)."""
        arr = hg.to_scipy().toarray()
        amax = int(arr.max()) if arr.size else 0
        if amax > 127:
            raise MemoryError(
                ">127 duplicate incidences in one (vertex, edge) pair "
                "— not an incidence matrix?"
            )
        h = torch.as_tensor(arr.astype(np.int8), device=device)
        return cls(h=h, num_nodes=hg.num_nodes, num_edges=hg.num_edges)


@dataclasses.dataclass
class AggregationPlan:
    """Everything the route dispatcher needs, built once per graph.

    Only the dense table is ported; it serves the ``dense`` and ``pallas``
    routes.
    """

    dense: Optional[DenseIncidence] = None

    @classmethod
    def dense_plan(cls, hg, device) -> "AggregationPlan":
        return cls(dense=DenseIncidence.from_hypergraph(hg, device))
