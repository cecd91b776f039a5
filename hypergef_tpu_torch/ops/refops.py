"""Reference (oracle) incidence aggregation in plain torch: the ``xla`` route.

Port of ``hypergef_tpu/ops/refops.py`` for sum and mean first aggregation
(``:40-65``, ``:147-165``): segment sums over the nnz of the incidence
matrix, written with ``index_add_``. Autograd differentiates them exactly.
Max first aggregation comes later (ROADMAP.md queue 1, item 6).
"""

from __future__ import annotations

from typing import Optional

import torch

from hypergef_tpu_torch.sparse.hypergraph import HypergraphData


def _segment_sum(vals, seg_ids, num_segments):
    out = torch.zeros((num_segments, vals.shape[1]), dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, seg_ids, vals)


def v2e_aggregate(hgd: HypergraphData, x: torch.Tensor, aggr: str = "sum") -> torch.Tensor:
    """V→E stage: ``Xe[e] = reduce_{v ∈ e} X[v]`` with reduce ∈ {sum, mean}."""
    if aggr == "max":
        raise NotImplementedError(
            "max first aggregation is not ported yet (ROADMAP.md queue 1, item 6)")
    if aggr not in ("sum", "mean"):
        raise ValueError(f"unknown first_aggr {aggr!r}")
    gathered = x.index_select(0, hgd.ht_vertex)  # [nnz, F]
    s = _segment_sum(gathered, hgd.ht_segids, hgd.num_edges)
    if aggr == "sum":
        return s
    ones = torch.ones((gathered.shape[0], 1), dtype=x.dtype, device=x.device)
    cnt = _segment_sum(ones, hgd.ht_segids, hgd.num_edges)
    return s / cnt.clamp_min(1.0)


def e2v_sum(hgd: HypergraphData, xe: torch.Tensor) -> torch.Tensor:
    """E→V stage: per-vertex sum over incident hyperedges."""
    gathered = xe.index_select(0, hgd.h_edge)  # [nnz, F]
    return _segment_sum(gathered, hgd.h_segids, hgd.num_nodes)


def hgnn_aggregate_ref(
    hgd: HypergraphData,
    x: torch.Tensor,
    wdiag: Optional[torch.Tensor] = None,
    first_aggr: str = "sum",
) -> torch.Tensor:
    """HGNNConv aggregation: ``diag(degV) · H · diag(Wdiag·degE) · Hᵀ · X``
    on the already-projected ``x``; degV is applied on the output side only."""
    xe = v2e_aggregate(hgd, x, first_aggr) * hgd.degE
    if wdiag is not None:
        xe = xe * wdiag
    return e2v_sum(hgd, xe) * hgd.degV
