"""Reference (oracle) incidence aggregation in plain torch: the ``xla`` route.

Port of ``hypergef_tpu/ops/refops.py`` (``:40-65``, ``:71-141``,
``:147-184``): segment sums over the nnz of the incidence matrix, written
with ``index_add_``, which autograd differentiates exactly, and the segment
max with the reference's record table (``hgnnaggr_cuda.cu:144-208``), whose
backward routes each cotangent to the one member that won the max.
"""

from __future__ import annotations

from typing import Optional

import torch

from hypergef_tpu_torch.sparse.hypergraph import HypergraphData


def _segment_sum(vals, seg_ids, num_segments):
    out = torch.zeros((num_segments, vals.shape[1]), dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, seg_ids, vals)


def v2e_aggregate(hgd: HypergraphData, x: torch.Tensor, aggr: str = "sum") -> torch.Tensor:
    """V→E stage: ``Xe[e] = reduce_{v ∈ e} X[v]`` with reduce ∈ {sum, mean, max}."""
    if aggr == "max":
        return segment_max_gather(x, hgd.ht_vertex, hgd.ht_segids, hgd.num_edges)
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


def _segment_max_fwd(x, gather_ids, seg_ids, num_segments):
    """(y [S, F], argmax_k [S, F] int64) of ``refops.py:86-112``: the
    segment max of the gathered rows (0 for an empty segment and where the
    max is at or below ``finfo.min``) and the first nnz slot reaching it
    (nnz where none does). ``amax`` and ``amin`` do not depend on the order
    in which the slots are reduced."""
    gathered = x.index_select(0, gather_ids)  # [nnz, F]
    nnz, f = gathered.shape
    seg = seg_ids[:, None].expand(nnz, f)
    y = x.new_zeros((num_segments, f)).scatter_reduce(0, seg, gathered, "amax",
                                                      include_self=False)
    cnt = torch.zeros(num_segments, dtype=torch.int64, device=x.device).index_add_(
        0, seg_ids, torch.ones_like(seg_ids))
    y = torch.where((cnt == 0)[:, None] | (y <= torch.finfo(x.dtype).min), 0.0, y)
    is_max = gathered == y.index_select(0, seg_ids)
    k_ids = torch.arange(nnz, device=x.device)[:, None].expand(nnz, f)
    cand = torch.where(is_max, k_ids, nnz)
    argmax_k = torch.full((num_segments, f), nnz, dtype=torch.int64, device=x.device)
    return y, argmax_k.scatter_reduce(0, seg, cand, "amin")


class _SegmentMaxGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gather_ids, seg_ids, num_segments):
        y, argmax_k = _segment_max_fwd(x, gather_ids, seg_ids, num_segments)
        ctx.save_for_backward(gather_ids, argmax_k)
        ctx.num_inputs = x.shape[0]
        return y

    @staticmethod
    def backward(ctx, g):
        """``refops.py:120-138``: g[s, f] goes to nnz slot argmax_k[s, f],
        then to x row gather_ids[k]; nothing from an empty segment."""
        gather_ids, argmax_k = ctx.saved_tensors
        nnz = gather_ids.shape[0]
        dx = g.new_zeros((ctx.num_inputs, g.shape[1]))
        if nnz:
            valid = argmax_k < nnz
            rows = gather_ids.index_select(0, argmax_k.clamp(max=nnz - 1).reshape(-1))
            dx.scatter_add_(0, rows.view_as(argmax_k), torch.where(valid, g, 0.0))
        return dx, None, None, None


def segment_max_gather(x, gather_ids, seg_ids, num_segments: int) -> torch.Tensor:
    """``y[s] = max_{k: seg[k]=s} x[gather_ids[k]]`` (empty segments → 0),
    with the record-table backward: each cotangent goes to the first member
    in CSR order that reaches the max (``refops.py:71-83``)."""
    return _SegmentMaxGather.apply(x, gather_ids, seg_ids, num_segments)


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


def unignn_aggregate_ref(hgd: HypergraphData, x: torch.Tensor, use_deg: bool = False) -> torch.Tensor:
    """UniGNN aggregation (``refops.py:167-184``): ``H Hᵀ X``, or
    ``diag(degV)·H·diag(degE)·Hᵀ·X`` with ``use_deg``; UniGIN takes the
    first, UniGCNII the second."""
    xe = v2e_aggregate(hgd, x, "sum")
    if use_deg:
        xe = xe * hgd.degE
    xv = e2v_sum(hgd, xe)
    if use_deg:
        xv = xv * hgd.degV
    return xv
