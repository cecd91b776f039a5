"""Sorted segment sums over a CSR, summed directly.

Counterpart of ``hypergef_tpu/ops/segments.py`` with the same contracts:
:func:`segment_sum_sorted` (``:81-89``), :func:`segment_mean_sorted`
(``:92-95``), :func:`gather_segment_sum_sorted` (``:98-102``) and
:func:`incidence_gather_sum` (``:105-135``), the op of the ``cumsum``
route. The JAX package takes a prefix sum and differences it at the
segment boundaries (``:48-89``), which keeps XLA's scatter off the TPU but
loses precision as the running prefix grows with nnz
(``hypergef_tpu/ops/fused.py:53-57``). That form is not ported: here every
segment is summed on its own, in CSR order: by ``torch.segment_reduce`` in
the plain functions (its kernel on the card walks each segment in one
thread with no atomics), and by the hand-written gather + segment-sum
kernel (:mod:`.segment_sum`) in :func:`incidence_gather_sum` on the card.
Repeats are bitwise equal on either path.
"""

from __future__ import annotations

import torch

from hypergef_tpu_torch.ops.segment_sum import SegmentTable, gather_segment_sum


def segment_sum_sorted(vals: torch.Tensor, indptr: torch.Tensor) -> torch.Tensor:
    """Sum ``vals`` [nnz, F] within the segments delimited by ``indptr``
    [S+1] (``indptr[0] == 0``, ``indptr[S] == nnz``). Returns [S, F]; an
    empty segment sums to 0."""
    if vals.dim() != 2 or indptr.dim() != 1:
        raise ValueError(f"need vals [nnz, F] and indptr [S+1], got {tuple(vals.shape)} "
                         f"and {tuple(indptr.shape)}")
    lengths = indptr[1:] - indptr[:-1]
    return torch.segment_reduce(vals, "sum", lengths=lengths, axis=0, unsafe=True)


def segment_mean_sorted(vals: torch.Tensor, indptr: torch.Tensor) -> torch.Tensor:
    """The segment sums over the segment sizes; an empty segment gives 0."""
    return divide_by_segment_sizes(segment_sum_sorted(vals, indptr), indptr)


def divide_by_segment_sizes(sums: torch.Tensor, indptr: torch.Tensor) -> torch.Tensor:
    """Segment sums [S, F] over the sizes of ``indptr``'s segments, at least 1."""
    cnt = (indptr[1:] - indptr[:-1]).to(sums.dtype)
    return sums / cnt.clamp_min(1.0)[:, None]


def gather_segment_sum_sorted(x: torch.Tensor, gather_ids: torch.Tensor,
                              indptr: torch.Tensor) -> torch.Tensor:
    """Gather + sorted segment sum: ``y[s] = Σ_{k ∈ seg s} x[gather_ids[k]]``."""
    return segment_sum_sorted(x.index_select(0, gather_ids), indptr)


class _IncidenceGatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.tables = (fwd, bwd)
        return gather_segment_sum(x.contiguous(), fwd)

    @staticmethod
    def backward(ctx, g):
        fwd, bwd = ctx.tables
        return incidence_gather_sum(g, bwd, fwd), None, None


def incidence_gather_sum(x: torch.Tensor, fwd: SegmentTable, bwd: SegmentTable) -> torch.Tensor:
    """Incidence-matrix product ``y = M x`` as gather + sorted segment sum.

    ``fwd`` is the CSR of M (rows = output segments) in the gather
    formulation, ``bwd`` the CSR of Mᵀ (the JAX function's ``g_fwd, p_fwd``
    and ``g_bwd, p_bwd``). M is a 0/1 incidence matrix, so the adjoint
    ``dx = Mᵀ ȳ`` is the same op over ``bwd``: no scatter in any derivative
    order. One launch of the segment-sum kernel a call on the card.
    """
    return _IncidenceGatherSum.apply(x, fwd, bwd)
