"""Sorted segment sums over a CSR, summed directly.

Counterpart of ``hypergef_tpu/ops/segments.py::segment_sum_sorted``
(``:81-89``) with the same contract. The JAX package takes a prefix sum
and differences it at the segment boundaries (``:48-89``), which keeps
XLA's scatter off the TPU but loses precision as the running prefix grows
with nnz (``hypergef_tpu/ops/fused.py:53-57``). That form is not ported:
here every segment is summed on its own, in CSR order, by
``torch.segment_reduce``, whose kernel on the card walks each segment in
one thread with no atomics, so repeats are bitwise equal.
"""

from __future__ import annotations

import torch


def segment_sum_sorted(vals: torch.Tensor, indptr: torch.Tensor) -> torch.Tensor:
    """Sum ``vals`` [nnz, F] within the segments delimited by ``indptr``
    [S+1] (``indptr[0] == 0``, ``indptr[S] == nnz``). Returns [S, F]; an
    empty segment sums to 0."""
    if vals.dim() != 2 or indptr.dim() != 1:
        raise ValueError(f"need vals [nnz, F] and indptr [S+1], got {tuple(vals.shape)} "
                         f"and {tuple(indptr.shape)}")
    lengths = indptr[1:] - indptr[:-1]
    return torch.segment_reduce(vals, "sum", lengths=lengths, axis=0, unsafe=True)
