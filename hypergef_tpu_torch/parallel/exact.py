"""Row takes and reduction-tree stages with a fixed-order backward.

JAX differentiates the distributed programs' ``jnp.take`` calls and plain
tree levels (``halo_aggr.py:68``, ``:108``, ``:117``, ``:128``; the
``apply_levels`` of every halo stage) into XLA scatter-adds. In torch,
``index_select``'s backward is ``index_add_``, which adds with atomics on a
card and so in no fixed order. Here each such op is an autograd Function
whose backward is a segment sum over the op's inverse CSR, built on the
host with the plan: for every source row, the output rows that read it, in
increasing order. On the card that sum is the segment-sum kernel
(:func:`~hypergef_tpu_torch.ops.segment_sum.gather_segment_sum`); on the
CPU its plain twin. Both are the exact transposes of the forward.

* :class:`TakeTable` / :func:`take`: ``y = x[idx]`` (one level of fan 1).
* :class:`ExactStage` / :func:`apply_stage`: a stage's levels
  (``y[c] = Σ_k p[g[c, k]] · m[c, k]``, ``m`` 0/1) and its final map; the
  backward walks the levels in reverse, a segment sum each over the live
  slots of the level.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from hypergef_tpu_torch.ops.segment_sum import SegmentTable, gather_segment_sum
from hypergef_tpu_torch.ops.tree import apply_levels
from hypergef_tpu_torch.sparse.planner import DeviceStage, TreeStage


def inverse_csr(idx: np.ndarray, num_rows: int, live: Optional[np.ndarray] = None,
                out_of: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
    """The inverse of a gather map ``idx`` (flat, values in ``[0,
    num_rows)``): for each source row r, the outputs that read it, in
    increasing order, as (indptr [num_rows+1], gather). ``live`` keeps only
    some entries; ``out_of`` names each entry's output row (default: its
    position)."""
    idx = np.asarray(idx, dtype=np.int64).reshape(-1)
    pos = np.arange(idx.size, dtype=np.int64)
    if live is not None:
        keep = np.asarray(live).reshape(-1) > 0
        idx, pos = idx[keep], pos[keep]
    out = pos if out_of is None else np.asarray(out_of, dtype=np.int64).reshape(-1)[pos]
    order = np.lexsort((out, idx))
    indptr = np.zeros(num_rows + 1, dtype=np.int64)
    np.cumsum(np.bincount(idx, minlength=num_rows)[:num_rows], out=indptr[1:])
    return indptr, out[order]


def _table(indptr, gather, num_inputs: int, device) -> SegmentTable:
    long = torch.as_tensor(np.asarray(indptr, dtype=np.int64), device=device)
    g = torch.as_tensor(np.asarray(gather, dtype=np.int64), device=device)
    return SegmentTable.from_host(indptr, gather, max(num_inputs, 1), long, g)


def _segment_sum(g: torch.Tensor, table: SegmentTable) -> torch.Tensor:
    """``out[r] = Σ g[gather[k]]`` over row r's entries: the kernel on the
    card, the twin on the CPU; an empty table sums to zeros."""
    if table.nnz == 0:
        return g.new_zeros((table.num_segments, g.shape[1]))
    return gather_segment_sum(g.contiguous(), table)


@dataclasses.dataclass(frozen=True)
class TakeTable:
    """``y = x[idx]`` on a device: the int64 map and the inverse table."""

    idx: torch.Tensor  # int64 [K]
    inverse: SegmentTable  # segments = rows of x, gather = outputs
    num_rows: int

    @classmethod
    def build(cls, idx: np.ndarray, num_rows: int, device) -> "TakeTable":
        idx = np.asarray(idx, dtype=np.int64).reshape(-1)
        if idx.size and (idx.min() < 0 or idx.max() >= num_rows):
            raise ValueError(f"take indices must lie in [0, {num_rows})")
        ip, g = inverse_csr(idx, num_rows)
        return cls(torch.as_tensor(idx, device=device), _table(ip, g, idx.size, device),
                   num_rows)


class _Take(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, t: TakeTable):
        ctx.t = t
        return x.index_select(0, t.idx)

    @staticmethod
    def backward(ctx, g):
        return _segment_sum(g, ctx.t.inverse), None


def take(x: torch.Tensor, t: TakeTable) -> torch.Tensor:
    """``x[t.idx]``, with the fixed-order transpose as its backward."""
    if x.shape[0] != t.num_rows:
        raise ValueError(f"take over {t.num_rows} rows got x of {x.shape[0]}")
    return _Take.apply(x, t)


@dataclasses.dataclass(frozen=True)
class ExactStage:
    """A reduction-tree stage on a device (:class:`DeviceStage`) with each
    level's inverse table and the final map's."""

    stage: DeviceStage
    inverse_levels: Tuple[SegmentTable, ...]
    inverse_final: SegmentTable

    @classmethod
    def build(cls, st: TreeStage, device) -> "ExactStage":
        inv = []
        rows = st.num_inputs
        for lvl in st.levels:
            c, fan = lvl.gather_idx.shape
            ip, g = inverse_csr(lvl.gather_idx, rows, live=lvl.mask,
                                out_of=np.repeat(np.arange(c, dtype=np.int64), fan))
            inv.append(_table(ip, g, c, device))
            rows = c
        s = st.final_idx.shape[0]
        ip, g = inverse_csr(st.final_idx, rows, live=st.final_mask)
        return cls(DeviceStage.from_stage(st, device, kernel_level0=False), tuple(inv),
                   _table(ip, g, s, device))


class _ApplyStage(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, st: ExactStage):
        ctx.st = st
        s = st.stage
        return apply_levels(x, s.levels, s.final_idx, s.final_mask)

    @staticmethod
    def backward(ctx, g):
        st = ctx.st
        p = _segment_sum(g, st.inverse_final)
        for inv in reversed(st.inverse_levels):
            p = _segment_sum(p, inv)
        return p, None


def apply_stage(x: torch.Tensor, st: ExactStage) -> torch.Tensor:
    """The stage applied to x [num_inputs, F] → [S, F]; its backward is the
    fixed-order transpose."""
    if x.shape[0] != st.stage.num_inputs:
        raise ValueError(f"stage over {st.stage.num_inputs} rows got x of {x.shape[0]}")
    return _ApplyStage.apply(x, st)

