"""Max first aggregation over a reduction-tree stage, with its record table.

Port of ``hypergef_tpu/ops/maxops.py`` (``:40-115``) in plain torch. The
reference records, per (hyperedge, feature), which member vertex won the
max (``record_table``, ``hgnnaggr_cuda.cu:144-208``) and routes each
cotangent to exactly that member:

* **forward** — the fixed-fan tree of the sum path (:mod:`.tree`), with
  dead slots at ``-3e38`` and the winning source vertex id carried level by
  level: ``arg[e, f]`` is the first member in CSR order that reaches
  ``max_{v ∈ e} x[v, f]`` (argmax picks the first slot, slots and chunks
  run in CSR order). An empty hyperedge gives 0 and id -1.
* **backward** — ``dx[v, f] = Σ_{e ∋ v} g[e, f] · [arg[e, f] == v]`` over
  the vertex-major CSR (``HypergraphData.e2v``):
  :func:`.segment_sum.record_routed_dx` over ``HypergraphData.record``,
  the kernel's two passes on the card (each cotangent and each id read
  once), the gathers and direct sorted segment sum of its plain twin on the
  CPU (deterministic, no atomics). The tree's ids are int32, as JAX's
  (``:43-56``). The same backward serves the aligned stages
  (:mod:`.aligned_max`).
"""

from __future__ import annotations

import torch

from hypergef_tpu_torch.ops.segment_sum import RecordTable, record_routed_dx
from hypergef_tpu_torch.sparse.planner import DeviceStage

NEG = -3.0e38  # dead slots; inputs are taken as finite and above it


def _level_max(vals, args, g, m):
    """One fan-in level (``:40-56``): vals [P, F] partial maxima, args
    [P, F] their int32 source ids; g [C, fan] int64 gather table over P, m
    [C, fan] live mask. Returns the level's (vals, args) [C, F]."""
    c, fan = g.shape
    f = vals.shape[1]
    cand = vals.index_select(0, g.reshape(-1)).reshape(c, fan, f)
    cand = torch.where(m[:, :, None] > 0, cand, NEG)
    k_star = cand.argmax(dim=1)  # [C, F], the first slot reaching the max
    child = g.gather(1, k_star)  # [C, F] rows of P
    return cand.amax(dim=1), args.gather(0, child)


def tree_max_with_arg(x: torch.Tensor, stage: DeviceStage):
    """Max-reduce ``x`` [N, F] over a tree stage: (y [S, F], arg [S, F]
    int32), ``:59-87``. Level 0 seeds the ids from its gather table, cast
    to int32 once; the later levels' gathers keep the type."""
    g0, m0 = stage.levels[0]
    c, ngs = g0.shape
    f = x.shape[1]
    cand = x.index_select(0, g0.reshape(-1)).reshape(c, ngs, f)
    cand = torch.where(m0[:, :, None] > 0, cand, NEG)
    k_star = cand.argmax(dim=1)
    vals, args = cand.amax(dim=1), g0.gather(1, k_star).to(torch.int32)
    for g, m in stage.levels[1:]:
        vals, args = _level_max(vals, args, g, m)
    y = vals.index_select(0, stage.final_idx)
    arg = args.index_select(0, stage.final_idx)
    # every chunk of a non-empty segment holds a live slot, so the final
    # mask is the whole guard for empty segments
    alive = stage.final_mask > 0
    return torch.where(alive, y, 0.0), torch.where(alive, arg, -1)


class _V2EMaxTree(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, e_stage, record):
        y, arg = tree_max_with_arg(x, e_stage)
        ctx.save_for_backward(arg)
        ctx.record = record
        return y

    @staticmethod
    def backward(ctx, g):
        (arg,) = ctx.saved_tensors
        return record_routed_dx(g.contiguous(), arg, ctx.record), None, None


def v2e_max_tree(x, e_stage, record: RecordTable):
    """``y[e, f] = max_{v ∈ e} x[v, f]`` over the edge tree stage, with the
    record-table backward over ``record`` (``HypergraphData.record``: the
    vertex-major CSR and the kernel's layout)."""
    return _V2EMaxTree.apply(x, e_stage, record)
