"""Block-sparse aggregation: the ``bsr`` route.

Port of ``hypergef_tpu/ops/bsr_ops.py`` (``:1-113``). Each direction
gathers the source block-rows (128 rows of x each), takes one 128×128 bf16
product with an f32 result a nonzero block (:func:`~.tree.bmm_f32`, a
library batched product, as JAX leaves it to XLA), and sums each block-row's
partials with the reduction tree at block granularity. The backward of a
direction is the paired stage (the blocks of Mᵀ): no scatter in any
derivative order, as in JAX (``:46-70``). Vertices and hyperedges enter and
leave the plan's numbering through gathers whose backward gathers through
the inverse permutation (:class:`_Permute`), where autograd's own backward
of a gather would scatter.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from hypergef_tpu_torch.ops.tree import _apply_stage, bmm_f32
from hypergef_tpu_torch.sparse.bsr import BLOCK, BsrPlan, BsrStageDev


def _apply_bsr_stage(x, st: BsrStageDev):
    """x f32 [num_cols, F] → f32 [num_row_blocks·BLOCK, F] (``:22-41``)."""
    f = x.shape[1]
    pad = (-x.shape[0]) % BLOCK
    xb = x.to(torch.bfloat16)
    if pad:
        xb = F.pad(xb, (0, 0, 0, pad))
    gathered = xb.reshape(-1, BLOCK, f).index_select(0, st.bcol)  # [NB, B, F]
    partial = bmm_f32(st.blocks, gathered)  # [NB, B, F] f32
    combined = _apply_stage(partial.reshape(partial.shape[0], BLOCK * f), st.combine)
    return combined.reshape(-1, f)


class _BsrMatvec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd_stage, bwd_stage, num_rows):
        ctx.stages = (fwd_stage, bwd_stage)
        ctx.num_inputs = x.shape[0]
        return _apply_bsr_stage(x, fwd_stage)[:num_rows]

    @staticmethod
    def backward(ctx, g):
        fwd_stage, bwd_stage = ctx.stages
        return bsr_matvec(g, bwd_stage, fwd_stage, ctx.num_inputs), None, None, None


def bsr_matvec(x, fwd_stage: BsrStageDev, bwd_stage: BsrStageDev, num_rows: int):
    """``y = M x`` over the BSR stage of M, its first ``num_rows`` rows;
    ``bwd_stage`` holds Mᵀ, which the backward applies (``:44-70``)."""
    return _BsrMatvec.apply(x, fwd_stage, bwd_stage, num_rows)


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, inv):
        ctx.inv = inv
        return x.index_select(0, perm)

    @staticmethod
    def backward(ctx, g):
        return g.index_select(0, ctx.inv), None, None


def _permute(x, perm, inv):
    """``x[perm]`` (``:73-74``) whose backward is ``g[inv]``, a gather."""
    if perm is None:
        return x
    if x.requires_grad:
        return _Permute.apply(x, perm, inv)
    return x.index_select(0, perm)


def hgnn_aggregate_bsr(hgd, x, wdiag, first_aggr: str, plan: BsrPlan):
    """HGNN aggregation over a :class:`~hypergef_tpu_torch.sparse.bsr.BsrPlan`,
    sum or mean first aggregation (``:86-102``)."""
    d = plan.device(x.device)
    e_st, v_st = d.edge_stage, d.vertex_stage
    xe = bsr_matvec(_permute(x, d.vperm, d.vinv), e_st, v_st, e_st.num_rows)
    # the per-edge scalings live in the original edge ids: permute them once
    if first_aggr == "mean":
        cnt = (hgd.ht_indptr[1:] - hgd.ht_indptr[:-1]).to(x.dtype)[:, None]
        xe = xe / _permute(cnt, d.eperm, d.einv).clamp_min(1.0)
    xe = xe * _permute(hgd.degE, d.eperm, d.einv)
    if wdiag is not None:
        xe = xe * _permute(wdiag, d.eperm, d.einv)
    xv = bsr_matvec(xe, v_st, e_st, v_st.num_rows)
    xv = xv * _permute(hgd.degV, d.vperm, d.vinv)
    return _permute(xv, d.vinv, d.vperm)  # back to the original vertex order


def unignn_aggregate_bsr(hgd, x, use_deg: bool, plan: BsrPlan):
    """UniGNN aggregation over a BsrPlan (``:105-113``)."""
    d = plan.device(x.device)
    e_st, v_st = d.edge_stage, d.vertex_stage
    xe = bsr_matvec(_permute(x, d.vperm, d.vinv), e_st, v_st, e_st.num_rows)
    if use_deg:
        xe = xe * _permute(hgd.degE, d.eperm, d.einv)
    xv = bsr_matvec(xe, v_st, e_st, v_st.num_rows)
    if use_deg:
        xv = xv * _permute(hgd.degV, d.vperm, d.vinv)
    return _permute(xv, d.vinv, d.vperm)
