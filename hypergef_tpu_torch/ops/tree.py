"""Stage-plan aggregation: the ``tree``, ``pallas_sparse`` and ``aligned``
routes.

Port of ``hypergef_tpu/ops/tree.py`` for plain and aligned stages. A
reduction-tree direction runs as

    gather source rows (ELL chunks)  →  masked in-chunk sum
    → levels of gather + masked fan-in sum  →  final per-segment map

over a :class:`~hypergef_tpu_torch.sparse.planner.DeviceStage`. In the
plain form (``tree`` route) every level is a torch gather and sum; in the
kernel form (``pallas_sparse`` route) level 0 is the CUDA gather kernel
(:mod:`.ell_gather`) and the deeper levels stay plain, as the JAX package
leaves them to XLA (``:341-353``). An aligned direction (``aligned`` route)
runs as banded products over source windows plus a spill product
(:mod:`.aligned_band`): the plain chain in the ``xla`` form, one launch of
the CUDA band kernel in a ``pallas_*`` form.

The adjoint of the V→E stage is the E→V stage over the transposed CSR, so
:func:`tree_matvec`'s backward applies the other stage (``:481-499``): no
scatter in any derivative order, and the forward input is not saved.
"""

from __future__ import annotations

import torch

from hypergef_tpu_torch.ops.aligned_band import aligned_band, aligned_band_plain
from hypergef_tpu_torch.ops.ell_gather import ell_gather_sum
from hypergef_tpu_torch.sparse.planner import AlignedStageBDev, AlignedStageDev, DeviceStage

# elements above which a level's [C, fan, F] gathered intermediate is not
# materialized; per-slot 2-D gathers are used instead (``:173-176``)
_LEVEL_3D_MAX_ELEMS = 1 << 22


def stage_counts(stage) -> torch.Tensor:
    """Members per output segment, f32 [S], of a stage of any type
    (``:165-170``)."""
    return stage.counts


def apply_level(p, g, m):
    """One fan-in combine level: ``y[c] = Σ_k p[g[c,k]] · m[c,k]``
    (``:179-191``); ``g`` is int64."""
    c, fan = g.shape
    f = p.shape[1]
    if c * fan * f <= _LEVEL_3D_MAX_ELEMS:
        gathered = p.index_select(0, g.reshape(-1)).reshape(c, fan, f)
        return (gathered * m[:, :, None]).sum(dim=1)
    acc = p.index_select(0, g[:, 0]) * m[:, 0:1]
    for k in range(1, fan):
        acc = acc + p.index_select(0, g[:, k]) * m[:, k : k + 1]
    return acc


def apply_levels(x, levels, final_idx, final_mask):
    """Combine levels, then the final per-segment map (``:194-204``);
    ``final_mask`` is f32 [S, 1]."""
    p = x
    for g, m in levels:
        p = apply_level(p, g, m)
    return p.index_select(0, final_idx) * final_mask


def _apply_stage(x, stage: DeviceStage):
    """Every level plain (``:244-247``)."""
    return apply_levels(x, stage.levels, stage.final_idx, stage.final_mask)


def _apply_kernel(x, stage: DeviceStage):
    """Level 0 by the gather kernel, deeper levels plain (``:341-353``)."""
    p = ell_gather_sum(x.contiguous(), stage.gather0)
    return apply_levels(p, stage.levels[1:], stage.final_idx, stage.final_mask)


def _apply_aligned(x, st):
    """An aligned stage, uniform (``:376-400``) or bucketed (``:413-460``):
    one launch of the band kernel in the kernel form, the plain chain
    otherwise."""
    if st.band is not None:
        return aligned_band(x.contiguous(), st)
    return aligned_band_plain(x, st)


def _apply_any(x, stage):
    """``:463-478`` for the ported stage types."""
    if isinstance(stage, (AlignedStageBDev, AlignedStageDev)):
        return _apply_aligned(x, stage)
    if stage.gather0 is not None:
        return _apply_kernel(x, stage)
    return _apply_stage(x, stage)


class _TreeMatvec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd_stage, bwd_stage):
        ctx.stages = (fwd_stage, bwd_stage)
        return _apply_any(x, fwd_stage)

    @staticmethod
    def backward(ctx, g):
        fwd_stage, bwd_stage = ctx.stages
        return tree_matvec(g, bwd_stage, fwd_stage), None, None


def tree_matvec(x, fwd_stage, bwd_stage):
    """``y = M x`` where ``fwd_stage`` encodes the 0/1 incidence map M and
    ``bwd_stage`` encodes Mᵀ, which the backward applies (tree or aligned
    stages)."""
    return _TreeMatvec.apply(x, fwd_stage, bwd_stage)


def hgnn_aggregate_tree(hgd, x, wdiag, first_aggr, plan):
    """HGNN aggregation over a :class:`TreePlan` (``:502-514``), sum or
    mean first aggregation; the plan's form picks the plain or the kernel
    form of its stages."""
    e_stage, v_stage = plan.device(x.device)
    xe = tree_matvec(x, e_stage, v_stage)
    if first_aggr == "mean":
        xe = xe / stage_counts(e_stage).clamp_min(1.0)[:, None]
    xe = xe * hgd.degE
    if wdiag is not None:
        xe = xe * wdiag
    xv = tree_matvec(xe, v_stage, e_stage)
    return xv * hgd.degV


def unignn_aggregate_tree(hgd, x, use_deg: bool, plan):
    """UniGNN aggregation over a :class:`TreePlan` (``:517-525``), in the
    plan's plain or kernel form."""
    e_stage, v_stage = plan.device(x.device)
    xe = tree_matvec(x, e_stage, v_stage)
    if use_deg:
        xe = xe * hgd.degE
    xv = tree_matvec(xe, v_stage, e_stage)
    if use_deg:
        xv = xv * hgd.degV
    return xv
