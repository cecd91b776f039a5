"""Stage-plan aggregation: the ``tree``, ``pallas_sparse``, ``aligned``,
``multihot`` and ``ell`` routes.

Port of ``hypergef_tpu/ops/tree.py``. A reduction-tree direction runs as

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

A tiled direction (:class:`~hypergef_tpu_torch.sparse.planner.TiledStageDev`,
``:31-63``) cuts level 0 at source tiles: the ``gather`` form runs its
chunks through the gather kernel over global rows; the ``multihot`` forms
(``multihot`` route) build each tile's multihot bf16 matrix by compare
(never a scatter), or read it built on the host (``multihot_precomp``),
and take one bf16 product with an f32 result a tile (:func:`bmm_f32`, a
library product as JAX leaves it to XLA). ``multihot`` builds and
multiplies a bounded run of tiles at a time (:data:`MULTIHOT_CHUNK_ELEMS`),
``multihot_batched`` every tile at once. Their partials are combined by a
plain tree or a nested multihot stage. An ELL direction
(:class:`~hypergef_tpu_torch.sparse.planner.EllStageDev`, the ``ell``
route) is the gather kernel's chunk sums, then the segment-sum kernel
(:mod:`.segment_sum`) over each segment's chunks.

The adjoint of the V→E stage is the E→V stage over the transposed CSR, so
:func:`tree_matvec`'s backward applies the other stage (``:481-499``): no
scatter in any derivative order, and the forward input is not saved.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from hypergef_tpu_torch.ops.aligned_band import aligned_band, aligned_band_plain
from hypergef_tpu_torch.ops.ell_gather import ell_gather_sum
from hypergef_tpu_torch.ops.segment_sum import gather_segment_sum
from hypergef_tpu_torch.sparse.planner import (
    AlignedStageBDev, AlignedStageDev, DeviceStage, EllStageDev, TiledStageDev,
)

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


def bmm_f32(a, b):
    """Batched ``a @ b`` of two bf16 operands with an f32 result that is
    not rounded to bf16 (JAX's ``dot_general(..., preferred_element_type=
    f32)``): on the card ``torch.bmm`` with ``out_dtype=torch.float32``; on
    the CPU, which has no such kernel, an f32 product of the bf16-valued
    operands (exact products, f32 sums)."""
    if a.device.type == "cuda":
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def multihot_tiles(gidx, mask, tile_rows: int):
    """The multihot bf16 matrices of a run of tiles (``:284-301``), [T, c,
    tile_rows] from ``gidx``/``mask`` [T, c, ngs]: row c is Σ_k mask[c,k]·
    onehot(gidx[c,k]), built by compare and summed over k in bf16, so
    repeats accumulate (0/1/2... are exact in bf16)."""
    iota = torch.arange(tile_rows, dtype=gidx.dtype, device=gidx.device)
    m = torch.zeros((*gidx.shape[:2], tile_rows), dtype=torch.bfloat16, device=gidx.device)
    for k in range(gidx.shape[2]):
        m = m + torch.where(gidx[:, :, k:k + 1] == iota, mask[:, :, k:k + 1],
                            0.0).to(torch.bfloat16)
    return m


def _tiles_bf16(x, st: TiledStageDev):
    """x rounded to bf16, zero-padded to whole tiles, [n_tiles, tile_rows, F]."""
    n_tiles = st.gidx.shape[0]
    xb = x.to(torch.bfloat16)
    pad = n_tiles * st.tile_rows - x.shape[0]
    if pad > 0:
        xb = F.pad(xb, (0, 0, 0, pad))
    return xb.reshape(n_tiles, st.tile_rows, x.shape[1])


# multihot elements the ``multihot`` form builds at a time (its run of tiles:
# 32 MiB of bf16), the bound on its scratch, where ``multihot_batched``
# builds every tile at once
MULTIHOT_CHUNK_ELEMS = 1 << 24


def _apply_tiled(x, st: TiledStageDev):
    """Level 0 of a tiled stage, then its combine (``:260-338``,
    ``:356-373``)."""
    n_tiles, c_max, _ = st.gidx.shape
    if st.form == "gather":
        flat = ell_gather_sum(x.contiguous(), st.gather0)
    else:
        xt = _tiles_bf16(x, st)
        if st.form == "multihot_precomp":
            partial = bmm_f32(st.m_dense, xt)
        elif st.form == "multihot_batched":
            partial = bmm_f32(multihot_tiles(st.gidx, st.mask, st.tile_rows), xt)
        elif st.form == "multihot":
            step = max(MULTIHOT_CHUNK_ELEMS // (c_max * st.tile_rows), 1)
            partial = torch.cat([
                bmm_f32(multihot_tiles(st.gidx[t:t + step], st.mask[t:t + step], st.tile_rows),
                        xt[t:t + step])
                for t in range(0, n_tiles, step)])
        else:
            raise ValueError(f"unknown tiled stage form {st.form!r}")
        flat = partial.reshape(n_tiles * c_max, x.shape[1])
    return _apply_combine(flat, st.combine)


def _apply_combine(flat, combine):
    """Partials combined by a plain tree stage or a nested tiled stage
    (``:250-257``)."""
    if isinstance(combine, TiledStageDev):
        return _apply_tiled(flat, combine)
    return _apply_stage(flat, combine)


def _apply_ell(x, st: EllStageDev):
    """An ELL direction (``ops/fused.py:167-189``): the chunk sums by the
    gather kernel, then each segment's chunks by the segment-sum kernel
    (the plain twins on the CPU); padded chunks are never read."""
    return gather_segment_sum(ell_gather_sum(x.contiguous(), st.gather), st.chunks)


def _apply_any(x, stage):
    """``:463-478``: a stage of any type."""
    if isinstance(stage, (AlignedStageBDev, AlignedStageDev)):
        return _apply_aligned(x, stage)
    if isinstance(stage, TiledStageDev):
        return _apply_tiled(x, stage)
    if isinstance(stage, EllStageDev):
        return _apply_ell(x, stage)
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
    ``bwd_stage`` encodes Mᵀ, which the backward applies (tree, aligned,
    tiled or ELL stages)."""
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
