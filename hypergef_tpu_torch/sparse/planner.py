"""Aggregation plans: the host-built tables the routes consume.

Port of parts of ``hypergef_tpu/sparse/planner.py``, as the same NumPy
code, so every host table is bit-identical to the JAX package's:

* the ELL chunk table and the reduction tree (``:37-236``): ``EllTable``,
  :func:`build_ell`, :func:`choose_ngs`, ``TreeLevel``, ``TreeStage``,
  :func:`build_tree`;
* :class:`TreePlan`, :func:`plan_tree` (plain stages only) and
  :func:`plan_pallas_sparse` (``:239-431``, ``:935-949``), whose
  :meth:`TreePlan.device` puts the stages on a torch device;
* the aligned host layer (``:1010-1329``, ``:1405-1761``): the uniform
  :class:`AlignedStage` and bucketed :class:`AlignedStageB`, their builders
  and :func:`plan_aligned`, with the JAX planner's bucket-merge cost model;
* the int8 :class:`DenseIncidence` (``:433-515``) and the bf16
  propagation matrix :class:`DensePrecomp` (``:609-635``);
* an :class:`AggregationPlan` (``:540-557``) with the ``dense``, ``tree``,
  ``pallas_sparse``, ``aligned``, ``bitstream`` and ``precomp`` plans (the
  bit packs live beside their kernel, in
  :mod:`hypergef_tpu_torch.ops.bitstream`) and ``preferred_backend``;
* the routing ladder :func:`plan_aggregation` (``:638-782``) with its
  constants (``:560-606``).

The tiled, BSR and multihot plan forms are left out (ROADMAP.md, "Do not
port"); the v5e floor model ``aligned_stage_floor``/``aligned_plan_floor``
is not ported yet (ROADMAP.md queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from hypergef_tpu_torch.ops.ell_gather import GatherTable

if TYPE_CHECKING:
    from hypergef_tpu_torch.ops.aligned_band import BandTable
    from hypergef_tpu_torch.ops.bitstream import BitIncidence


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class EllTable(NamedTuple):
    """Padded ELL chunk table for one aggregation direction (``:37-53``).

    ``gather_idx[c, k]`` is the source row to read for slot k of chunk c
    (0 for padded slots — always masked), ``mask[c, k]`` is 1.0 for live
    slots, ``seg_ids[c]`` is the (non-decreasing) output segment of chunk
    c (== num_segments for padded chunks), and ``seg_ptr`` maps each
    output segment to its chunk range.
    """

    gather_idx: np.ndarray  # [C_pad, ngs] int32
    mask: np.ndarray  # [C_pad, ngs] f32
    seg_ids: np.ndarray  # [C_pad] int32
    seg_ptr: np.ndarray  # [num_segments+1] int64 (chunk ranges, unpadded region)
    num_chunks: int  # true number of chunks (≤ C_pad)
    num_segments: int
    ngs: int


def build_ell(
    indptr: np.ndarray,
    indices: np.ndarray,
    ngs: int,
    pad_chunks_to: int = 8,
) -> EllTable:
    """Chunk CSR rows into an ELL table with ≤ ``ngs`` entries per chunk
    (``:56-110``): row r with nnz_r entries contributes ⌈nnz_r/ngs⌉ chunks
    starting every ``ngs`` entries."""
    if ngs <= 0:
        raise ValueError("ngs must be positive")
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int32)
    num_rows = indptr.shape[0] - 1
    row_len = np.diff(indptr)
    chunks_per_row = -(-row_len // ngs)  # ceil
    num_chunks = int(chunks_per_row.sum())
    seg_ptr = np.zeros(num_rows + 1, dtype=np.int64)
    np.cumsum(chunks_per_row, out=seg_ptr[1:])

    c_pad = max(_round_up(max(num_chunks, 1), pad_chunks_to), pad_chunks_to)
    gather_idx = np.zeros((c_pad, ngs), dtype=np.int32)
    mask = np.zeros((c_pad, ngs), dtype=np.float32)
    seg_ids = np.full(c_pad, num_rows, dtype=np.int32)

    if num_chunks:
        # chunk → owning row (vectorized via searchsorted on the chunk ptr)
        chunk_row = (
            np.searchsorted(seg_ptr, np.arange(num_chunks, dtype=np.int64), side="right") - 1
        ).astype(np.int64)
        seg_ids[:num_chunks] = chunk_row.astype(np.int32)
        # start offset of each chunk inside the CSR nnz array
        chunk_rank = np.arange(num_chunks, dtype=np.int64) - seg_ptr[chunk_row]
        chunk_start = indptr[chunk_row] + chunk_rank * ngs
        chunk_size = np.minimum(indptr[chunk_row + 1] - chunk_start, ngs)
        # scatter nnz entries into the padded table
        slot = np.arange(ngs, dtype=np.int64)[None, :]
        src = chunk_start[:, None] + slot  # [num_chunks, ngs]
        live = slot < chunk_size[:, None]
        src_clipped = np.minimum(src, indices.shape[0] - 1 if indices.size else 0)
        gather_idx[:num_chunks] = np.where(live, indices[src_clipped], 0)
        mask[:num_chunks] = live.astype(np.float32)

    return EllTable(
        gather_idx=gather_idx,
        mask=mask,
        seg_ids=seg_ids,
        seg_ptr=seg_ptr,
        num_chunks=num_chunks,
        num_segments=num_rows,
        ngs=ngs,
    )


def choose_ngs(
    row_len: np.ndarray,
    min_ngs: int = 2,
    max_ngs: int = 512,
    chunk_overhead: float = 8.0,
    step: int = 8,
) -> int:
    """Chunk width minimizing ``padded_slots + chunk_overhead · num_chunks``
    over the candidates {2, 4} and multiples of ``step`` (``:113-143``)."""
    row_len = np.asarray(row_len, dtype=np.int64)
    if row_len.size == 0:
        return min_ngs
    candidates = [c for c in (2, 4) if c >= min_ngs]
    candidates += list(range(max(min_ngs, 8), max_ngs + 1, step))
    best, best_cost = candidates[0], np.inf
    for ngs in candidates:
        chunks = -(-row_len // ngs)
        cost = float((chunks * ngs).sum()) + chunk_overhead * float(chunks.sum())
        if cost < best_cost:
            best, best_cost = ngs, cost
    return best


class TreeLevel(NamedTuple):
    gather_idx: np.ndarray  # [C, fan] int32 — rows of the previous level
    mask: np.ndarray  # [C, fan] f32


class TreeStage(NamedTuple):
    """One aggregation direction as a fixed-fan-in reduction tree
    (``:154-174``). Applying the stage to x [num_inputs, F]:

        p = x
        for (g, m) in levels:  p = Σ_k p[g[:, k]] · m[:, k]
        y = p[final_idx] · final_mask                  # [S, F]

    Level 0 gathers source rows (ELL chunks of the CSR); deeper levels
    combine sibling partials of the same output segment, fan at a time.
    """

    levels: tuple  # tuple[TreeLevel]
    final_idx: np.ndarray  # [S] int32 — last-level row per segment (0 if empty)
    final_mask: np.ndarray  # [S] f32 — 0 for empty segments
    counts: np.ndarray  # [S] f32 — members per segment (for mean)
    num_inputs: int
    num_segments: int


def build_tree(
    indptr: np.ndarray,
    indices: np.ndarray,
    num_inputs: int,
    ngs: int = 8,
    fan: int = 8,
) -> TreeStage:
    """Build the reduction-tree schedule for one CSR direction (``:177-236``)."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int32)
    num_rows = indptr.shape[0] - 1
    row_len = np.diff(indptr)

    # ---- level 0: ELL chunks over the CSR nnz --------------------------
    t0 = build_ell(indptr, indices, ngs, pad_chunks_to=1)
    levels = [TreeLevel(gather_idx=t0.gather_idx, mask=t0.mask)]
    # rows-per-segment at the current level
    seg_counts = (-(-row_len // ngs)).astype(np.int64)  # chunks per segment

    # ---- deeper levels: combine fan siblings of the same segment -------
    while seg_counts.max(initial=0) > 1:
        new_counts = -(-seg_counts // fan)
        c_new = int(new_counts.sum())
        prev_ptr = np.zeros(num_rows + 1, dtype=np.int64)
        np.cumsum(seg_counts, out=prev_ptr[1:])
        new_ptr = np.zeros(num_rows + 1, dtype=np.int64)
        np.cumsum(new_counts, out=new_ptr[1:])
        g = np.zeros((max(c_new, 1), fan), dtype=np.int32)
        m = np.zeros((max(c_new, 1), fan), dtype=np.float32)
        if c_new:
            new_id = np.arange(c_new, dtype=np.int64)
            seg_of_new = (
                np.searchsorted(new_ptr, new_id, side="right") - 1
            )
            rank = new_id - new_ptr[seg_of_new]
            start = prev_ptr[seg_of_new] + rank * fan
            size = np.minimum(prev_ptr[seg_of_new + 1] - start, fan)
            slot = np.arange(fan, dtype=np.int64)[None, :]
            src = start[:, None] + slot
            live = slot < size[:, None]
            g[:] = np.where(live, np.minimum(src, max(int(prev_ptr[-1]) - 1, 0)), 0)
            m[:] = live.astype(np.float32)
        levels.append(TreeLevel(gather_idx=g, mask=m))
        seg_counts = new_counts

    # ---- final map: one row (or none) per segment ----------------------
    last_ptr = np.zeros(num_rows + 1, dtype=np.int64)
    np.cumsum(seg_counts, out=last_ptr[1:])
    final_idx = np.minimum(last_ptr[:-1], max(int(last_ptr[-1]) - 1, 0)).astype(
        np.int32
    )
    final_mask = (seg_counts > 0).astype(np.float32)
    return TreeStage(
        levels=tuple(levels),
        final_idx=final_idx,
        final_mask=final_mask,
        counts=row_len.astype(np.float32),
        num_inputs=num_inputs,
        num_segments=num_rows,
    )


@dataclasses.dataclass(frozen=True)
class DeviceStage:
    """A :class:`TreeStage` on one torch device.

    ``levels`` hold int64 gather tables for the plain form (made once,
    here, not on every call). In the kernel form ``gather0`` is level 0 as
    an int32 table checked once for the gather kernel; the deeper levels
    stay plain, as JAX leaves them to XLA (``ops/tree.py:341-353``).
    """

    levels: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]  # (int64 [C, fan], f32 [C, fan])
    final_idx: torch.Tensor  # int64 [S]
    final_mask: torch.Tensor  # f32 [S, 1]
    counts: torch.Tensor  # f32 [S]
    num_inputs: int
    num_segments: int
    gather0: Optional[GatherTable] = None

    @classmethod
    def from_stage(cls, st: TreeStage, device, kernel_level0: bool) -> "DeviceStage":
        device = torch.device(device)

        def put(a, dtype):
            return torch.as_tensor(np.asarray(a), device=device).to(dtype).contiguous()

        levels = tuple((put(l.gather_idx, torch.int64), put(l.mask, torch.float32))
                       for l in st.levels)
        gather0 = None
        if kernel_level0:
            g0 = st.levels[0]
            gather0 = GatherTable(
                gidx=put(g0.gather_idx, torch.int32), gidx_long=levels[0][0],
                mask=levels[0][1], num_inputs=st.num_inputs)
        return cls(
            levels=levels,
            final_idx=put(st.final_idx, torch.int64),
            final_mask=put(st.final_mask, torch.float32)[:, None].contiguous(),
            counts=put(st.counts, torch.float32),
            num_inputs=st.num_inputs,
            num_segments=st.num_segments,
            gather0=gather0,
        )


class AlignedBucketDev(NamedTuple):
    """One band bucket on a device (``ops/tree.py:91-102``)."""

    b_dense: torch.Tensor  # int8 [ng_b, G, W], a view of the stage's flat band table
    win_block: torch.Tensor  # int64 [ng_b, w]


class AlignedSpillDev(NamedTuple):
    """One spill bucket on a device (``ops/tree.py:105-115``)."""

    b_spill: torch.Tensor  # int8 [m_b, G, sw], a view of the stage's flat spill table
    spill_src: torch.Tensor  # int64 [m_b, sw]


@dataclasses.dataclass(frozen=True)
class AlignedStageBDev:
    """An :class:`AlignedStageB` on one torch device (``ops/tree.py:118-146``,
    built as ``planner.py:263-306`` builds it).

    The tables stay int8. ``num_blocks`` is the count of source blocks the
    windows reach; the plain form zero-pads x to it. In the kernel form
    ``band`` holds the band kernel's tables; the plain tensors are views of
    the same device memory.
    """

    buckets: Tuple[AlignedBucketDev, ...]
    spills: Tuple[AlignedSpillDev, ...]
    base_slot: torch.Tensor  # int64 [n_groups]
    spill_slot: torch.Tensor  # int64 [n_groups]
    counts: torch.Tensor  # f32 [S]
    num_inputs: int
    num_segments: int
    group_rows: int
    block_rows: int
    num_blocks: int
    # the assembly gathers are skipped where their slot maps are the identity
    base_identity: bool = False
    spill_identity: bool = False
    band: Optional["BandTable"] = None


@dataclasses.dataclass(frozen=True)
class AlignedStageDev:
    """An :class:`AlignedStage` (uniform form) on one torch device
    (``ops/tree.py:65-88``); ``num_blocks`` and ``band`` as in
    :class:`AlignedStageBDev`."""

    b_dense: torch.Tensor  # int8 [n_groups, G, W]
    win_block: torch.Tensor  # int64 [n_groups, wb]
    spill_src: torch.Tensor  # int64 [n_groups, spill_w]
    b_spill: torch.Tensor  # int8 [n_groups, G, spill_w]
    counts: torch.Tensor  # f32 [S]
    num_inputs: int
    num_segments: int
    group_rows: int
    window_blocks: int
    num_blocks: int
    band: Optional["BandTable"] = None


def _flat_on_device(tables, device):
    """int8 tables concatenated into one flat tensor on ``device``, put there
    once; returns it and a view of it shaped like each table."""
    flat = torch.as_tensor(
        np.concatenate([t.reshape(-1) for t in tables]) if tables else np.zeros(0, np.int8),
        device=device)
    views, off = [], 0
    for t in tables:
        views.append(flat[off:off + t.size].view(t.shape))
        off += t.size
    return flat, views


def _aligned_device(st, device, kernel: bool):
    """An aligned host stage on ``device``, with the band kernel's tables
    when ``kernel``. ``TreePlan._stage_device`` (``planner.py:263-322``)."""
    uniform = isinstance(st, AlignedStage)
    if uniform:
        n_groups = st.win_block.shape[0]
        all_groups = np.arange(n_groups)
        buckets = [(st.b_dense, st.win_block, all_groups)]
        spills = [(st.b_spill, st.spill_src, all_groups)] if st.spill_src.shape[1] else []
        block_rows = ALIGNED_BLOCK
    else:
        buckets = [(b.b_dense, b.win_block, b.group_ids) for b in st.buckets]
        spills = [(s.b_spill, s.spill_src, s.group_ids) for s in st.spills]
        block_rows = st.block_rows
    band_flat, bands = _flat_on_device([b for b, _, _ in buckets], device)
    spill_flat, spill_tabs = _flat_on_device([t for t, _, _ in spills], device)
    wins = [torch.as_tensor(w, device=device).long() for _, w, _ in buckets]
    srcs = [torch.as_tensor(s, device=device).long() for _, s, _ in spills]
    num_blocks = max(-(-st.num_inputs // block_rows),
                     max(int(w.max(initial=0)) + 1 for _, w, _ in buckets), 1)
    band = None
    if kernel:
        from hypergef_tpu_torch.ops.aligned_band import BandTable

        band = BandTable.build(
            band_flat, spill_flat, [(w, g) for _, w, g in buckets],
            [(s, g) for _, s, g in spills], st.num_inputs, st.num_segments,
            st.group_rows, block_rows)
    counts = torch.as_tensor(st.counts, device=device)
    if uniform:
        spill_w = st.spill_src.shape[1]
        return AlignedStageDev(
            b_dense=bands[0],
            win_block=wins[0],
            spill_src=srcs[0] if srcs else torch.zeros((n_groups, 0), dtype=torch.int64,
                                                       device=device),
            b_spill=spill_tabs[0] if spill_tabs else torch.zeros(
                (n_groups, st.group_rows, spill_w), dtype=torch.int8, device=device),
            counts=counts, num_inputs=st.num_inputs, num_segments=st.num_segments,
            group_rows=st.group_rows, window_blocks=st.window_blocks,
            num_blocks=num_blocks, band=band,
        )
    return AlignedStageBDev(
        buckets=tuple(AlignedBucketDev(b, w) for b, w in zip(bands, wins)),
        spills=tuple(AlignedSpillDev(t, s) for t, s in zip(spill_tabs, srcs)),
        base_slot=torch.as_tensor(st.base_slot, device=device).long(),
        spill_slot=torch.as_tensor(st.spill_slot, device=device).long(),
        counts=counts, num_inputs=st.num_inputs, num_segments=st.num_segments,
        group_rows=st.group_rows, block_rows=block_rows, num_blocks=num_blocks,
        base_identity=bool(np.array_equal(st.base_slot, np.arange(len(st.base_slot)))),
        # identity needs the one spill bucket to cover EVERY group: a trailing
        # non-spilling group's zero-row slot (== m_total) would continue the
        # arange and alias
        spill_identity=bool(
            len(st.spills) == 1
            and st.spills[0].b_spill.shape[0] == len(st.spill_slot)
            and np.array_equal(st.spill_slot, np.arange(len(st.spill_slot)))),
        band=band,
    )


def _stage_device(st, device, kernel: bool):
    """A host stage of any type on ``device``."""
    if isinstance(st, (AlignedStage, AlignedStageB)):
        return _aligned_device(st, device, kernel)
    return DeviceStage.from_stage(st, device, kernel)


# What a plan's form means for each stage type. "xla": every stage plain
# (tree levels as torch gathers and sums; aligned stages as the block
# gather, bmm and slot-assembly chain). "pallas_*": a tree stage's level 0
# runs the gather kernel (ops/ell_gather.py), deeper levels stay plain; an
# aligned stage runs whole as one launch of the band kernel
# (ops/aligned_band.py). The TPU's vmem/dma variants were a VMEM-capacity
# split; on the card they are one kernel, so the three pallas forms run
# alike.
TREE_FORMS = ("xla", "pallas_auto", "pallas_vmem", "pallas_dma")


@dataclasses.dataclass
class TreePlan:
    """Two-direction stage plan (``:239-388``): reduction-tree stages
    (:func:`plan_tree`) or aligned stages (:func:`plan_aligned`).

    ``edge_stage`` computes V→E (rows = hyperedges, inputs = vertices),
    ``vertex_stage`` computes E→V. Each stage is the exact adjoint of the
    other (H vs Hᵀ), which the tree op's backward uses.

    The device stages are cached per device and are not an init field, so a
    copy made with ``dataclasses.replace(plan, form=...)`` builds its own
    (in its own form) instead of sharing the original's.
    """

    edge_stage: TreeStage  # or AlignedStage / AlignedStageB
    vertex_stage: TreeStage
    num_nodes: int
    num_edges: int
    form: str = "xla"
    _device: Dict[torch.device, tuple] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    def __post_init__(self):
        if self.form not in TREE_FORMS:
            raise ValueError(f"form must be one of {TREE_FORMS}, got {self.form!r}")

    def device(self, device) -> tuple:
        """(edge stage, vertex stage) on ``device``, built and checked once
        per device: :class:`DeviceStage`, :class:`AlignedStageBDev` or
        :class:`AlignedStageDev`, after the host stages' type."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device not in self._device:
            kernel = self.form != "xla"
            self._device[device] = (
                _stage_device(self.edge_stage, device, kernel),
                _stage_device(self.vertex_stage, device, kernel),
            )
        return self._device[device]

    def depth(self):
        return (len(self.edge_stage.levels), len(self.vertex_stage.levels))


# Cache-blocked (tiled) level 0 is opt-in in the JAX package and off by
# default (``:390-396``); it is not ported.
TILED_SOURCE_THRESHOLD = 1 << 62


def plan_tree(hg, ngs: Optional[int] = None, ngs_vertex: Optional[int] = None,
              fan: int = 8, tiled_threshold: int = TILED_SOURCE_THRESHOLD) -> TreePlan:
    """Build the two-direction reduction-tree plan for a hypergraph
    (``:399-430``), plain stages only."""
    if max(hg.num_nodes, hg.num_edges) > tiled_threshold:
        raise NotImplementedError(
            "tiled (cache-blocked) tree stages are not ported; the JAX package "
            "builds them only below an explicit tiled_threshold")
    if ngs is None:
        ngs = choose_ngs(hg.edge_sizes(), min_ngs=4, max_ngs=64, step=4)
    if ngs_vertex is None:
        ngs_vertex = choose_ngs(hg.vertex_degrees(), min_ngs=4, max_ngs=64, step=4)
    return TreePlan(
        edge_stage=build_tree(hg.ht_indptr, hg.ht_indices, hg.num_nodes, ngs, fan),
        vertex_stage=build_tree(hg.h_indptr, hg.h_indices, hg.num_edges, ngs_vertex, fan),
        num_nodes=hg.num_nodes,
        num_edges=hg.num_edges,
    )


def plan_pallas_sparse(hg, impl: str = "auto", ngs: Optional[int] = None,
                       fan: int = 8) -> TreePlan:
    """Tree plan whose level 0 runs as the gather kernel (``:935-949``).
    ``impl`` names the TPU variant and is kept for the same call; every
    variant runs the one CUDA kernel."""
    plan = plan_tree(hg, ngs=ngs, fan=fan)
    return TreePlan(
        edge_stage=plan.edge_stage,
        vertex_stage=plan.vertex_stage,
        num_nodes=plan.num_nodes,
        num_edges=plan.num_edges,
        form=f"pallas_{impl}",
    )


class AlignedStage(NamedTuple):
    """Segment-aligned banded stage, uniform form (``:1010-1052``), for
    community-sorted graphs.

    Output rows are the segments in order: group g computes segments
    [g·G, (g+1)·G). Each group reads a contiguous window of ``wb`` source
    blocks of 128 rows and multiplies it by its int8 band ``b_dense[g]``
    [G, wb·128]; the few entries outside the window ("spill") go through a
    gather of spill rows and a second small product. Applying it:
    :func:`hypergef_tpu_torch.ops.tree._apply_aligned`.
    """

    b_dense: np.ndarray  # [n_groups, G, W] int8 counts
    win_block: np.ndarray  # [n_groups, wb] int32 — source block ids
    spill_src: np.ndarray  # [n_groups, spill_w] int32 (num_inputs = zero row)
    b_spill: np.ndarray  # [n_groups, G, spill_w] int8
    counts: np.ndarray  # [num_segments] f32 — members per segment
    num_inputs: int
    num_segments: int
    group_rows: int  # G
    window_blocks: int  # wb

    @property
    def spill_fraction(self) -> float:
        total = float(self.b_dense.sum() + self.b_spill.sum())
        return float(self.b_spill.sum()) / max(total, 1.0)


ALIGNED_BLOCK = 128  # source block granularity (rows)


def _aligned_windows(grp, blk, n_groups, nb, wb):
    """Per-group window start block: median member block, clamped
    (``:1058-1072``)."""
    order = np.lexsort((blk, grp))
    gs, bs = grp[order], blk[order]
    cnt = np.bincount(gs, minlength=n_groups)
    start = np.cumsum(cnt) - cnt
    med = np.zeros(n_groups, dtype=np.int64)
    nz = cnt > 0
    med[nz] = bs[(start + cnt // 2)[nz]]
    o = np.clip(med - wb // 2, 0, max(nb - wb, 0))
    o[~nz] = 0
    return o


def aligned_spill_stats(indptr, indices, num_inputs, group_rows=128,
                        window_blocks=4):
    """The spill fraction a uniform stage would have, without building its
    tables (``:1075-1091``)."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    S = len(indptr) - 1
    if indices.size == 0 or S == 0:
        return 0.0
    n_groups = -(-S // group_rows)
    nb = max(-(-num_inputs // ALIGNED_BLOCK), window_blocks)
    seg = np.repeat(np.arange(S, dtype=np.int64), np.diff(indptr))
    grp = seg // group_rows
    blk = indices // ALIGNED_BLOCK
    o = _aligned_windows(grp, blk, n_groups, nb, window_blocks)
    og = o[grp]
    spill = (blk < og) | (blk >= og + window_blocks)
    return float(spill.mean())


def build_aligned_stage(
    indptr: np.ndarray,
    indices: np.ndarray,
    num_inputs: int,
    group_rows: int = 128,
    window_blocks: int = 4,
    spill_limit: int = 1 << 28,
) -> AlignedStage:
    """One direction's uniform aligned stage (``:1094-1171``). Raises
    ``MemoryError`` when the padded spill table would exceed
    ``spill_limit`` int8 entries (a spill-heavy graph)."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    S = len(indptr) - 1
    G = group_rows
    wb = window_blocks
    W = wb * ALIGNED_BLOCK
    n_groups = max(-(-S // G), 1)
    nb = max(-(-num_inputs // ALIGNED_BLOCK), wb)
    counts = np.diff(indptr).astype(np.float32)
    if indices.size == 0:
        return AlignedStage(
            b_dense=np.zeros((n_groups, G, W), np.int8),
            win_block=np.zeros((n_groups, wb), np.int32),
            spill_src=np.zeros((n_groups, 0), np.int32),
            b_spill=np.zeros((n_groups, G, 0), np.int8),
            counts=counts, num_inputs=num_inputs, num_segments=S,
            group_rows=G, window_blocks=wb,
        )
    seg = np.repeat(np.arange(S, dtype=np.int64), np.diff(indptr))
    grp = seg // G
    row_in_g = seg % G
    blk = indices // ALIGNED_BLOCK
    o = _aligned_windows(grp, blk, n_groups, nb, wb)
    og = o[grp]
    in_win = (blk >= og) & (blk < og + wb)
    # dedup-count instead of np.add.at, so no int8 count can wrap
    b_dense = np.zeros((n_groups, G, W), np.int8)
    key = (grp[in_win] * G + row_in_g[in_win]) * W + (
        indices[in_win] - og[in_win] * ALIGNED_BLOCK)
    uk, cnts = np.unique(key, return_counts=True)
    if cnts.size and cnts.max() > 127:
        raise MemoryError("aligned stage: >127 duplicate incidences in one "
                          "(segment, source) pair — not an incidence matrix?")
    b_dense.reshape(-1)[uk] = cnts.astype(np.int8)
    win_block = (o[:, None] + np.arange(wb)[None, :]).astype(np.int32)
    # spill: entries outside the window, grouped and slotted per group
    sp = ~in_win
    sgrp, srow, ssrc = grp[sp], row_in_g[sp], indices[sp]
    order = np.argsort(sgrp, kind="stable")
    sgrp, srow, ssrc = sgrp[order], srow[order], ssrc[order]
    per_g = np.bincount(sgrp, minlength=n_groups)
    spill_w = int(per_g.max(initial=0))
    if n_groups * G * spill_w > spill_limit:
        raise MemoryError(
            f"aligned stage spill table {n_groups}x{G}x{spill_w} > "
            f"{spill_limit} entries (spill-heavy graph; spill fraction "
            f"{sp.mean():.2f}) — use the tree or multihot backend"
        )
    spill_src = np.full((n_groups, max(spill_w, 0)), num_inputs, np.int32)
    b_spill = np.zeros((n_groups, G, max(spill_w, 0)), np.int8)
    if spill_w:
        starts = np.zeros(n_groups + 1, dtype=np.int64)
        np.cumsum(per_g, out=starts[1:])
        slot = np.arange(len(sgrp), dtype=np.int64) - starts[sgrp]
        spill_src[sgrp, slot] = ssrc.astype(np.int32)
        b_spill[sgrp, srow, slot] = 1
    return AlignedStage(
        b_dense=b_dense, win_block=win_block, spill_src=spill_src,
        b_spill=b_spill, counts=counts, num_inputs=num_inputs,
        num_segments=S, group_rows=G, window_blocks=wb,
    )


def plan_aligned(
    hg,
    group_rows: int = 128,
    window_blocks: Optional[int] = None,
    max_spill: float = 0.25,
    spill_limit: int = 1 << 28,
    form: str = "bucketed",
    feat_bytes: int = 64,
    block_rows: int = ALIGNED_BLOCK,
    spill_fudge: int = 256,
) -> TreePlan:
    """Two-direction aligned plan for a community-sorted graph
    (``:1174-1265``).

    ``form="bucketed"`` (default) builds :class:`AlignedStageB` stages;
    ``form="uniform"`` builds :class:`AlignedStage` stages, and there
    ``window_blocks=None`` sweeps (2, 4, 6, 8) per stage and keeps the
    smallest whose spill fraction is within 1.2× of the best. Raises
    ``ValueError`` when a direction would spill more than ``max_spill`` of
    its entries (the graph is not community-sorted: run
    :func:`hypergef_tpu_torch.sparse.reorder.community_reorder` first).

    The plan's ``form`` is ``"xla"`` (the plain band products); a copy with
    a ``pallas_*`` form, ``dataclasses.replace(plan, form="pallas_auto")``,
    runs the band kernel. Unlike the JAX package this builds no device
    tables: :meth:`TreePlan.device` does, once per device.
    """

    def feasibility(indptr, indices, n_in):
        # the median-window check; the bucketed per-group windows only
        # ever spill less
        fr = aligned_spill_stats(indptr, indices, n_in, group_rows,
                                 window_blocks or 8)
        if fr > max_spill:
            raise ValueError(
                f"aligned plan spill fraction {fr:.2f} > {max_spill} — "
                "graph is not community-sorted; run community_reorder first"
            )
        return fr

    def choose(indptr, indices, n_in):
        cands = (2, 4, 6, 8) if window_blocks is None else (window_blocks,)
        fr = [aligned_spill_stats(indptr, indices, n_in, group_rows, wb)
              for wb in cands]
        best = min(fr)
        if best > max_spill:
            raise ValueError(
                f"aligned plan spill fraction {best:.2f} > {max_spill} — "
                "graph is not community-sorted; run community_reorder first"
            )
        for wb, f in zip(cands, fr):
            if f <= best * 1.2 + 1e-9:
                return wb
        return cands[-1]

    if form == "bucketed":
        feasibility(hg.ht_indptr, hg.ht_indices, hg.num_nodes)
        feasibility(hg.h_indptr, hg.h_indices, hg.num_edges)
        # the default window span is 8 blocks of 128 rows; finer block_rows
        # keep the same span with more blocks
        max_w = window_blocks or max(8 * ALIGNED_BLOCK // block_rows, 8)
        e_stage = build_aligned_stage_bucketed(
            hg.ht_indptr, hg.ht_indices, hg.num_nodes, group_rows,
            max_width=max_w, feat_bytes=feat_bytes,
            spill_limit=spill_limit, block_rows=block_rows,
            spill_fudge=spill_fudge,
        )
        v_stage = build_aligned_stage_bucketed(
            hg.h_indptr, hg.h_indices, hg.num_edges, group_rows,
            max_width=max_w, feat_bytes=feat_bytes,
            spill_limit=spill_limit, block_rows=block_rows,
            spill_fudge=spill_fudge,
        )
    elif form == "uniform":
        wb_e = choose(hg.ht_indptr, hg.ht_indices, hg.num_nodes)
        wb_v = choose(hg.h_indptr, hg.h_indices, hg.num_edges)
        e_stage = build_aligned_stage(
            hg.ht_indptr, hg.ht_indices, hg.num_nodes, group_rows, wb_e,
            spill_limit,
        )
        v_stage = build_aligned_stage(
            hg.h_indptr, hg.h_indices, hg.num_edges, group_rows, wb_v,
            spill_limit,
        )
    else:
        raise ValueError(f"plan_aligned form must be bucketed|uniform, got {form!r}")
    return TreePlan(
        edge_stage=e_stage,
        vertex_stage=v_stage,
        num_nodes=hg.num_nodes,
        num_edges=hg.num_edges,
    )


class AlignedBucket(NamedTuple):
    """One window-width bucket of a bucketed aligned stage (``:1268-1274``):
    the groups whose cost-optimal window is ``width`` blocks wide."""

    b_dense: np.ndarray  # [ng_b, G, width*block_rows] int8 band tables
    win_block: np.ndarray  # [ng_b, width] int32 source block ids
    group_ids: np.ndarray  # [ng_b] int32 global group ids (sorted)


class AlignedSpill(NamedTuple):
    """One spill-width bucket (``:1277-1283``): groups with similar
    out-of-window entry counts share a padded table."""

    b_spill: np.ndarray  # [m_b, G, sw] int8
    spill_src: np.ndarray  # [m_b, sw] int32 (num_inputs = zero row)
    group_ids: np.ndarray  # [m_b] int32


class AlignedStageB(NamedTuple):
    """Bucketed aligned stage (``:1286-1329``): the math of
    :class:`AlignedStage`, but each group streams only the window width it
    needs (groups bucketed by a per-group cost-optimal width), and spill
    tables hold only spilling groups, bucketed by spill width. The JAX
    package assembles the output with two block-granular gathers
    (``base_slot``, ``spill_slot``); the port's band kernel writes each
    group's rows in place and needs neither.
    """

    buckets: tuple  # of AlignedBucket
    spills: tuple  # of AlignedSpill
    base_slot: np.ndarray  # [n_groups] int32 — row of group g in concat(bucket outs)
    spill_slot: np.ndarray  # [n_groups] int32 — row in concat(spill outs), m_total = zero
    counts: np.ndarray  # [num_segments] f32
    num_inputs: int
    num_segments: int
    group_rows: int
    block_rows: int = 128  # source block granularity

    @property
    def spill_fraction(self) -> float:
        dense = sum(float(b.b_dense.sum()) for b in self.buckets)
        spill = sum(float(s.b_spill.sum()) for s in self.spills)
        return spill / max(dense + spill, 1.0)

    @property
    def window_blocks(self):
        """Bucket widths (blocks), widest first."""
        return tuple(sorted((b.win_block.shape[1] for b in self.buckets),
                            reverse=True))

    def table_bytes(self) -> int:
        """Band and spill table footprint (int8 entries, int32 sources)."""
        return int(
            sum(b.b_dense.size for b in self.buckets)
            + sum(s.b_spill.size + 4 * s.spill_src.size for s in self.spills)
        )


# The JAX planner's cost-model constants (``:1341-1343``, ``:1499-1505``),
# measured on a TPU v5e: an MXU operand element rate, an int8 HBM stream
# rate, a gather cost per spilled row, a fixed cost per XLA kernel, kernels
# per band bucket, and a padded-spill-slot gather charge. They are NOT
# numbers of the card. They are carried verbatim so that both packages
# build the same plan for a graph; pricing the bucket merge for the H100 is
# later work (ROADMAP.md).
ALIGNED_A_ELEM_RATE = 768e9
ALIGNED_STREAM_BPS = 732e9
ALIGNED_GATHER_S_PER_ROW = 8e-9
ALIGNED_KERNEL_FIXED_S = 4.4e-6
ALIGNED_KERNELS_PER_BUCKET = 2
ALIGNED_SPILL_PAD_GATHER_S = 4e-9


def _group_windows_opt(grp, blk, cnt_per_group, nb, max_width, G,
                       feat_bytes=64,
                       widths=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32),
                       block_rows=128, spill_fudge=256):
    """Per-group cost-optimal (offset, width) (``:1405-1489``, the NumPy
    loop; the JAX package's native twin is held bit-identical to it).

    For each candidate width w a group's best window covers the most of its
    entries; the modeled cost per group is

        cost(w) = w · (G·block_rows band bytes + block_rows·feat_bytes rows)
                + spill(w) · (G band column + feat_bytes row + fudge)

    Returns (offset[n_groups] int64, width[n_groups] int64).
    """
    n_groups = len(cnt_per_group)
    widths = tuple(w for w in widths if w <= max_width) or (max_width,)
    # one combined-key stable sort: grp is non-decreasing, so the
    # group-separated key sorts blk within groups
    sep = nb + max(widths) + 1
    key0 = grp * sep + blk
    order = np.argsort(key0, kind="stable")
    gs, bs, key = grp[order], blk[order], key0[order]
    starts = np.zeros(n_groups + 1, dtype=np.int64)
    np.cumsum(cnt_per_group, out=starts[1:])
    nonempty = cnt_per_group > 0
    ne_starts = starts[:-1][nonempty]
    j = np.arange(len(gs), dtype=np.int64)
    block_cost = G * block_rows + block_rows * feat_bytes
    spill_cost = G + feat_bytes + spill_fudge
    best_cost = np.full(n_groups, np.inf)
    best_off = np.zeros(n_groups, dtype=np.int64)
    best_w = np.full(n_groups, widths[0], dtype=np.int64)
    for w in widths:
        if len(gs):
            right = np.searchsorted(key, key + w, side="left")
            cover = right - j
            # per-group max coverage and its LAST position (the largest
            # block offset among equal-coverage windows)
            maxcov = np.zeros(n_groups, dtype=np.int64)
            maxcov[nonempty] = np.maximum.reduceat(cover, ne_starts)
            is_max = cover == maxcov[gs]
            last = np.zeros(n_groups, dtype=np.int64)
            last[nonempty] = np.maximum.reduceat(
                np.where(is_max, j, -1), ne_starts)
            off_w = np.zeros(n_groups, dtype=np.int64)
            off_w[nonempty] = np.minimum(
                bs[last[nonempty]], max(nb - w, 0))
        else:
            maxcov = np.zeros(n_groups, dtype=np.int64)
            off_w = np.zeros(n_groups, dtype=np.int64)
        spill = cnt_per_group - maxcov
        cost = w * block_cost + spill * spill_cost
        upd = cost < best_cost
        best_cost[upd] = cost[upd]
        best_off[upd] = off_w[upd]
        best_w[upd] = w
    best_w[~nonempty] = widths[0]
    best_off[~nonempty] = 0
    return best_off, best_w


def _merge_buckets_cost(per_group_width, unit_cost_s,
                        fixed_s=ALIGNED_KERNEL_FIXED_S
                        * ALIGNED_KERNELS_PER_BUCKET,
                        max_buckets=None):
    """Cost-aware width-class merging (``:1508-1549``): greedily merge the
    adjacent width-class pair whose added streaming cost is smallest, while
    it stays below the fixed cost of the bucket it removes; ``max_buckets``
    forces merging down regardless. Widths only grow."""
    values = np.asarray(per_group_width)
    uniq, cnts = np.unique(values, return_counts=True)
    widths = [int(u) for u in uniq]
    counts = [int(c) for c in cnts]
    rep = {int(u): int(u) for u in uniq}
    while len(widths) > 1:
        added = [counts[i] * (widths[i + 1] - widths[i]) * unit_cost_s
                 for i in range(len(widths) - 1)]
        i = int(np.argmin(added))
        forced = max_buckets is not None and len(widths) > max_buckets
        # reaching one bucket also removes the JAX form's assembly gather
        eff_fixed = fixed_s
        if len(widths) == 2:
            eff_fixed += ALIGNED_KERNEL_FIXED_S
        if added[i] >= eff_fixed and not forced:
            break
        for k in rep:
            if rep[k] == widths[i]:
                rep[k] = widths[i + 1]
        counts[i + 1] += counts[i]
        del widths[i], counts[i]
    return np.asarray([rep[int(v)] for v in values.reshape(-1)],
                      dtype=values.dtype).reshape(values.shape)


def _merge_small_buckets(values, min_count):
    """Map each distinct value to a representative ≥ it so no bucket has
    fewer than ``min_count`` members (``:1552-1573``)."""
    uniq, cnts = np.unique(values, return_counts=True)
    mapping = {}
    carry = 0
    pending = []
    for u, c in zip(uniq, cnts):
        pending.append(u)
        carry += c
        if carry >= min_count or u == uniq[-1]:
            for p in pending:
                mapping[p] = u
            pending, carry = [], 0
    if pending:  # trailing small buckets merge into the largest rep
        rep = mapping[uniq[-1]] if uniq[-1] in mapping else uniq[-1]
        for p in pending:
            mapping[p] = rep
    return np.asarray(
        np.vectorize(mapping.__getitem__)(values), dtype=values.dtype
    )


def build_aligned_stage_bucketed(
    indptr: np.ndarray,
    indices: np.ndarray,
    num_inputs: int,
    group_rows: int = 128,
    max_width: int = 8,
    feat_bytes: int = 64,
    spill_limit: int = 1 << 28,
    block_rows: int = ALIGNED_BLOCK,
    spill_fudge: int = 256,
    spill_pad_pow2: bool = False,
) -> AlignedStageB:
    """One direction's bucketed aligned stage (``:1576-1761``).
    ``spill_pad_pow2=True`` pads spill widths to powers of two with a
    coarse merge instead of multiples of 8."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    S = len(indptr) - 1
    G = group_rows
    n_groups = max(-(-S // G), 1)
    nb = max(-(-num_inputs // block_rows), 1)
    counts = np.diff(indptr).astype(np.float32)
    if indices.size == 0:
        empty_bucket = AlignedBucket(
            b_dense=np.zeros((n_groups, G, block_rows), np.int8),
            win_block=np.zeros((n_groups, 1), np.int32),
            group_ids=np.arange(n_groups, dtype=np.int32),
        )
        return AlignedStageB(
            buckets=(empty_bucket,), spills=(),
            base_slot=np.arange(n_groups, dtype=np.int32),
            spill_slot=np.zeros(n_groups, np.int32),
            counts=counts, num_inputs=num_inputs, num_segments=S,
            group_rows=G, block_rows=block_rows,
        )
    seg = np.repeat(np.arange(S, dtype=np.int64), np.diff(indptr))
    grp = seg // G
    row_in_g = seg % G
    blk = indices // block_rows
    cnt_per_group = np.bincount(grp, minlength=n_groups)
    off, wid = _group_windows_opt(
        grp, blk, cnt_per_group, nb, min(max_width, nb), G, feat_bytes,
        block_rows=block_rows, spill_fudge=spill_fudge,
    )
    # merge width classes cost-awarely; the unit cost of widening one group
    # by one block is its extra band elements and window rows
    band_unit_s = (G * block_rows) / ALIGNED_A_ELEM_RATE \
        + (block_rows * feat_bytes) / ALIGNED_STREAM_BPS
    wid = _merge_buckets_cost(wid, band_unit_s)
    # merging only widens windows, but off + w' must stay within the blocks
    off = np.minimum(off, np.maximum(nb - wid, 0))
    og, wg = off[grp], wid[grp]
    in_win = (blk >= og) & (blk < og + wg)

    buckets = []
    base_slot = np.zeros(n_groups, dtype=np.int32)
    slot_base = 0
    for w in np.unique(wid):
        gsel = np.where(wid == w)[0]
        W = int(w) * block_rows
        ng_b = len(gsel)
        local_of_group = np.full(n_groups, -1, dtype=np.int64)
        local_of_group[gsel] = np.arange(ng_b)
        esel = in_win & (local_of_group[grp] >= 0)
        b_dense = np.zeros((ng_b, G, W), np.int8)
        key = (local_of_group[grp[esel]] * G + row_in_g[esel]) * W + (
            indices[esel] - og[esel] * block_rows
        )
        uk, cnts = np.unique(key, return_counts=True)
        if cnts.size and cnts.max() > 127:
            raise MemoryError(
                "aligned stage: >127 duplicate incidences in one "
                "(segment, source) pair — not an incidence matrix?"
            )
        b_dense.reshape(-1)[uk] = cnts.astype(np.int8)
        win_block = (
            off[gsel][:, None] + np.arange(int(w))[None, :]
        ).astype(np.int32)
        buckets.append(AlignedBucket(
            b_dense=b_dense, win_block=win_block,
            group_ids=gsel.astype(np.int32),
        ))
        base_slot[gsel] = slot_base + np.arange(ng_b, dtype=np.int32)
        slot_base += ng_b

    # spill: only spilling groups; a (group, source) pair is one slot, its
    # band column carrying every segment of the group that reads it
    sp = ~in_win
    sgrp, srow, ssrc = grp[sp], row_in_g[sp], indices[sp]
    pair_key = sgrp * np.int64(num_inputs + 1) + ssrc
    uk, inv = np.unique(pair_key, return_inverse=True)
    ugrp = (uk // (num_inputs + 1)).astype(np.int64)
    usrc = (uk % (num_inputs + 1)).astype(np.int64)
    per_g = np.bincount(ugrp, minlength=n_groups)  # unique srcs per group
    spilling = np.where(per_g > 0)[0]
    spills = []
    m_total = 0
    spill_slot = np.zeros(n_groups, dtype=np.int32)
    if len(spilling):
        if spill_pad_pow2:
            sw_of = 1 << np.ceil(
                np.log2(np.maximum(per_g[spilling], 1))
            ).astype(np.int64)
            sw_of = _merge_small_buckets(sw_of, max(8, len(spilling) // 8))
        else:
            # width = count rounded up to a multiple of 8, then a cost-aware
            # merge at one kernel's fixed cost per spill bucket
            sw_of = -(-per_g[spilling] // 8) * 8
            spill_unit = (G / ALIGNED_A_ELEM_RATE
                          + ALIGNED_SPILL_PAD_GATHER_S)
            sw_of = _merge_buckets_cost(
                sw_of, spill_unit, fixed_s=ALIGNED_KERNEL_FIXED_S)
        total_entries = int(G * sw_of.sum())
        if total_entries > spill_limit:
            raise MemoryError(
                f"aligned stage spill tables ({total_entries} int8 entries) "
                f"> {spill_limit} (spill fraction {sp.mean():.2f}) — use the "
                "tree or multihot backend"
            )
        # uk is sorted by (group, src), so slots are contiguous per group
        starts = np.zeros(n_groups + 1, dtype=np.int64)
        np.cumsum(per_g, out=starts[1:])
        slot_of_pair = np.arange(len(uk), dtype=np.int64) - starts[ugrp]
        for sw in np.unique(sw_of):
            gsel = spilling[sw_of == sw]
            m_b = len(gsel)
            local_of_group = np.full(n_groups, -1, dtype=np.int64)
            local_of_group[gsel] = np.arange(m_b)
            psel = local_of_group[ugrp] >= 0  # pairs in this bucket
            spill_src = np.full((m_b, int(sw)), num_inputs, np.int32)
            b_spill = np.zeros((m_b, G, int(sw)), np.int8)
            spill_src[local_of_group[ugrp[psel]], slot_of_pair[psel]] = (
                usrc[psel].astype(np.int32)
            )
            esel = local_of_group[sgrp] >= 0  # entries in this bucket
            np.add.at(
                b_spill,
                (local_of_group[sgrp[esel]], srow[esel],
                 slot_of_pair[inv[esel]]),
                1,
            )
            spills.append(AlignedSpill(
                b_spill=b_spill, spill_src=spill_src,
                group_ids=gsel.astype(np.int32),
            ))
            spill_slot[gsel] = m_total + np.arange(m_b, dtype=np.int32)
            m_total += m_b
    spill_slot[per_g == 0] = m_total  # zero row
    return AlignedStageB(
        buckets=tuple(buckets), spills=tuple(spills),
        base_slot=base_slot, spill_slot=spill_slot,
        counts=counts, num_inputs=num_inputs, num_segments=S,
        group_rows=G, block_rows=block_rows,
    )


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


# The routing ladder's constants, with the JAX package's values
# (``:560-606``). They were measured on a TPU v5e and are carried verbatim so
# that both packages send a graph down the same route; pricing them for the
# card waits for the bench (ROADMAP.md queue 1).
DENSE_AUTO_THRESHOLD = 32_000_000  # N·E at or below which the dense route wins
# unstructured graphs past the small-dense gate stream the int8 table while
# N·E < 2000·nnz and N·E stays under the table cap
DENSE_STREAM_VS_GATHER = 2000
DENSE_STREAM_MAX_ENTRIES = 800_000_000
# the bit packs extend the dense stream 8× past the int8 cap
BITSTREAM_MAX_ENTRIES = 8 * DENSE_STREAM_MAX_ENTRIES
# nnz at or below which cumsum takes an unstructured graph from the tree
CUMSUM_PREFER_NNZ = 1 << 17
# N² at or below which the propagation matrix A is built (bf16)
PRECOMP_MAX_ENTRIES = 80_000_000


@dataclasses.dataclass
class DensePrecomp:
    """The propagation matrix ``A = diag(degV)·H·diag(degE)·Hᵀ`` in bf16
    (``:609-635``): with sum first aggregation and no ``wdiag``, a whole
    HGNN aggregation is one product ``A·x``.

    Built from the CSR (a sparse product on the host, in f32, then rounded
    to bf16), not from a dense f32 copy of H as the JAX package builds it
    (``:631``): near the cap that copy is larger than A. ``a`` lives on the
    device it was built for; :meth:`device` puts a copy on another one,
    once.
    """

    a: torch.Tensor  # bf16 [N, N]
    num_nodes: int
    _device: Dict[torch.device, torch.Tensor] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    @classmethod
    def from_hypergraph(cls, hg, device) -> "DensePrecomp":
        h = hg.to_scipy()  # f32 CSR [N, E] of ones
        left = h.multiply(hg.degV).tocsr()  # degV[v] at (v, e)
        right = h.multiply(hg.degE.T).T.tocsr()  # degE[e] at (e, v)
        a = (left @ right).astype(np.float32).toarray()
        return cls(a=torch.as_tensor(a).to(torch.bfloat16).to(device),
                   num_nodes=hg.num_nodes)

    def device(self, device) -> torch.Tensor:
        """``a`` on ``device``."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device == self.a.device:
            return self.a
        if device not in self._device:
            self._device[device] = self.a.to(device)
        return self._device[device]


@dataclasses.dataclass
class AggregationPlan:
    """Everything the route dispatcher needs, built once per graph
    (``:540-557``).

    ``dense`` serves the ``dense`` and ``pallas`` routes, ``tree`` the
    ``tree`` route, ``precomp``, ``pallas_sparse``, ``aligned`` and
    ``bitstream`` the routes of those names, and ``preferred_backend`` is
    the route ``backend="auto"`` takes. Unlike the JAX package's, it needs
    no ``tree`` for the ``aligned`` route; like it, it needs one for max
    first aggregation on ``dense``, ``pallas``, ``bitstream`` and
    ``cumsum``. The JAX package's ``tile``, ``bsr`` and ``multihot`` forms
    are not ported (ROADMAP.md, "Do not port").
    """

    dense: Optional[DenseIncidence] = None
    tree: Optional[TreePlan] = None
    pallas_sparse: Optional[TreePlan] = None  # pallas-level-0 TreePlan
    aligned: Optional[TreePlan] = None  # plan_aligned's TreePlan, plain or kernel form
    bitstream: Optional["BitIncidence"] = None  # the bit-packed H and Hᵀ
    precomp: Optional[DensePrecomp] = None
    preferred_backend: str = "tree"

    @classmethod
    def dense_plan(cls, hg, device) -> "AggregationPlan":
        return cls(dense=DenseIncidence.from_hypergraph(hg, device))


def plan_aggregation(
    hg,
    device="cuda",
    dense_threshold: int = DENSE_AUTO_THRESHOLD,
    with_tile: bool = False,
    with_bsr: Optional[bool] = None,
    with_precomp: bool = True,
    with_multihot: Optional[bool] = None,
    with_aligned: bool = True,
    ngs: Optional[int] = None,
    fan: int = 8,
) -> AggregationPlan:
    """The routing ladder (``:638-782``), branch for branch in JAX's order:

    * ``precomp`` when N² ≤ ``PRECOMP_MAX_ENTRIES`` and N ≤ 2E;
    * ``dense`` when N·E ≤ ``dense_threshold``;
    * ``aligned`` when the graph is community-sorted (``plan_aligned``,
      then with ``window_blocks=32`` when the aspect ratio is ≥ 4);
    * ``dense`` again for an unstructured graph with N·E under the int8 cap
      and below ``DENSE_STREAM_VS_GATHER``·nnz;
    * ``bitstream`` past that cap, up to ``BITSTREAM_MAX_ENTRIES``;
    * ``cumsum`` when nnz ≤ ``CUMSUM_PREFER_NNZ``;
    * ``tree`` otherwise.

    The tables go to ``device``, the card unless the caller asks for the
    CPU (``device="cpu"``); without a card the default raises (the int8
    table and A here, the stage plans and packs at their first use). The
    plan always holds the plain-form tree, which max first aggregation
    reads. On a CUDA device the aligned
    plan takes the kernel form (``form="pallas_auto"``, the band kernel);
    the route's name stays ``aligned``. The tiled, BSR and multihot forms
    are not ported: asking for one raises ``NotImplementedError``; the JAX
    ladder builds multihot by default but never prefers it.
    """
    for name, flag in (("with_tile", with_tile), ("with_bsr", with_bsr),
                       ("with_multihot", with_multihot)):
        if flag:
            raise NotImplementedError(
                f"{name}=True asks for a plan form the port leaves out (ROADMAP.md, "
                "'Do not port')")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: plan_aggregation plans for the card unless it is "
                           "given device='cpu'")
    n, e, nnz = hg.num_nodes, hg.num_edges, hg.nnz
    tree = plan_tree(hg, ngs=ngs, fan=fan)
    dense = precomp = aligned = bitstream = None
    preferred = "tree"
    if with_precomp and n * n <= PRECOMP_MAX_ENTRIES:
        precomp = DensePrecomp.from_hypergraph(hg, device)
    if n * e <= dense_threshold:
        dense = DenseIncidence.from_hypergraph(hg, device)
        preferred = "dense"
    if precomp is not None and n <= 2 * e:
        # one product with A reads N² bf16 against the dense route's two
        # reads of H (2·N·E): it wins for N ≲ 2E
        preferred = "precomp"
    if with_aligned and dense is None and preferred == "tree":
        try:
            aligned = plan_aligned(hg)
            preferred = "aligned"
        except (ValueError, MemoryError):
            aligned = None  # not community-sorted at the default window
        if aligned is None and max(e, n) / max(1, min(e, n)) >= 4:
            # a community spans many blocks of the larger side: a wider cap
            try:
                aligned = plan_aligned(hg, window_blocks=32)
                preferred = "aligned"
            except (ValueError, MemoryError):
                aligned = None
    stream = dense is None and dense_threshold > 0 and preferred == "tree" and (
        n * e < DENSE_STREAM_VS_GATHER * max(nnz, 1))
    if stream and n * e <= DENSE_STREAM_MAX_ENTRIES:
        dense = DenseIncidence.from_hypergraph(hg, device)
        preferred = "dense"
    elif stream and n * e <= BITSTREAM_MAX_ENTRIES:
        from hypergef_tpu_torch.ops.bitstream import BitIncidence

        try:
            bitstream = BitIncidence.from_hypergraph(hg)
            preferred = "bitstream"
        except ValueError:
            bitstream = None  # not a 0/1 incidence
    if preferred == "tree" and nnz <= CUMSUM_PREFER_NNZ:
        preferred = "cumsum"
    if aligned is not None and device.type == "cuda":
        aligned = dataclasses.replace(aligned, form="pallas_auto")
    return AggregationPlan(dense=dense, tree=tree, aligned=aligned, bitstream=bitstream,
                           precomp=precomp, preferred_backend=preferred)
