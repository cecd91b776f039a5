"""Aggregation plans: the host-built tables the routes consume.

Port of parts of ``hypergef_tpu/sparse/planner.py``, as the same NumPy
code, so every host table is bit-identical to the JAX package's:

* the ELL chunk table and the reduction tree (``:37-236``): ``EllTable``,
  :func:`build_ell`, :func:`choose_ngs`, ``TreeLevel``, ``TreeStage``,
  :func:`build_tree`;
* :class:`TreePlan`, :func:`plan_tree` (plain stages only) and
  :func:`plan_pallas_sparse` (``:239-431``, ``:935-949``), whose
  :meth:`TreePlan.device` puts the stages on a torch device;
* the int8 :class:`DenseIncidence` (``:433-515``);
* an :class:`AggregationPlan` (``:540-557``) with the ``dense``, ``tree``
  and ``pallas_sparse`` plans.

The other plan forms (tiled, aligned, bitstream, precomp) and the routing
ladder ``plan_aggregation`` (``:638-782``) come with their routes
(ROADMAP.md queue 1, item 3).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from hypergef_tpu_torch.ops.ell_gather import GatherTable


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


# "xla": every level plain; "pallas_*": level 0 runs the gather kernel. The
# TPU's vmem/dma variants were a VMEM-capacity split; on the card they are
# one kernel, so the three pallas forms run alike.
TREE_FORMS = ("xla", "pallas_auto", "pallas_vmem", "pallas_dma")


@dataclasses.dataclass
class TreePlan:
    """Two-direction reduction-tree schedule (``:239-388``).

    ``edge_stage`` computes V→E (rows = hyperedges, inputs = vertices),
    ``vertex_stage`` computes E→V. Each stage is the exact adjoint of the
    other (H vs Hᵀ), which the tree op's backward uses.
    """

    edge_stage: TreeStage
    vertex_stage: TreeStage
    num_nodes: int
    num_edges: int
    form: str = "xla"
    _device: Dict[torch.device, Tuple[DeviceStage, DeviceStage]] = dataclasses.field(
        default_factory=dict, repr=False)

    def __post_init__(self):
        if self.form not in TREE_FORMS:
            raise ValueError(f"form must be one of {TREE_FORMS}, got {self.form!r}")

    def device(self, device) -> Tuple[DeviceStage, DeviceStage]:
        """(edge stage, vertex stage) on ``device``, built once per device."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device not in self._device:
            kernel = self.form != "xla"
            self._device[device] = (
                DeviceStage.from_stage(self.edge_stage, device, kernel),
                DeviceStage.from_stage(self.vertex_stage, device, kernel),
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


@dataclasses.dataclass
class AggregationPlan:
    """Everything the route dispatcher needs, built once per graph.

    ``dense`` serves the ``dense`` and ``pallas`` routes, ``tree`` the
    ``tree`` route and ``pallas_sparse`` the route of that name.
    """

    dense: Optional[DenseIncidence] = None
    tree: Optional[TreePlan] = None
    pallas_sparse: Optional[TreePlan] = None  # pallas-level-0 TreePlan

    @classmethod
    def dense_plan(cls, hg, device) -> "AggregationPlan":
        return cls(dense=DenseIncidence.from_hypergraph(hg, device))
